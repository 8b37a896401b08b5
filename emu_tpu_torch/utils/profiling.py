"""Tracing and profiling utilities, as `emu_tpu/utils/profiling.py`:

- `trace(dir)`: a torch.profiler trace (host and, with a card, CUDA
  activity) exported as a Chrome trace into `dir` (view it in Perfetto or
  chrome://tracing), with the recorder's spans of its window beside the
  profiler's own;
- `annotate(name)`: a named region in such a trace (`record_function`);
- `StepTimer`: wall-clock phase totals and items/s for serving and eval
  loops;
- `device_memory_stats()`: the card's allocator counters;
- `RECORDER`: the program's own spans and counters (`Recorder`), kept in
  memory, on by default: requests through the serving helper, the
  continuous engine's steps, the runner's encode, the beam search's steps.
  `GET /v1/stats` of the HTTP server reads it;
- `mark(device)` and `Stats`: the timings of one call (`last_stats`), from
  CUDA events on a card, resolved when the caller has its result.

On a card the recorder times device work with CUDA events recorded on the
compute stream and reads them only when a record is read, never while the
work runs. One anchor per card, an event recorded right after a
synchronise beside its `time.monotonic()` (`Recorder.anchor`, taken when
an engine, a runner or a chat pipeline is built), places every event on
the host's monotonic clock. The card's event clock runs a few parts per
million slow against the host's (2.5-4.1 us/s on an H100), so a mapped
time is early by that much per second since the anchor. On the CPU a
record keeps host times only.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# records kept in memory: a 45 s window of the served chat path holds
# about 2,000 (steps, requests, bursts), a caption window about 1,800
RECORDS = 16384
# the kernel `torch.cuda._sleep` launches: the mark that places the
# recorder's spans on a profiler trace's clock
MARK_KERNEL = "spin_kernel"
MARK_REGION = "profiling.recorder_mark"


def _event(device) -> Optional["torch.cuda.Event"]:
    """A timing event recorded now on `device`'s current stream; None off a
    card."""
    if device is None or torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _card(device) -> Optional[int]:
    if device is None or torch.device(device).type != "cuda":
        return None
    d = torch.device(device)
    return torch.cuda.current_device() if d.index is None else d.index


class Record:
    """One span of the program.

    `name`; `id`, unique in the process; `parent`, the id of the span it
    ran inside (None at the top); `start` and `end` on the host's
    `time.monotonic()` (end None while open); `card` and `events`: the
    card's index and the CUDA event pair recorded on its compute stream at
    the same two points (None off a card); `marks`: named points in the
    span, each a host time or a `Record` whose end it is (its device end
    where it has events: a request's first and last token are the ends of
    the steps that made them); `counts`: named integers."""

    __slots__ = ("name", "id", "parent", "start", "end", "card", "events",
                 "marks", "counts")

    def __init__(self, name: str, rid: int, parent: Optional[int],
                 start: float, card: Optional[int], event):
        self.name, self.id, self.parent = name, rid, parent
        self.start, self.end = start, None
        self.card = card
        self.events = None if event is None else [event, None]
        self.marks: Dict[str, object] = {}
        self.counts: Dict[str, int] = {}


class Recorder:
    """The program's spans (`Record`) and counters, process-wide.

    `records` is a deque of the newest `maxlen`; `counters` counts every
    record by name and the integers passed to `count`, from the start of
    the process. `enabled` False records nothing: `open` and `span` give
    None. Thread-safe: the serving threads, the engine's dispatcher and
    the readers share it."""

    def __init__(self, maxlen: int = RECORDS):
        self.enabled = True
        self.records: collections.deque = collections.deque(maxlen=maxlen)
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._anchors: Dict[int, tuple] = {}    # card -> (event, host time)

    def clear(self) -> None:
        self.records.clear()
        with self._lock:
            self.counters.clear()

    # -- writing -----------------------------------------------------------

    def anchor(self, device) -> None:
        """Place `device`'s events on the host clock: once per card, an
        event recorded on the idle card's current stream right after a
        synchronise and waited for, beside the middle of the host times
        before its record and after its wait (the tightest of three tries:
        the card sees an event only once CUDA submits it). Call it
        where the program is built, never on a hot path; off a card it
        does nothing."""
        card = _card(device)
        if card is None or card in self._anchors:
            return
        torch.cuda.synchronize(card)
        best = None
        for _ in range(3):
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.monotonic()
            ev.record(torch.cuda.current_stream(card))
            ev.synchronize()
            t1 = time.monotonic()
            if best is None or t1 - t0 < best[2]:
                best = (ev, (t0 + t1) / 2, t1 - t0)
        self._anchors[card] = best[:2]

    def open(self, name: str, device=None,
             parent: Optional[int] = None) -> Optional[Record]:
        """Start a record now (with a start event on `device`'s current
        stream when it is a card); None when the recorder is off."""
        if not self.enabled:
            return None
        rec = Record(name, next(self._ids), parent, time.monotonic(),
                     _card(device), _event(device))
        self.records.append(rec)
        self.count(name)
        return rec

    def close(self, rec: Optional[Record], **counts: int) -> None:
        """End `rec` now (its end event on the same stream), with counts."""
        if rec is None:
            return
        if rec.events is not None:
            rec.events[1] = _event(torch.device("cuda", rec.card))
        rec.end = time.monotonic()
        rec.counts.update(counts)

    @contextlib.contextmanager
    def span(self, name: str, device=None) -> Iterator[Optional[Record]]:
        """A record around the block, the child of the span this thread is
        in; yields it (None when off)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        rec = self.open(name, device, stack[-1] if stack else None)
        if rec is None:
            yield None
            return
        stack.append(rec.id)
        try:
            yield rec
        finally:
            stack.pop()
            self.close(rec)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- reading -----------------------------------------------------------

    def _device_time(self, card: int, ev) -> Optional[float]:
        """An event's time on the monotonic clock; None until it has
        completed or without an anchor on its card."""
        anchor = self._anchors.get(card)
        if ev is None or anchor is None or not ev.query():
            return None
        return anchor[1] + anchor[0].elapsed_time(ev) * 1e-3

    def device_span(self, rec: Record) -> Optional[Tuple[float, float]]:
        """`rec`'s device start and end on the monotonic clock, None where
        it has no events or they have not completed."""
        if rec.events is None:
            return None
        t0 = self._device_time(rec.card, rec.events[0])
        t1 = self._device_time(rec.card, rec.events[1])
        return None if t0 is None or t1 is None else (t0, t1)

    def point(self, mark) -> Optional[float]:
        """A mark's time: a host time as it is, a record's device end
        (its host end off a card), None while unresolved."""
        if not isinstance(mark, Record):
            return mark
        if mark.events is None:
            return mark.end
        span = self.device_span(mark)
        return None if span is None else span[1]

    def snapshot(self) -> List[dict]:
        """Every kept record as plain values, events resolved through the
        anchor ("device": [start, end] or None; "marks": time or None)."""
        out = []
        for rec in list(self.records):
            out.append({"name": rec.name, "id": rec.id,
                        "parent": rec.parent, "start": rec.start,
                        "end": rec.end, "device": self.device_span(rec),
                        "marks": {k: self.point(m)
                                  for k, m in rec.marks.items()},
                        "counts": dict(rec.counts)})
        return out

    def summary(self) -> dict:
        """The counters, and over the kept requests the medians (ms) of
        their queue wait, time to first token and gap between tokens."""
        waits, firsts, gaps = request_times(self.snapshot())
        with self._lock:
            counters = dict(self.counters)

        def median(v):
            return statistics.median(v) * 1e3 if v else None
        return {"counters": counters,
                "requests": len(waits),
                "queue_wait_ms": median(waits),
                "first_token_ms": median(firsts),
                "token_gap_ms": median(gaps)}


def request_times(records: List[dict]):
    """(queue waits, times to first token, gaps between tokens), seconds,
    of the snapshot's requests: queued → admitted, admitted → the device
    end of the step that made the first token, and (last − first) over
    tokens − 1 for finished requests of two tokens or more."""
    waits, firsts, gaps = [], [], []
    for r in records:
        if r["name"] != "request":
            continue
        m = r["marks"]
        admitted, first, last = m.get("admitted"), m.get("first"), \
            m.get("last")
        if admitted is None:
            continue
        waits.append(admitted - r["start"])
        if first is not None:
            firsts.append(first - admitted)
        n = r["counts"].get("tokens", 0)
        if first is not None and last is not None and n > 1:
            gaps.append((last - first) / (n - 1))
    return waits, firsts, gaps


RECORDER = Recorder()


# -- the timings of one call ----------------------------------------------


def mark(device=None) -> tuple:
    """A point in time: (host monotonic, a CUDA event recorded now on
    `device`'s current stream, or None off a card)."""
    return time.monotonic(), _event(device)


class _Pending:
    """Seconds between two marks' events, once the later has completed."""

    __slots__ = ("ev0", "ev1")

    def __init__(self, ev0, ev1):
        self.ev0, self.ev1 = ev0, ev1

    def ready(self) -> bool:
        return self.ev1.query()

    def seconds(self) -> float:
        self.ev1.synchronize()      # returns at once once the work is done
        return self.ev0.elapsed_time(self.ev1) * 1e-3

    def __repr__(self) -> str:
        return "<pending device time>"


class Stats(dict):
    """The timings (seconds) and counts of one call, as `last_stats`.

    A timing between two marks with CUDA events is the card's time between
    them, held until the later event has completed: `settle()` resolves,
    without waiting, those whose work is done (the callers call it where
    they already wait for the result), and a read resolves the rest,
    waiting for the card only if the timed work is still running. Off a
    card it is the host's time, at once."""

    def interval(self, key: str, m0: tuple, m1: tuple) -> None:
        """self[key] = the time from mark m0 to mark m1."""
        if m0[1] is None or m1[1] is None:
            self[key] = m1[0] - m0[0]
        else:
            dict.__setitem__(self, key, _Pending(m0[1], m1[1]))

    def settle(self) -> None:
        for key, v in list(dict.items(self)):
            if isinstance(v, _Pending) and v.ready():
                dict.__setitem__(self, key, v.seconds())

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if isinstance(v, _Pending):
            v = v.seconds()
            dict.__setitem__(self, key, v)
        return v

    def get(self, key, default=None):
        return self[key] if key in self else default

    # iteration through __getitem__, so dict(stats) and ** resolve too
    def __iter__(self):
        return iter(list(dict.keys(self)))

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]

    def __repr__(self) -> str:
        return repr(dict(self.items()))


# -- the operator's tools --------------------------------------------------


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; on exit write `trace_<pid>_<ns>.json` into
    log_dir, with the recorder's records that overlap the block as spans of
    their own (a "recorder (host)" row, and a "recorder (device)" row for
    their event pairs), placed on the profiler's clock by a mark: on a card
    the start of the `torch.cuda._sleep` kernel launched on a side stream,
    as the benchmark's harness marks its traces; on the CPU the end of a
    named region. Yields the profiler (its `key_averages()` sums by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t_open = time.monotonic()
        if card:
            with torch.cuda.stream(torch.cuda.Stream()):
                t_mark = time.monotonic()
                torch.cuda._sleep(1000)
        else:
            with torch.profiler.record_function(MARK_REGION):
                t_mark = time.monotonic()       # the region's end
        yield prof
        t_close = time.monotonic()
        if card:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_records(path, t_open, t_close, t_mark,
                 MARK_KERNEL if card else MARK_REGION, not card)


def _add_records(path: str, t_open: float, t_close: float, t_mark: float,
                 mark_name: str, at_end: bool) -> None:
    """Append the recorder's records in [t_open, t_close] to the Chrome
    trace at `path`, on its clock: the mark event's start (its end when
    `at_end`) is t_mark."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    marks = [e for e in events
             if mark_name in str(e.get("name", "")) and e.get("ph") == "X"]
    if not marks:
        return
    m = min(marks, key=lambda e: e["ts"])
    off = float(m["ts"]) + (float(m["dur"]) if at_end else 0.0) \
        - t_mark * 1e6
    pid = os.getpid()
    for r in RECORDER.snapshot():
        args = {"id": r["id"], "parent": r["parent"], **r["counts"]}
        rows = [("recorder (host)", r["start"], r["end"])]
        if r["device"] is not None:
            rows.append(("recorder (device)",) + tuple(r["device"]))
        for tid, t0, t1 in rows:
            if t1 is None or t1 < t_open or t0 > t_close:
                continue
            events.append({"name": r["name"], "ph": "X", "cat": "recorder",
                           "pid": pid, "tid": tid, "ts": t0 * 1e6 + off,
                           "dur": (t1 - t0) * 1e6, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


def annotate(name: str):
    """Named trace region: `with annotate("prefill"): ...`."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulating phase timer with throughput accounting. The clock is
    the host's: time device work only after a synchronise."""

    def __init__(self):
        self.totals = {}
        self.counts = {}
        self.items = {}

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.items[name] = self.items.get(name, 0) + items

    def report(self) -> dict:
        out = {}
        for name, total in self.totals.items():
            entry = {"total_s": round(total, 4),
                     "calls": self.counts[name],
                     "mean_ms": round(1e3 * total / self.counts[name], 3)}
            if self.items.get(name):
                entry["items_per_s"] = round(self.items[name] / total, 2)
            out[name] = entry
        return out


def device_memory_stats(device="cuda") -> Optional[dict]:
    """{"bytes_in_use", "peak_bytes_in_use"} from the caching allocator
    and "bytes_limit", the card's total memory; None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats["allocated_bytes.all.current"],
            "peak_bytes_in_use": stats["allocated_bytes.all.peak"],
            "bytes_limit": total}
