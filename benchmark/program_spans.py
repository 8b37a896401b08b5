"""The arithmetic of the readers of the program's own records: the spans
and counters that `emu_tpu_torch.utils.profiling.RECORDER` keeps inside the
port (requests through the serving helper, the continuous engine's steps,
the runner's preprocessing, the beam search's cache reorders).

Each reader takes the run's record and reads the recorder's records whose
times fall in the run's window (`r["window"]`, on `time.monotonic()`, the
recorder's clock; the device ends of CUDA event pairs are placed on it by
the program's anchor). It returns None where the program keeps no such
records (a version without the recorder) or the window holds none.
"""

from __future__ import annotations

import statistics
from typing import List, Optional

STEPS = ("engine.decode", "engine.mixed", "engine.prefill")


def records() -> Optional[List[dict]]:
    """The recorder's records as plain values (`Recorder.snapshot`), or
    None where the program has no recorder."""
    from emu_tpu_torch.utils import profiling
    recorder = getattr(profiling, "RECORDER", None)
    snapshot = getattr(recorder, "snapshot", None)
    return None if snapshot is None else snapshot()


def _in(t, window) -> bool:
    return t is not None and window[0] <= t < window[1]


def _median_ms(values) -> Optional[float]:
    return statistics.median(values) * 1e3 if values else None


def _requests(r) -> List[dict]:
    recs = records()
    return [x for x in recs or () if x["name"] == "request"
            and x["marks"].get("admitted") is not None]


def queue_wait_ms(r) -> Optional[float]:
    """Median, over the requests admitted in the window, of queued (the
    request reached the serving helper's queue) → admitted (the
    dispatcher took it), in ms."""
    w = [x["marks"]["admitted"] - x["start"] for x in _requests(r)
         if _in(x["marks"]["admitted"], r["window"])]
    return _median_ms(w)


def first_token_ms(r) -> Optional[float]:
    """Median, over the requests admitted in the window, of admitted → the
    device end of the engine step that made the first token, in ms."""
    w = []
    for x in _requests(r):
        m = x["marks"]
        if _in(m["admitted"], r["window"]) and m.get("first") is not None:
            w.append(m["first"] - m["admitted"])
    return _median_ms(w)


def token_gap_ms(r) -> Optional[float]:
    """Median, over the requests finished in the window (their last token's
    device end in it) with two tokens or more, of (last token − first
    token) / (tokens − 1), device ends, in ms."""
    w = []
    for x in _requests(r):
        m, n = x["marks"], x["counts"].get("tokens", 0)
        if n > 1 and m.get("first") is not None \
                and _in(m.get("last"), r["window"]):
            w.append((m["last"] - m["first"]) / (n - 1))
    return _median_ms(w)


def _steps(r) -> List[dict]:
    return [x for x in records() or () if x["name"] in STEPS]


def useful_rows(r) -> Optional[float]:
    """Rows that carried a token (active decode rows, and the chunk's or the
    prompts' real tokens) over rows computed (max_slots a decode step,
    max_slots x chunk_size a mixed step, the bucket x the rows of a
    prefill), summed over the engine steps that started in the window and
    whose results were read, in %."""
    rows = useful = 0
    for x in _steps(r):
        c = x["counts"]
        if _in(x["start"], r["window"]) and "rows" in c and "useful" in c:
            rows += c["rows"]
            useful += c["useful"]
    return 100.0 * useful / rows if rows else None


def idle_between_steps(r) -> Optional[float]:
    """Share of the window in which the compute stream waited between one
    engine step's end event and the next step's start event (decode, mixed
    and prefill steps in device order; each wait clipped to the window),
    in %."""
    t0, t1 = r["window"]
    spans = sorted(x["device"] for x in _steps(r)
                   if x["device"] is not None
                   and x["device"][1] > t0 and x["device"][0] < t1)
    if len(spans) < 2:
        return None
    idle, end = 0.0, spans[0][1]
    for s, e in spans[1:]:
        a, b = max(end, t0), min(s, t1)
        if b > a:
            idle += b - a
        end = max(end, e)
    return 100.0 * idle / (t1 - t0)


def preprocess_ms(r) -> Optional[float]:
    """Median, over the batches whose preprocessing started in the window,
    of the host's image preprocessing and upload (the runner's
    "pipeline.preprocess" span), in ms."""
    w = [x["end"] - x["start"] for x in records() or ()
         if x["name"] == "pipeline.preprocess" and x["end"] is not None
         and _in(x["start"], r["window"])]
    return _median_ms(w)


def reorder_ms_per_step(r) -> Optional[float]:
    """Median, over the batches whose beam search started in the window
    (the "generation.generate" spans), of the card's time in the beam
    search's cache reorders (their event pairs) over the reorders, in
    ms."""
    recs = records() or ()
    batches = {x["id"]: [] for x in recs
               if x["name"] == "generation.generate"
               and _in(x["start"], r["window"])}
    for x in recs:
        if x["name"] == "generation.reorder" and x["parent"] in batches \
                and x["device"] is not None:
            batches[x["parent"]].append(x["device"][1] - x["device"][0])
    per = [sum(v) / len(v) for v in batches.values() if v]
    return _median_ms(per)
