"""What every cell's run shares: the card's name and power limit, the
guard against the JAX package, the profiler's reading of a traced window
(device busy time, the longest idle gaps by what the host was doing, the
device time of each counted call), and the result line."""

from __future__ import annotations

import bisect
import json
import subprocess
import sys
from typing import Dict, List, Optional

BANNED = ("jax", "jaxlib", "flax", "emu_tpu")
MARK = "spin_kernel"          # torch.cuda._sleep's kernel: the clock mark


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's
    own, the whole name compared (so `emu_tpu_torch` passes)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def read_trace(prof, t_start: float, t_stop: float, t_mark: float,
               host_spans) -> Optional[dict]:
    """The traced window [t_start, t_stop] (monotonic seconds) of a
    device-only trace: busy seconds (the union of kernel intervals clipped
    to the window), the top kernels by device time, and the idle gaps
    between kernels grouped by the innermost host span open at each gap's
    middle (`host_spans`: monotonic (start, end, name)). `t_mark` is when
    the mark kernel (`MARK`, launched alone on an idle stream) was
    launched: its start maps the trace's clock onto the monotonic one, and
    its end is where a CUDA event recorded after it on that stream falls
    in the trace (`mark_end_us`; `busy_us` is the union of the kernel
    intervals, which `spans.OpCounter` reads). None when the trace holds
    no kernel."""
    from torch.autograd import DeviceType
    kernels, mark_us, mark_end_us = [], None, None
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        if MARK in ev.name:
            if mark_us is None or tr.start < mark_us:
                mark_us, mark_end_us = tr.start, tr.end
        else:
            kernels.append((tr.start, tr.end, ev.name))
    if not kernels or mark_us is None:
        return None
    busy_us = BusyTime([(s, e) for s, e, _ in kernels])
    # trace microseconds -> monotonic seconds
    off = t_mark - mark_us * 1e-6
    by_name: Dict[str, float] = {}
    iv = []
    for s, e, name in kernels:
        s, e = max(s * 1e-6 + off, t_start), min(e * 1e-6 + off, t_stop)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
            iv.append((s, e))
    iv.sort()
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    edge = t_start
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            gaps.append((edge if cur_e is None else cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, t_stop))
    spans = sorted(host_spans)
    labelled: Dict[str, float] = {}
    active, nxt = [], 0
    for g0, g1 in gaps:                    # gaps come in time order
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        while nxt < len(spans) and spans[nxt][0] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] >= mid]
        best = min(active, key=lambda sp: sp[1] - sp[0], default=None)
        label = best[2] if best else "no host span"
        labelled[label] = labelled.get(label, 0.0) + (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": t_stop - t_start,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in idle],
            "kernels": len(iv), "host_spans": len(spans),
            "busy_us": busy_us, "mark_end_us": mark_end_us}


class BusyTime:
    """The union of a trace's device intervals (microseconds), and the
    busy time inside any span of it."""

    def __init__(self, intervals):
        merged = []
        for s, e in sorted(intervals):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [m[0] for m in merged]
        self.ends = [m[1] for m in merged]
        self.before = [0.0]
        for s, e in merged:
            self.before.append(self.before[-1] + (e - s))

    def _upto(self, t: float) -> float:
        """Busy microseconds before t."""
        k = bisect.bisect_right(self.starts, t)
        if k == 0:
            return 0.0
        return self.before[k - 1] + min(t, self.ends[k - 1]) \
            - self.starts[k - 1]

    def within(self, t0: float, t1: float) -> float:
        return max(0.0, self._upto(t1) - self._upto(t0))


def emit_result(result: dict, checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result line (with the same numbers under "checks",
    last) as the last line of standard output."""
    for name, c in checks.items():
        sys.stderr.write(f"check {name}: {c['value']!r} (limit "
                         f"{c['limit']!r})\n")
    sys.stderr.flush()
    sys.stdout.write(json.dumps(dict(result, checks=checks)) + "\n")
    sys.stdout.flush()
