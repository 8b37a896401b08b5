"""Spans and counters that the benchmark's own files put around the
program's calls (the program carries none of its own yet).

- `Capture`: what the served path produced, request by request: the prompt
  ids the pipeline embedded, the request id the engine gave the prompt, and
  the tokens it finished with. Installed in every run: `correct` reads it.
- `Steps`: the engine's step entries (decode, mixed, prefill) with the
  slots in use at each, and host spans (monotonic start, end, name) around
  the engine's, the pipeline's and the server's entry points, which label
  the device's idle gaps. Traced runs only.
- `OpCounter`: every call into the port's kernel entry points while the
  profiler runs, with the operations and bytes its shapes need (`costs`)
  and its device time: the time in which the trace has a kernel running
  between two CUDA events recorded before and after the call. Traced runs
  only.
"""

from __future__ import annotations

import functools
import importlib
import threading
import time
from typing import Dict, List

import torch

from benchmark import costs


class HostLog:
    """Host spans (monotonic start, end, name) recorded while `on`."""

    def __init__(self):
        self.on = False
        self.spans: List[tuple] = []


def span(name: str, fn, log: HostLog):
    @functools.wraps(fn)
    def run(*a, **kw):
        if not log.on:
            return fn(*a, **kw)
        t = time.monotonic()
        try:
            return fn(*a, **kw)
        finally:
            log.spans.append((t, time.monotonic(), name))
    return run


class Capture:
    """Prompt ids, request ids and finished tokens of a continuous engine
    behind a chat pipeline."""

    def __init__(self, pipeline, engine):
        self.lock = threading.Lock()
        self.by_embeds: Dict[int, tuple] = {}
        self.prompt: Dict[int, tuple] = {}       # rid -> prompt ids
        self.tokens: Dict[int, List[int]] = {}   # rid -> finished tokens
        embed, submit, finished = (pipeline.embed_inputs,
                                   engine.submit_many, engine.finished)

        def embed_inputs(*a, **kw):
            out = embed(*a, **kw)
            with self.lock:
                self.by_embeds[id(out[0])] = tuple(int(t) for t in
                                                   out[2][0])
            return out

        def submit_many(rows, *a, **kw):
            rids = submit(rows, *a, **kw)
            with self.lock:
                for row, rid in zip(rows, rids):
                    self.prompt[rid] = self.by_embeds.pop(id(row[0]), None)
            return rids

        def finished_():
            out = finished()
            with self.lock:
                self.tokens.update(out)
            return out

        pipeline.embed_inputs = embed_inputs
        engine.submit_many = submit_many
        engine.finished = finished_

    def generated(self, engine) -> int:
        """Tokens the engine has recorded so far: those of the finished
        requests and those of the requests in its slots."""
        live = list(engine.requests.values())
        with self.lock:
            done = sum(len(t) for t in self.tokens.values())
        return done + sum(len(r.tokens) for r in live)

    def by_prompt(self) -> Dict[tuple, List[int]]:
        """prompt ids -> request ids, for the finished requests."""
        out: Dict[tuple, List[int]] = {}
        with self.lock:
            for rid, p in self.prompt.items():
                if rid in self.tokens and p is not None:
                    out.setdefault(p, []).append(rid)
        return out


class Steps:
    """(monotonic time, kind, slots in use) of every engine step entry."""

    def __init__(self, engine, host: HostLog):
        self.log: List[tuple] = []
        for kind, attr in (("decode", "_step_body"), ("mixed", "_mixed"),
                           ("prefill", "_prefill")):
            setattr(engine, attr, self._wrap(engine, kind,
                                             getattr(engine, attr), host))
        for attr in ("step_block", "record_blocks", "drain_admissions",
                     "submit_many", "finished"):
            setattr(engine, attr, span(f"engine.{attr}",
                                       getattr(engine, attr), host))

    def _wrap(self, engine, kind, fn, host):
        traced = span(f"engine.{kind}", fn, host)

        @functools.wraps(fn)
        def run(*a, **kw):
            self.log.append((time.monotonic(), kind,
                             engine.max_slots - engine.free_slots()))
            return traced(*a, **kw)
        return run

    def in_window(self, t0: float, t1: float, kinds=("decode", "mixed")):
        return [e for e in self.log if t0 <= e[0] < t1 and e[1] in kinds]


def _rows(x) -> int:
    return x.numel() // x.shape[-1]


def _lens_pairs(kv_valid, causal: bool, sq: int):
    """Device tensor of the (query, key) pairs these inputs need."""
    n = kv_valid.sum(-1).double()
    if causal:
        return (n * (n + 1) / 2).sum()
    return (n * sq).sum()


def _cost_F(x, packed, scale4, bias=None, *a, **kw):
    return costs.q4_cost(_rows(x), x.shape[-1], packed.shape[-1],
                         scale4.shape[-2], bias is not None) + ("int8",)


def _cost_G(x, rms_scale, gu_packed, gu_scale, dn_packed, dn_scale, *a,
            **kw):
    return costs.swiglu_q4_cost(_rows(x), x.shape[-1],
                                gu_packed.shape[-1] // 2,
                                gu_scale.shape[-2],
                                dn_scale.shape[-2]) + ("int8",)


def _cost_D(q, k, v, kv_valid, k_scale=None, v_scale=None, *, scale=None,
            layer=None, k_new=None, v_new=None):
    b, qn, h, d = q.shape
    n_valid = kv_valid.sum()
    nb, ops = costs.decode_cost(b, h, k.shape[-3], d, 0, k.shape[-2], qn,
                                k.element_size(), k_new is not None,
                                k_scale is not None)
    per_valid = costs.decode_cost(b, h, k.shape[-3], d, 1, k.shape[-2], qn,
                                  k.element_size(), k_new is not None,
                                  k_scale is not None)
    # bytes and operations are affine in the valid count
    return (nb, per_valid[0] - nb, n_valid), (ops, per_valid[1] - ops,
                                              n_valid), "bf16"


def _cost_A(q, k, v, q_bias=None, v_bias=None, *, kv_valid=None,
            scale=None, causal=False):
    b, h, sq, d = q.shape
    skv = k.shape[2]
    nb, _ = costs.attn_cost(b, h, sq, skv, d)
    if kv_valid is None:
        pairs = b * (sq * (sq + 1) // 2 if causal else sq * skv)
        return nb, 4 * h * d * pairs, "bf16"
    return nb, (0, 4 * h * d, _lens_pairs(kv_valid, causal, sq)), \
        "bf16"


def _cost_C(w, x, r=None, *a, **kw):
    add = r is not None and torch.is_tensor(r)
    return costs.norm_cost(_rows(x), x.shape[-1], add,
                           w.element_size()) + ("bf16",)


def _cost_w8a8(x, kernel_w8a8, scale, bias=None):
    return costs.w8a8_cost(_rows(x), x.shape[-1], kernel_w8a8.shape[-1],
                           bias is not None) + ("int8",)


def _cost_E(x, w1_q8, scale1, b1, w2_q8, scale2, b2, *a, **kw):
    k, f, n = x.shape[-1], w1_q8.shape[-1], w2_q8.shape[-1]
    nb, ops = costs.mlp_cost(_rows(x), k, f, n, wbytes=1.0)
    return nb + 4 * (f + n), ops, "int8"


def _cost_B(x, w1, b1, w2, b2, w3=None, b3=None, *a, **kw):
    m, k, f = _rows(x), x.shape[-1], w1.shape[-1]
    if w3 is None:
        return costs.mlp_cost(m, k, f, w2.shape[-1]) + ("bf16",)
    n = w3.shape[-1]
    return (2 * m * k + 2 * (2 * k * f + f * n) + 2 * m * n,
            4 * m * k * f + 2 * m * f * n, "bf16")


def _cost_H(x, w, b=None, *a, **kw):
    return costs.dense_cost(_rows(x), x.shape[-1], w.shape[-1],
                            b is not None) + ("bf16",)


# (module, attribute, label, cost): the port's kernel entry points, patched
# where the calling modules look them up
ENTRY_POINTS = (
    ("emu_tpu_torch.ops.layers", "matmul_q4", "F_matmul_q4", _cost_F),
    ("emu_tpu_torch.models.llama", "fused_swiglu_q4", "G_fused_swiglu_q4",
     _cost_G),
    ("emu_tpu_torch.ops.attention", "decode_attention", "D_decode_attention",
     _cost_D),
    ("emu_tpu_torch.ops.flash_attention", "attention", "A_attention",
     _cost_A),
    ("emu_tpu_torch.models.llama", "add_rmsnorm", "C_add_rmsnorm", _cost_C),
    ("emu_tpu_torch.models.llama", "rms_norm_fused", "C_rms_norm", _cost_C),
    ("emu_tpu_torch.ops.quant", "matmul_w8a8", "matmul_w8a8", _cost_w8a8),
    ("emu_tpu_torch.ops.layers", "fused_mlp_w8a8", "E_fused_mlp_w8a8",
     _cost_E),
    ("emu_tpu_torch.ops.layers", "fused_mlp", "B_fused_mlp", _cost_B),
    ("emu_tpu_torch.ops.layers", "fused_dense", "H_fused_dense", _cost_H),
)


class OpCounter:
    """Counts the calls made while `on` (the profiled sub-window)."""

    def __init__(self):
        self.on = False
        self.mark = None      # a CUDA event recorded after the mark kernel
        self.calls: Dict[str, tuple] = {}     # "<label>#<k>" -> cost
        self._k = 0
        self._lock = threading.Lock()
        for mod, attr, label, cost in ENTRY_POINTS:
            m = importlib.import_module(mod)
            setattr(m, attr, self._wrap(label, cost, getattr(m, attr)))

    def _wrap(self, label, cost, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            with self._lock:
                self._k += 1
                key = f"{label}#{self._k}"
            c = cost(*a, **kw)
            ev = None
            if torch.cuda.is_available() and a and torch.is_tensor(a[0]) \
                    and a[0].is_cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = fn(*a, **kw)
            if ev is not None:
                ev[1].record()
            self.calls[key] = c + (ev,)
            return out
        return run

    def start(self, side) -> None:
        """Mark the trace (an event on the idle stream `side`, right after
        the mark kernel: its end in the trace), then count calls."""
        self.mark = torch.cuda.Event(enable_timing=True)
        self.mark.record(side)
        self.on = True

    def totals(self, reading):
        """(sum of bounds, sum of device seconds) over the counted calls,
        and [bound s, device s, calls, span s] by label. A call's device
        time is the time in which the trace (`reading`, from
        `harness.read_trace`) has a kernel running between the CUDA events
        recorded on its stream before and after it; its span, the time
        between those events, also holds the device's idle time inside the
        call."""
        torch.cuda.synchronize()
        busy, end_us = reading["busy_us"], reading["mark_end_us"]
        by_label: Dict[str, list] = {}
        for key, (nb, ops, kind, ev) in self.calls.items():
            if ev is None:
                continue
            t0 = end_us + self.mark.elapsed_time(ev[0]) * 1e3
            t1 = end_us + self.mark.elapsed_time(ev[1]) * 1e3
            t, _ = costs.bound(_value(nb), _value(ops), kind)
            acc = by_label.setdefault(key.split("#")[0],
                                      [0.0, 0.0, 0, 0.0])
            acc[0] += t
            acc[1] += busy.within(t0, t1) * 1e-6
            acc[2] += 1
            acc[3] += (t1 - t0) * 1e-6
        bound_s = sum(v[0] for v in by_label.values())
        dev_s = sum(v[1] for v in by_label.values())
        return bound_s, dev_s, by_label


def op_note(by_label) -> str:
    """The counted calls by label: calls, bound, device and span ms."""
    return "calls (n: bound / device / span ms): " + "; ".join(
        f"{k} {v[2]}: {v[0] * 1e3:.2f} / {v[1] * 1e3:.2f} / {v[3] * 1e3:.2f}"
        for k, v in sorted(by_label.items(), key=lambda kv: -kv[1][1]))


def _value(x) -> float:
    """A count, or (base, slope, device tensor) = base + slope * tensor."""
    if isinstance(x, tuple):
        base, slope, t = x
        return base + slope * float(t)
    return float(x)
