"""Card time of the attention backward (dQ, dK/dV) and of kernel H at the
shapes `chip_smoke.py` phase 3 times them, without the twins.

Usage:
  python -m emu_tpu_torch.tools.bench_bwd_dense

For each shape it prints CUDA-event ms a call (20 launches after 3 warm-up
ones) and the card's time alone from torch.profiler:

- the backward on the train path's attention (LLaMA-13B: 2 x 1024 tokens,
  40 heads of 128, causal, the second row left-padded by 37 keys), with 40
  kv heads and with 20 (GQA rep 2), and at 1 x 8 x 4096 causal keys;
- kernel H in its plain form at the SDXL UNet's GEGLU and attention shapes,
  the time embedding, ViT-g's proj and patch embedding, and the short grids
  of the SD1.5 UNet's 8² level and the Causal Former's projection; its pre
  form at the
  UNet block's norm3 + proj_in and ViT-g's LN1 + qkv; its post form with
  the residual at EVA-4B's proj.

It imports only entry points that every version of the port has, so
running it from two checkouts (copy it into the other's `tools/`) compares
them on one card.
"""

from __future__ import annotations

import json
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from emu_tpu_torch.ops import flash_attention as A
from emu_tpu_torch.ops import fused_mlp as B

DENSE = [(None, (2048, 1280, 10240)), (None, (2048, 5120, 1280)),
         (None, (8192, 640, 640)), (None, (2, 320, 1280)),
         (None, (2056, 1408, 1408)), (None, (2048, 588, 1408)),
         (None, (128, 1280, 1280)), (None, (128, 5120, 1280)),
         (None, (32, 768, 5120)),
         ("pre", (8192, 640, 5120)), ("pre", (8224, 1408, 4224)),
         ("post", (8200, 1792, 1792))]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_ms(fn, iters: int = 10):
    """Kernel time of one call from torch.profiler; None if the trace
    recorded no kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters if total > 0 else None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_bwd_dense: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=g) * std).to(bf)

    rows = []

    def measure(name, fn):
        ms, dev_ms = event_ms(fn), card_ms(fn)
        rows.append({"name": name, "ms": ms, "card_ms": dev_ms})
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        print(f"  {name}: {ms:.4f} ms a call, card {shown}  [{card}]")

    b, h, s, d = 2, 40, 1024, 128
    kw = dict(scale=d ** -0.5, causal=True)
    valid = torch.arange(s, device=dev)[None] >= torch.tensor(
        [0, 37], device=dev)[:, None]
    q, k, v, do = (randn(b, s, h, d).transpose(1, 2) for _ in range(4))
    for tag, kk, vv in (("", k, v), ("_gqa2", k[:, ::2], v[:, ::2])):
        o, lse = A._attention_fwd(q, kk, vv, None, None, valid, kw["scale"],
                                  True, True)
        _, d_row = A.attention_bwd_dq(q, kk, vv, o, lse, do, valid, **kw)
        measure(f"attention_bwd_dq{tag}_{b}x{h}x{s}x{d}",
                lambda: A.attention_bwd_dq(q, kk, vv, o, lse, do, valid,
                                           **kw))
        measure(f"attention_bwd_dkv{tag}_{b}x{h}x{s}x{d}",
                lambda: A.attention_bwd_dkv(q, kk, vv, lse, do, d_row, valid,
                                            **kw))
    q, k, v, do = (randn(1, 8, 4096, d) for _ in range(4))
    o, lse = A._attention_fwd(q, k, v, None, None, None, kw["scale"], True,
                              True)
    _, d_row = A.attention_bwd_dq(q, k, v, o, lse, do, **kw)
    measure(f"attention_bwd_dq_1x8x4096x{d}",
            lambda: A.attention_bwd_dq(q, k, v, o, lse, do, **kw))
    measure(f"attention_bwd_dkv_1x8x4096x{d}",
            lambda: A.attention_bwd_dkv(q, k, v, lse, do, d_row, **kw))
    del q, k, v, do, o, lse, d_row
    torch.cuda.empty_cache()

    for form, (m, kd, n) in DENSE:
        x, w, bias = randn(m, kd), randn(kd, n, std=kd ** -0.5), randn(n)
        dim = kd if form == "pre" else n
        lns, lnb = ((1 + randn(dim, std=0.1), randn(dim, std=0.1))
                    if form else (None, None))
        res = randn(m, n) if form == "post" else None
        measure(f"fused_dense_{form or 'plain'}_{m}x{kd}x{n}",
                lambda: B.fused_dense(x, w, bias, lns, lnb, res,
                                      ln_mode=form, eps=1e-5))
    print(json.dumps({"bench_bwd_dense": rows}))


if __name__ == "__main__":
    main()
