"""Card time of kernel C's backward (`fused_norm.rmsnorm_bwd`) at the train
step's shapes, beside its bound and one PyTorch call computing the same
gradients.

Usage:
  python -m emu_tpu_torch.tools.bench_norm_bwd

For 2048 rows of 5120 (Emu1's LLaMA-13B, 2 x 1024 tokens) with and without
the residual add and with an fp32 weight, and 2048 rows of 6656 (LLaMA-33B),
it prints CUDA-event ms a call (20 launches after 3 warm-up ones), the
card's time alone from torch.profiler by kernel (the row pass and dw's
reduction), the bound (`case`'s bytes over 3.35 TB/s) and the autograd of
`x + r` then `F.rms_norm` on the same inputs. chip_smoke.py phase 3 builds
its runs of the kernel with `case` too.

It imports only entry points that every version of the port has, so
running it from two checkouts (copy it and `bench_decode_kernels.py` into
the other's `tools/`) compares them on one card.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from emu_tpu_torch.ops import fused_norm as C
from emu_tpu_torch.tools.bench_decode_kernels import card_ms, event_ms

SEED = 1234
HBM_BPS = 3.35e12
SHAPES = [(2048, 5120, True, False), (2048, 5120, False, False),
          (2048, 5120, True, True), (2048, 6656, True, False)]


def case(m: int, w: int, add: bool, w_fp32: bool,
         gen: torch.Generator) -> dict:
    """One call of kernel C's backward over m random bf16 rows of width w
    on `gen`'s card, from the forward's saved y and rsigma: its name, its
    arguments (y, w, rsigma, dh, dy_ext), the bytes it must move (y, dh and
    dy_ext read, dx written, w read, dw written, rsigma read), its fp32
    operations, and `library`, the autograd of `x + r` then `F.rms_norm` on
    the same inputs (one PyTorch call computing the same gradients)."""
    dev, bf = gen.device, torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(bf)

    wt = 1 + torch.randn(w, device=dev, generator=gen) * 0.1
    wt = wt if w_fp32 else wt.to(bf)
    x, dh = randn(m, w), randn(m, w)
    r, dy = (randn(m, w), randn(m, w)) if add else (None, None)
    y, _, rsig = C.rmsnorm_fwd(wt, x, r)
    leaves = [t.clone().requires_grad_() for t in
              ((x, wt, r) if add else (x, wt))]
    yl = leaves[0] + leaves[2] if add else leaves[0]
    hl = F.rms_norm(yl, (w,), leaves[1], eps=1e-6)
    outs, cots = ((yl, hl), (dy, dh)) if add else ((hl,), (dh,))
    return {"name": (f"rmsnorm_bwd_{'add' if add else 'rms'}_{m}x{w}"
                     + ("_w_fp32" if w_fp32 else "")),
            "args": (y, wt, rsig, dh, dy),
            "nbytes": (2 * m * w * (4 if add else 3)
                       + 2 * wt.element_size() * w + 4 * m),
            "ops": 10 * m * w,
            "library": lambda: torch.autograd.grad(outs, leaves, cots,
                                                   retain_graph=True)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_norm_bwd: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    plan = getattr(C, "norm_bwd_plan", None)
    rows = []
    for shape in SHAPES:
        run = case(*shape, gen)
        kernel = lambda: C.rmsnorm_bwd(*run["args"])  # noqa: E731
        split = {}
        ms, dev_ms = event_ms(kernel), card_ms(kernel, by_kernel=split)
        lib_ms = event_ms(run["library"])
        bound = run["nbytes"] / HBM_BPS * 1e3
        planned = plan(*shape[:2]) if plan else None
        rows.append({"name": run["name"], "plan": planned, "ms": ms,
                     "card_ms": dev_ms, "bound_ms": bound,
                     "library_ms": lib_ms})
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        parts = ", ".join(
            f"{k.replace('void ', '').replace('(anonymous namespace)::', '')[:40]}"
            f" {v:.4f}" for k, v in sorted(split.items(),
                                          key=lambda kv: -kv[1]))
        print(f"  {run['name']}: {ms:.4f} ms a call, card {shown}, bound "
              f"{bound:.4f} ms, library {lib_ms:.4f} ms  [{card}]\n"
              f"    plan {planned}\n    by kernel: {parts}")
        del run, kernel
        torch.cuda.empty_cache()
    print(json.dumps({"bench_norm_bwd": rows}))


if __name__ == "__main__":
    main()
