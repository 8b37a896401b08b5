"""Per-part microbench of one ViT layer on the card, as
`tools/bench_vit_parts.py` of the JAX package: each piece of the block
path timed alone, in µs per layer, beside its bound and beside the time
the same operations would take at a sustained-matmul probe's rate.

Usage:
  python -m emu_tpu_torch.tools.bench_vit_parts [--model 4b] [--int8]

Shapes are the JAX tool's: ViT-g (Emu1; B 32, S 257, width 1408, hidden
6144, 16 heads of 88, 40 layers, pre-LN) or, with --model 4b, EVA-4B (Emu2;
B 8, S 1025, width 1792, hidden 15360, 16 heads of 112, 64 layers,
post-LN). The parts:

- fused LN + QKV: kernel H's pre form (`fused_dense`, ln_mode "pre");
- the QKV product alone (`torch.matmul`, bf16);
- attention from the packed qkv: `mha_packed_qkv` (the batched_mha kernel
  on the three planes of the projection);
- split + `batched_mha` on [B, S, H, D] views of the same projection;
- the proj product alone (`torch.matmul`) and kernel H's post form with
  the residual (the EVA-4B block's proj + LN + residual);
- kernel A (`mha_bhsd`) on head-major views with the q/v biases;
- the fused LN + MLP + residual (kernel B, the model's norm placement).

Times are CUDA events over ITERS launches after a warm-up. Bound: the
larger of bytes (each input read once, each output written once) over
3.35 TB/s and operations over 989 TFLOP/s (bf16, H100 SXM data sheet).
The probe is `torch.matmul` of two 8192² bf16 matrices. The JAX tool's
TPU tiling overrides (--bm, --bf, --bn, --d) tune VMEM blocks and have no
counterpart here.

--int8 adds the W8A8 parts, as the JAX tool's --int8 does (the W8A8
tower of Emu2's EVA-4B runs them): kernel E (`fused_mlp_w8a8`, the
model's norm placement, the hidden block `layers.w8a8_mlp_plan` gives),
the W8A8 qkv product with its dynamic per-token quantization
(`quant.matmul_w8a8`, the unfused route's product) and
`quantize_activations` alone, each beside the int8 bound (1979 TOP/s) and
the time its operations would take at an int8 probe's rate
(`torch._int_mm` of two 8192² int8 matrices), then kernel E's time
against kernel B's (bf16) at the same shape. `--device cpu` runs every
part once at a tiny size with the plain twins, for the tests, and reports
no time.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from emu_tpu_torch.ops import flash_attention as A
from emu_tpu_torch.ops import fused_mlp as B
from emu_tpu_torch.ops import quant as Q

HBM_BPS, PEAK_BF16, PEAK_INT8 = 3.35e12, 989e12, 1979e12
ITERS = 20   # timed launches of each part

SHAPES = {  # B, S, W, HID, H, D, layers, post-LN
    "g": dict(b=32, s=257, w=1408, hid=6144, h=16, d=88, layers=40,
              post=False),
    "4b": dict(b=8, s=1025, w=1792, hid=15360, h=16, d=112, layers=64,
               post=True),
    "tiny": dict(b=2, s=17, w=64, hid=96, h=2, d=32, layers=2, post=False),
}

# the parts that make one pre-LN layer, summed into a layer time
LAYER_PARTS = ("fused LN + QKV (H pre)", "mha_packed_qkv",
               "proj product (torch.matmul)", "fused LN + MLP + residual (B)")

# (name, fn, operations, bytes)
Part = Tuple[str, Callable[[], torch.Tensor], float, float]

# the W8A8 parts' names: kernel E, and kernel B's part it is set against
W8A8_MLP = "fused LN + MLP + residual W8A8 (E)"
BF16_MLP = "fused LN + MLP + residual (B)"
# the hidden block of kernel E at the ViTs' widths (`layers.w8a8_mlp_plan`)
W8A8_BF = 768


def parts(shape: dict, device, seed: int = 0) -> List[Part]:
    """The layer's parts at `shape`, on random bf16 inputs drawn from
    `seed` on `device`."""
    b, s, w, hid, h, d = (shape[k] for k in ("b", "s", "w", "hid", "h", "d"))
    m, hd = b * s, h * d
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*dims, std=1.0):
        return (torch.randn(dims, device=device, generator=gen) * std
                ).to(torch.bfloat16)

    x = rnd(b, s, w)
    wqkv, bqkv = rnd(w, 3 * hd, std=w ** -0.5), rnd(3 * hd, std=0.1)
    lns, lnb = 1 + rnd(w, std=0.1), rnd(w, std=0.1)
    qkv = rnd(b, s, 3 * hd)
    o = rnd(b, s, hd)
    wproj, bproj = rnd(hd, w, std=hd ** -0.5), rnd(w, std=0.1)
    w1, b1 = rnd(w, hid, std=w ** -0.5), rnd(hid, std=0.1)
    w2, b2 = rnd(hid, w, std=hid ** -0.5), rnd(w, std=0.1)
    qb, vb = rnd(h, d, std=0.5), rnd(h, d, std=0.5)
    scale = d ** -0.5
    q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
    mlp_mode = "post" if shape["post"] else "pre"

    def split_mha():
        return A.batched_mha(q, k, v, scale=scale).reshape(b, s, hd)

    def bhsd():
        return A.mha_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), qb, vb, scale=scale)

    mm = lambda k_, n_: 2.0 * m * k_ * n_                     # noqa: E731
    io = lambda *elems: 2.0 * sum(elems)                      # bf16 bytes
    attn_ops, attn_io = 4.0 * b * h * s * s * d, io(3 * m * hd, m * hd)
    return [
        ("fused LN + QKV (H pre)",
         lambda: B.fused_dense(x, wqkv, bqkv, lns, lnb, ln_mode="pre"),
         mm(w, 3 * hd), io(m * w, w * 3 * hd, 3 * hd, 2 * w, m * 3 * hd)),
        ("QKV product (torch.matmul)", lambda: torch.matmul(x, wqkv),
         mm(w, 3 * hd), io(m * w, w * 3 * hd, m * 3 * hd)),
        ("mha_packed_qkv",
         lambda: A.mha_packed_qkv(qkv, h, d, scale=scale), attn_ops, attn_io),
        ("split + batched_mha", split_mha, attn_ops, attn_io),
        ("proj product (torch.matmul)", lambda: torch.matmul(o, wproj),
         mm(hd, w), io(m * hd, hd * w, m * w)),
        ("fused proj + LN + residual (H post)",
         lambda: B.fused_dense(o, wproj, bproj, lns, lnb, residual=x,
                               ln_mode="post"),
         mm(hd, w), io(m * hd, hd * w, 3 * w, 2 * m * w)),
        ("kernel A (mha_bhsd)", bhsd, attn_ops,
         attn_io + io(2 * hd)),
        (BF16_MLP,
         lambda: B.fused_mlp(x, w1, b1, w2, b2, ln_scale=lns, ln_bias=lnb,
                             ln_mode=mlp_mode, residual=True),
         mm(w, hid) + mm(hid, w),
         io(2 * m * w, 2 * w * hid, hid + 3 * w)),
    ]


def int8_parts(shape: dict, device, seed: int = 0) -> List[Part]:
    """The W8A8 parts at `shape`: int8 weights quantized from random bf16
    ones drawn from `seed` on `device`, bf16 activations."""
    b, s, w, hid, h, d = (shape[k] for k in ("b", "s", "w", "hid", "h", "d"))
    m, hd = b * s, h * d
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def rnd(*dims, std=1.0):
        return (torch.randn(dims, device=device, generator=gen) * std
                ).to(torch.bfloat16)

    x = rnd(b, s, w)
    lns, lnb = 1 + rnd(w, std=0.1), rnd(w, std=0.1)
    q1 = Q.quantize_kernel(rnd(w, hid, std=w ** -0.5))
    q2 = Q.quantize_kernel(rnd(hid, w, std=hid ** -0.5))
    b1, b2 = rnd(hid, std=0.1), rnd(w, std=0.1)
    qkv = Q.quantize_kernel(rnd(w, 3 * hd, std=w ** -0.5))
    mlp_mode = "post" if shape["post"] else "pre"
    mm = lambda k_, n_: 2.0 * m * k_ * n_                     # noqa: E731
    return [
        (W8A8_MLP,
         lambda: B.fused_mlp_w8a8(x, q1["kernel_q8"], q1["scale"], b1,
                                  q2["kernel_q8"], q2["scale"], b2, lns, lnb,
                                  ln_mode=mlp_mode, residual=True,
                                  bf=W8A8_BF),
         mm(w, hid) + mm(hid, w),
         4.0 * m * w + 2.0 * w * hid + 4.0 * (hid + w) + 2.0 * (hid + 3 * w)),
        ("W8A8 qkv (matmul_w8a8, dynamic quant)",
         lambda: Q.matmul_w8a8(x, qkv["kernel_q8"], qkv["scale"]),
         mm(w, 3 * hd), 2.0 * m * w + w * 3 * hd + 4.0 * 3 * hd
         + 2.0 * m * 3 * hd),
        ("quantize_activations alone",
         lambda: Q.quantize_activations(x)[0], 0.0, 2.0 * m * w + m * w
         + 4.0 * m),
    ]


@functools.cache
def int8_probe() -> float:
    """Sustained int8 TOP/s of torch._int_mm on two 8192² matrices,
    measured once a process."""
    a = torch.randint(-127, 128, (8192, 8192), device="cuda",
                      dtype=torch.int8)
    us = cuda_us(lambda: torch._int_mm(a, a))
    return 2 * 8192 ** 3 / (us * 1e-6) / 1e12


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_us(fn: Callable) -> float:
    """µs per launch of fn: CUDA events around ITERS launches, after 3."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / ITERS


@functools.cache
def matmul_probe() -> float:
    """Sustained bf16 TFLOP/s of torch.matmul on two 8192² matrices,
    measured once a process."""
    a = torch.randn(8192, 8192, device="cuda").to(torch.bfloat16)
    us = cuda_us(lambda: torch.matmul(a, a))
    return 2 * 8192 ** 3 / (us * 1e-6) / 1e12


def run(model: str = "g", device: str = "cuda", out=print,
        int8: bool = False) -> Dict[str, dict]:
    """Run every part once (and, on the card, time it); with int8, the
    W8A8 parts too. Returns {part: {"us", "bound_us", "bound_by",
    "probe_us", "shape"}}; on the CPU the times are None."""
    shape = SHAPES[model]
    dev = torch.device(device)
    results: Dict[str, dict] = {}
    tf = None
    if dev.type == "cuda":
        out(f"card: {card_line()}; {torch.cuda.get_device_name(dev)}")
        tf = matmul_probe()
        out(f"sustained matmul (torch.matmul 8192² bf16): {tf:.1f} TFLOP/s")
    out(f"ViT {model}: B {shape['b']}, S {shape['s']}, width {shape['w']}, "
        f"hidden {shape['hid']}, {shape['h']} x {shape['d']}, "
        f"{shape['layers']} layers, MLP {'post' if shape['post'] else 'pre'}"
        f"-LN")
    def measure(part_list, peak, rate):
        """rate: the probe's sustained ops/s (None on the CPU)."""
        for name, fn, ops, nbytes in part_list:
            y = fn()
            if not bool(torch.isfinite(y.float()).all()):
                raise AssertionError(f"{name}: non-finite output")
            t_b, t_o = nbytes / HBM_BPS * 1e6, ops / peak * 1e6
            res = {"shape": tuple(y.shape), "us": None,
                   "bound_us": max(t_b, t_o),
                   "bound_by": "bytes" if t_b >= t_o else "operations",
                   "probe_us": None if rate is None else ops / rate * 1e6}
            if dev.type == "cuda":
                res["us"] = cuda_us(fn)
                out(f"  {name:42s} {res['us']:9.1f} us/layer  bound "
                    f"{res['bound_us']:7.1f} us ({res['bound_by']}, "
                    f"{100 * res['bound_us'] / res['us']:5.1f}%)  at the "
                    f"probe {res['probe_us']:7.1f} us")
            else:
                out(f"  {name:42s} {tuple(y.shape)} (not timed on the CPU)")
            results[name] = res

    with torch.inference_mode():
        measure(parts(shape, dev), PEAK_BF16, tf and tf * 1e12)
        if int8:
            tops = int8_probe() if dev.type == "cuda" else None
            if tops is not None:
                out(f"W8A8 parts: sustained int8 (torch._int_mm 8192²): "
                    f"{tops:.1f} TOP/s ({tops / tf:.2f}x the bf16 probe)")
            else:
                out("W8A8 parts")
            measure(int8_parts(shape, dev), PEAK_INT8, tops and tops * 1e12)
            if dev.type == "cuda":
                e, b = results[W8A8_MLP]["us"], results[BF16_MLP]["us"]
                out(f"kernel E (W8A8) {e:.1f} us against kernel B (bf16) "
                    f"{b:.1f} us at the same shape: {b / e:.2f}x")
    if dev.type == "cuda":
        layer = sum(results[n]["us"] for n in LAYER_PARTS)
        out(f"one layer from the parts ({', '.join(LAYER_PARTS)}): "
            f"{layer / 1e3:.3f} ms -> "
            f"{shape['b'] / (shape['layers'] * layer * 1e-6):.1f} img/s over "
            f"{shape['layers']} layers")
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["g", "4b"], default="g")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--int8", action="store_true",
                    help="also the W8A8 parts (kernel E)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_vit_parts: no CUDA device (use --device cpu "
                         "for the tiny CPU run)")
    run("tiny" if args.device == "cpu" else args.model, args.device,
        int8=args.int8)


if __name__ == "__main__":
    main()
