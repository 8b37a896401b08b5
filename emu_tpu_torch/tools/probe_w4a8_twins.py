"""Kernels F, G and D against their plain twins on the card, call by call,
and how far one bf16 ulp moves the W4A8 decoder's logits.

Usage:
  python -m emu_tpu_torch.tools.probe_w4a8_twins [--seed 1234]

On the 2-layer full-width Emu2-Chat int4 decoder (LLaMA-33B widths, drawn
from --seed on the CPU and quantized there, then cast to bf16 on the card,
as chip_smoke.py phase 8 builds it), a bucket prefill of two rows of 64
tokens (the second left-padded by 24), it prints:

1. every call of kernel F on the prefill's path against its plain twin on
   the same inputs: max |kernel - twin| beside max|twin|, the share of
   output elements that differ, and the relative L2 difference;
2. the prefill's last-position logits with F, G and D replaced by their
   twins, against the kernels' logits;
3. the twins' run with the output of one product (the first, layer 0's
   q|k|v, or the fourth, layer 0's down) moved up by one bf16 ulp on a
   share p of its elements (p = 0.001, 0.01, 0.1), against the twins' own
   logits: the function's sensitivity to a rounding, whatever computes it.

`twin_witness` is what chip_smoke.py phase 8 uses to hold the same
kernels to their twins call by call. Card only.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import torch


@contextlib.contextmanager
def swapped_q4_path(make):
    """Inside the block, the main path's calls of kernels F, G and D (at
    the names `layers`, `llama` and `ops.attention` call them by) go to
    make(name, kernel wrapper, plain twin)."""
    from emu_tpu_torch.models import llama
    from emu_tpu_torch.ops import attention as OA
    from emu_tpu_torch.ops import decode_attention as D
    from emu_tpu_torch.ops import layers as L
    from emu_tpu_torch.ops import q4_matmul as Q4
    sites = [(L, "matmul_q4", Q4.matmul_q4_reference),
             (llama, "fused_swiglu_q4", Q4.fused_swiglu_q4_reference),
             (OA, "decode_attention", D.decode_attention_reference)]
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for (mod, name, twin), (_, _, kernel) in zip(sites, kept):
        setattr(mod, name, make(name, kernel, twin))
    try:
        yield
    finally:
        for mod, name, fn in kept:
            setattr(mod, name, fn)


def plain_twins():
    """F, G and D's calls run their plain twins, on whatever device their
    tensors are (F and G's twins are exact integer references; D's
    computes in fp32)."""
    return swapped_q4_path(lambda name, kernel, twin: twin)


def twin_witness(records: list, measure=None):
    """Each call of F, G and D runs its plain twin on the same inputs first
    (the twins only read them), then the kernel, whose output goes on;
    records (name, input shape, measure(kernel output, twin output)),
    by default (max |kernel - twin|, max |twin|)."""
    measure = measure or (lambda out, ref: (
        float((out.float() - ref).abs().max()), float(ref.abs().max())))

    def make(name, kernel, twin):
        def call(*args, **kwargs):
            ref = twin(*args, **kwargs).float()
            out = kernel(*args, **kwargs)
            records.append((name, tuple(args[0].shape), *measure(out, ref)))
            return out
        return call
    return swapped_q4_path(make)


def differences(a, b) -> dict:
    """max |a - b|, max |b|, the share of elements that differ, relative
    L2."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return {"max_abs": float(d.max()), "max_ref": float(b.abs().max()),
            "share_differing": float((d > 0).float().mean()),
            "rel_l2": float(d.norm() / b.norm())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=1234)
    args = p.parse_args(argv)
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.models import llama
    from emu_tpu_torch.ops import layers as L
    from emu_tpu_torch.ops import q4_matmul as Q4
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cpu = EmuChatGeneration.from_config(instruct=True, seed=args.seed,
                                        device="cpu", depth=2,
                                        quantize="int4")
    cfg = cpu.cfg.llama
    dec = cast_tree(cpu.params["decoder"], "cuda", torch.bfloat16)
    del cpu
    g = torch.Generator().manual_seed(args.seed)
    ids = torch.randint(3, cfg.vocab_size, (2, 64), generator=g).cuda()
    mask = torch.ones(2, 64, dtype=torch.long)
    mask[1, :24] = 0
    mask = mask.cuda()

    def prefill():
        cache = llama.init_cache(cfg, 2, 64, device="cuda", quant=True)
        h, _ = llama.prefill(dec, cfg, llama.embed(dec, ids), mask, cache)
        return llama.logits(dec, h[:, -1]).float()

    out = {"card": card}
    with torch.inference_mode():
        calls = []
        with twin_witness(calls, lambda o, r: [differences(o, r)]):
            kernels = prefill()
        out["calls"] = [{"kernel": n, "input": list(s), **d}
                        for n, s, d in calls]
        with plain_twins():
            twins = prefill()
        out["logits_kernels_vs_twins"] = differences(kernels, twins)
        out["one_ulp"] = []
        for which in (0, 3):
            for share in (0.001, 0.01, 0.1):
                seen = [0]

                def moved(x, packed, scale4, bias=None):
                    y = Q4.matmul_q4_reference(x, packed, scale4, bias)
                    if seen[0] == which:
                        gen = torch.Generator(device="cuda").manual_seed(1)
                        pick = torch.rand(y.shape, device="cuda",
                                          generator=gen) < share
                        up = torch.nextafter(y, torch.full_like(
                            y, float("inf")))
                        y = torch.where(pick, up, y)
                    seen[0] += 1
                    return y
                with plain_twins():
                    L.matmul_q4 = moved
                    logits = prefill()
                out["one_ulp"].append({"product": which, "share": share,
                                       **differences(logits, twins)})
    for c in out["calls"]:
        print(f"  F at input {c['input']}: max {c['max_abs']:.4g} of "
              f"max|twin| {c['max_ref']:.4g}, {c['share_differing']:.4g} of "
              f"the elements differ, rel L2 {c['rel_l2']:.4g}")
    d = out["logits_kernels_vs_twins"]
    print(f"  logits, kernels against twins: max {d['max_abs']:.4g} of "
          f"{d['max_ref']:.4g} ({d['max_abs'] / d['max_ref']:.4f}), rel L2 "
          f"{d['rel_l2']:.4g}")
    for r in out["one_ulp"]:
        print(f"  twins, product {r['product']} up one ulp on {r['share']} "
              f"of its elements: logits max {r['max_abs']:.4g} "
              f"({r['max_abs'] / r['max_ref']:.4f} of max), rel L2 "
              f"{r['rel_l2']:.4g}")
    print(f"  [{card}]")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
