"""Card time of kernels D (`decode_attention`) and G (`fused_swiglu_q4`) at
the shapes `chip_smoke.py` phase 3 times them, then the decode steps they
serve, without the twins.

Usage:
  python -m emu_tpu_torch.tools.bench_decode_kernels [--skip-model]

For each kernel shape it prints CUDA-event ms a call (20 launches after 3
warm-up ones) and the card's time alone from torch.profiler:

- D bf16 at Sq = 1 (the Emu1 caption decode: B 8 and 5, 40 heads, a
  256-slot cache; Emu2's beam decode: B 5, 52 heads, 384 slots), D int8 at
  Sq = 1 over a 60-layer cache of 1024 slots (rows of 600-950 tokens, and
  the continuous engine's 16-264), the chunk forms (the 32-query mixed
  step in int8 and bf16, the B 1 speculative verify of 5 queries), the
  paged forms (pages of 16: the decode step and the 32-query chunk form);
- G at 1, 5 and 8 rows of LLaMA-33B (D 6656, F 17920, hidden blocks of
  256).

Then, on the full-depth Emu2-Chat int4 (random weights from one seed): the
continuous engine's decode step alone (8 slots, int8 KV, 1024 slots: wall
ms a step, and its kernel ms under torch.profiler), and phase 7's first
request (one image and a question, beam 5, 32 new tokens): decode ms a
step. `--skip-model` leaves those out.

It imports only entry points that every version of the port has, so
running it from two checkouts (copy it into the other's `tools/`) compares
them on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from emu_tpu_torch.ops import decode_attention as D
from emu_tpu_torch.ops import q4_matmul as Q4
from emu_tpu_torch.ops import quant as Q

SEED = 1234


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


def card_ms(fn, iters: int = 10, by_kernel: dict | None = None):
    """Kernel time of one call from torch.profiler; None if the trace
    recorded no kernel. by_kernel, when given, receives ms a call by kernel
    name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            if by_kernel is not None:
                by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us / 1e3 / iters
    return total / 1e3 / iters if total > 0 else None


def kernels(measure, randn, g) -> None:
    dev = torch.device("cuda")

    def int8_planes(*shape):
        vals = torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)
        return vals, torch.rand(shape[:-1], device=dev, generator=g) * 0.02

    for b in (8, 5):
        kc, vc = randn(2, b, 40, 256, 128), randn(2, b, 40, 256, 128)
        q = randn(b, 1, 40, 128)
        kn, vn = randn(b, 40, 1, 128), randn(b, 40, 1, 128)
        lens = 100 + 19 * torch.arange(b, device=dev)
        valid = torch.arange(256, device=dev)[None, :] < lens[:, None]
        kw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
        measure(f"decode_attention_b{b}_40x256x128",
                lambda: D.decode_attention(q, kc, vc, valid, **kw))
    kc, vc = randn(2, 5, 52, 384, 128), randn(2, 5, 52, 384, 128)
    q = randn(5, 1, 52, 128)
    kn, vn = randn(5, 52, 1, 128), randn(5, 52, 1, 128)
    valid = (torch.arange(384, device=dev)[None, :] < 330).expand(5, 384)
    valid = valid.contiguous()
    kw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
    measure("decode_attention_b5_52x384x128",
            lambda: D.decode_attention(q, kc, vc, valid, **kw))
    del kc, vc

    S, H = 1024, 52
    pos = torch.arange(S, device=dev)[None, :]
    lens8 = 600 + 50 * torch.arange(8, device=dev)
    valid8 = pos < lens8[:, None]
    engine = pos < torch.tensor([16, 40, 64, 100, 150, 200, 240, 264],
                                device=dev)[:, None]

    def extra(b, qn):
        return (randn(b, qn, H, 128).transpose(1, 2),
                randn(b, qn, H, 128).transpose(1, 2))

    shape = (60, 8, H, S, 128)
    kq = torch.zeros(shape, dtype=torch.int8, device=dev)
    vq = torch.zeros(shape, dtype=torch.int8, device=dev)
    ks = torch.zeros(shape[:-1], device=dev)
    vs = torch.zeros(shape[:-1], device=dev)
    kq[59], ks[59] = int8_planes(*shape[1:])
    vq[59], vs[59] = int8_planes(*shape[1:])
    q = randn(8, 1, H, 128)
    kn, vn = extra(8, 1)
    kw = dict(scale=128 ** -0.5, layer=59, k_new=kn, v_new=vn)
    for tag, valid in (("_l59", valid8), ("_engine", engine)):
        measure(f"decode_int8_b8_52x1024x128{tag}",
                lambda: D.decode_attention(q, kq, vq, valid, ks, vs, **kw))
    q = randn(8, 32, H, 128)
    kn, vn = extra(8, 32)
    kw = dict(scale=128 ** -0.5, layer=59, k_new=kn, v_new=vn)
    measure("decode_chunk_int8_b8_q32_52x1024x128",
            lambda: D.decode_attention(q, kq, vq, valid8, ks, vs, **kw))
    del kq, vq, ks, vs
    kc, vc = randn(2, 8, H, S, 128), randn(2, 8, H, S, 128)
    for b, qn in ((1, 5), (8, 32)):
        q = randn(b, qn, H, 128)
        kn, vn = extra(b, qn)
        kcb, vcb = kc[:, :b].contiguous(), vc[:, :b].contiguous()
        vb = valid8[:b].contiguous()
        kw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
        measure(f"decode_chunk_bf16_b{b}_q{qn}_52x1024x128",
                lambda: D.decode_attention(q, kcb, vcb, vb, **kw))
    del kc, vc, kcb, vcb
    page, n_pages = 16, 8 * (S // 16) + 16
    table = torch.randperm(n_pages, device=dev, generator=g)[
        :8 * (S // page)].reshape(8, S // page).int()
    for quant in (False, True):
        pool = (2, n_pages, H, page, 128)
        if quant:
            kp, _ = int8_planes(*pool)
            vp, _ = int8_planes(*pool)
            pks = torch.rand(2, 8, H, S, device=dev, generator=g) * 0.02
            pvs = torch.rand(2, 8, H, S, device=dev, generator=g) * 0.02
        else:
            kp, vp, pks, pvs = randn(*pool), randn(*pool), None, None
        tag = "int8" if quant else "bf16"
        for qn in (1, 32):
            q = randn(8, qn, H, 128)
            kn, vn = extra(8, qn)
            kw = dict(scale=128 ** -0.5, k_scale=pks, v_scale=pvs, layer=1,
                      k_new=kn, v_new=vn)
            measure(f"paged_{tag}_b8_52x1024x128_p16" if qn == 1 else
                    f"paged_chunk_{tag}_b8_q32_52x1024x128_p16",
                    lambda: D.paged_decode_attention(q, kp, vp, table,
                                                     valid8, **kw))
        del kp, vp
    torch.cuda.empty_cache()

    gu = Q.quantize_kernel_int4(randn(6656, 35840, std=0.02))
    dn = Q.quantize_kernel_int4(randn(17920, 6656, std=0.02))
    args = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    for m in (1, 5, 8):
        x, w = randn(m, 6656), 1 + randn(6656, std=0.1)
        measure(f"fused_swiglu_q4_{m}x6656x17920",
                lambda: Q4.fused_swiglu_q4(x, w, *args))
    del gu, dn, args
    torch.cuda.empty_cache()


def words(n: int, tag: str) -> str:
    return " ".join(f"{tag}{i}" for i in range(n))


def model_steps(card: str, out: dict) -> None:
    """The full-depth Emu2-Chat int4: the engine's decode step alone and
    phase 7's first request's decode ms a step."""
    from PIL import Image
    from emu_tpu_torch.generation.continuous import ContinuousEngine
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration

    chat = EmuChatGeneration.from_config(instruct=True, seed=SEED,
                                         device="cuda", quantize="int4")
    eng = ContinuousEngine(chat.params["decoder"], chat.cfg.llama,
                           max_slots=8, max_len=1024, eos_token_id=None,
                           kv_cache_quant=True)
    rows = []
    for i, n in enumerate((16, 40, 60, 80, 120, 160, 200, 200)):
        emb, mask, _ = chat.embed_inputs([words(n, f"p{i}_")])
        rows.append((emb, mask, 64))
    eng.submit_many(rows)
    walls, kerns = [], []
    with torch.inference_mode():
        eng.record_block(eng.step_block(8))          # warm
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.record_block(eng.step_block(8))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / 8 * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eng.record_block(eng.step_block(8))
                torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + \
                        e.time_range.elapsed_us() / 1e3 / 8
            kerns.append(sum(by_name.values()))
    eng.close()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  engine decode step alone (8 slots, int8 KV, 1024 slots): wall "
          f"{walls} ms/step, kernels {kerns} ms/step  [{card}]")
    for name, t in top:
        print(f"    {t:8.3f} ms/step  {name[:90]}")
    out["engine decode step wall ms"] = walls
    out["engine decode step kernel ms"] = kerns
    out["engine top kernels ms/step"] = {n[:60]: t for n, t in top}

    rng = np.random.RandomState(SEED)
    image = Image.fromarray(rng.randint(0, 256, (224, 256, 3),
                                        dtype=np.uint8))
    per_step = []
    for _ in range(2):
        chat.generate_ids([[image, "What is shown here?"]], max_new_tokens=32)
        st = chat.last_stats
        per_step.append(st["decode_s"] * 1e3 / max(st["decode_steps"], 1))
    print(f"  Emu2 1 image + question, beam 5: decode {per_step} ms/step  "
          f"[{card}]")
    out["emu2 beam5 decode ms/step"] = per_step
    del chat
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-model", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_decode_kernels: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=g) * std).to(bf)

    rows = []

    def measure(name, fn):
        split = {}
        with torch.inference_mode():
            ms, dev_ms = event_ms(fn), card_ms(fn, by_kernel=split)
        rows.append({"name": name, "ms": ms, "card_ms": dev_ms})
        shown = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        parts = ", ".join(
            f"{k.replace('void ', '').replace('(anonymous namespace)::', '')[:48]}"
            f" {v:.4f}" for k, v in sorted(split.items(),
                                          key=lambda kv: -kv[1]))
        print(f"  {name}: {ms:.4f} ms a call, card {shown}  [{card}]\n"
              f"    by kernel: {parts}")

    kernels(measure, randn, g)
    steps: dict = {}
    if not opts.skip_model:
        model_steps(card, steps)
    print(json.dumps({"bench_decode_kernels": rows, "steps": steps}))


if __name__ == "__main__":
    main()
