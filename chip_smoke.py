#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`emu_tpu_torch`) once on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from emu_tpu_torch/csrc (one nvcc per source, in
     parallel);
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the Emu1 caption path and the Emu2-Chat int4 path give it, with the
     error, its tolerance and both times;
  4. a full-width Emu1 cut to 2 layers, built from one seed: last-position
     logits of one caption prompt on the card (bf16, kernels) against the
     CPU (fp32, plain twins);
  5. the full-width, full-depth Emu1 (ViT-g, T5-base Causal Former,
     LLaMA-13B; random weights drawn on the card) answering caption/VQA
     requests through Emu1Runner, with every kernel's launch count;
  6. a full-width Emu2-Chat cut to 2 EVA blocks and 2 LLaMA layers, built
     from one seed: last-position logits of one image + question on the
     card against the CPU (fp32, plain twins), in bf16 and in int4;
  7. the full-width, full-depth Emu2-Chat (EVA-4B, LLaMA-33B; random
     weights drawn and quantized int4 / W8A8 on the card one layer at a
     time) answering image, two-image chat, 8-frame video and text-only
     requests through EmuChatGeneration, with every kernel's launch count.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
MAX_NEW = 32


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
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


def compare(name: str, got, ref, atol: float, rtol: float) -> dict:
    """max |got - ref| against atol + rtol * max |ref|; raises if above."""
    import torch
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = atol + rtol * scale
    print(f"  {name}: max_abs_err={err:.6g} max|ref|={scale:.6g} "
          f"max_rel_err={err / max(scale, 1e-30):.6g} tol={tol:.6g} "
          f"(atol {atol} + rtol {rtol} * max|ref|)")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")
    return {"max_abs_err": err}


def check_kernels(card: str) -> dict:
    """Phase 3: every kernel against its twin at the paths' shapes."""
    import torch
    from emu_tpu_torch.ops import decode_attention as D
    from emu_tpu_torch.ops import flash_attention as A
    from emu_tpu_torch.ops import fused_mlp as B
    from emu_tpu_torch.ops import fused_norm as C
    from emu_tpu_torch.ops import q4_matmul as Q4
    from emu_tpu_torch.ops import quant as Q

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, device=dev, generator=g) * std).to(bf)

    results = {}

    def run(name, kernel, twin, atol, rtol):
        got, ref = kernel(), twin()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        res = {"max_abs_err": 0.0}
        for i, (a, b) in enumerate(zip(got, ref)):
            r = compare(f"{name}[{i}]", a, b, atol, rtol)
            res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        res["ms"], res["plain_ms"] = cuda_ms(kernel), cuda_ms(twin)
        print(f"  {name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f}"
              f" ms  [{card}]")
        results[name] = res

    # A1: ViT-g self-attention, batch 8, q/v biases, ragged S = 257
    q, k, v = (randn(8, 257, 16, 88).transpose(1, 2) for _ in range(3))
    qb, vb = randn(16, 88, std=0.5), randn(16, 88, std=0.5)
    run("attention_vit_8x16x257x88", lambda: A.mha_bhsd(q, k, v, qb, vb,
                                                        scale=88 ** -0.5),
        lambda: A.attention_reference(q, k, v, qb, vb, scale=88 ** -0.5),
        atol=1e-2, rtol=1e-2)
    # A2: LLaMA-13B prefill, causal, left-padded kv_valid
    s = 80
    q, k, v = (randn(8, 40, s, 128) for _ in range(3))
    pads = torch.arange(8, device=dev) * 5
    valid = torch.arange(s, device=dev)[None, :] >= pads[:, None]
    run("attention_causal_8x40x80x128",
        lambda: A.attention(q, k, v, kv_valid=valid, scale=128 ** -0.5,
                            causal=True),
        lambda: A.attention_reference(q, k, v, kv_valid=valid,
                                      scale=128 ** -0.5, causal=True),
        atol=1e-2, rtol=1e-2)
    # B: ViT-g MLP branch, M = 8 * 257 rows, 1408 -> 6144 -> 1408
    x = randn(8, 257, 1408)
    w1, w2 = randn(1408, 6144, std=0.02), randn(6144, 1408, std=0.02)
    b1, b2 = randn(6144, std=0.1), randn(1408, std=0.1)
    lns, lnb = 1 + randn(1408, std=0.1), randn(1408, std=0.1)
    kw = dict(ln_scale=lns, ln_bias=lnb, ln_mode="pre", residual=True)
    run("fused_mlp_2056x1408x6144", lambda: B.fused_mlp(x, w1, b1, w2, b2, **kw),
        lambda: B.fused_mlp_reference(x, w1, b1, w2, b2, **kw),
        atol=2e-2, rtol=2e-2)
    x1 = x[:1]   # one image: M = 257 rows
    run("fused_mlp_257x1408x6144", lambda: B.fused_mlp(x1, w1, b1, w2, b2, **kw),
        lambda: B.fused_mlp_reference(x1, w1, b1, w2, b2, **kw),
        atol=2e-2, rtol=2e-2)
    for xm in (x, x1):   # the hidden-dim splits sum in a fixed order
        if not torch.equal(B.fused_mlp(xm, w1, b1, w2, b2, **kw),
                           B.fused_mlp(xm, w1, b1, w2, b2, **kw)):
            raise AssertionError("fused_mlp: two runs gave different bits")
    print("  fused_mlp: two runs give the same bits at M = 2056 and 257")
    # C: add_rmsnorm over prefill rows (8 * 80) and decode rows (8), W = 5120
    w = 1 + randn(5120, std=0.1)
    for rows in (640, 8):
        xr, rr = randn(rows, 5120), randn(rows, 5120)
        run(f"add_rmsnorm_{rows}x5120",
            lambda: C.rmsnorm_fwd(w, xr, rr)[:2],
            lambda: C.rmsnorm_reference(w, xr, rr)[:2], atol=1e-2, rtol=1e-2)
        run(f"rms_norm_{rows}x5120", lambda: C.rms_norm_fused(w, xr),
            lambda: C.rmsnorm_reference(w, xr)[1], atol=1e-2, rtol=1e-2)
    # D: decode against a stacked 2-layer cache, ragged kv_valid, extra column
    for b in (8, 5):
        kc, vc = randn(2, b, 40, 256, 128), randn(2, b, 40, 256, 128)
        qd = randn(b, 1, 40, 128)
        kn, vn = randn(b, 40, 1, 128), randn(b, 40, 1, 128)
        lens = 100 + 19 * torch.arange(b, device=dev)
        valid = torch.arange(256, device=dev)[None, :] < lens[:, None]
        dkw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
        run(f"decode_attention_b{b}_40x256x128",
            lambda: D.decode_attention(qd, kc, vc, valid, **dkw),
            lambda: D.decode_attention_reference(qd, kc, vc, valid, **dkw),
            atol=1e-2, rtol=1e-2)

    # --- the Emu2-Chat int4 path's shapes ---------------------------------
    # A: EVA-4B self-attention, one 448-px image, q/v biases, D = 112
    q, k, v = (randn(1, 1025, 16, 112).transpose(1, 2) for _ in range(3))
    qb, vb = randn(16, 112, std=0.5), randn(16, 112, std=0.5)
    run("attention_vit_1x16x1025x112",
        lambda: A.mha_bhsd(q, k, v, qb, vb, scale=112 ** -0.5),
        lambda: A.attention_reference(q, k, v, qb, vb, scale=112 ** -0.5),
        atol=1e-2, rtol=1e-2)
    # C: LLaMA-33B norms, prefill and beam-decode rows, W = 6656
    w = 1 + randn(6656, std=0.1)
    for rows in (330, 5):
        xr, rr = randn(rows, 6656), randn(rows, 6656)
        run(f"add_rmsnorm_{rows}x6656", lambda: C.rmsnorm_fwd(w, xr, rr)[:2],
            lambda: C.rmsnorm_reference(w, xr, rr)[:2], atol=1e-2, rtol=1e-2)
    # D: 5 beams, 52 heads of 128, a 384-slot stacked cache
    kc, vc = randn(2, 5, 52, 384, 128), randn(2, 5, 52, 384, 128)
    qd = randn(5, 1, 52, 128)
    kn, vn = randn(5, 52, 1, 128), randn(5, 52, 1, 128)
    valid = torch.arange(384, device=dev)[None, :] < 330
    valid = valid.expand(5, 384).contiguous()
    dkw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
    run("decode_attention_b5_52x384x128",
        lambda: D.decode_attention(qd, kc, vc, valid, **dkw),
        lambda: D.decode_attention_reference(qd, kc, vc, valid, **dkw),
        atol=1e-2, rtol=1e-2)
    # B-post: the bf16 EVA-4B MLP branch x + LN(fc2(gelu(fc1 x))),
    # 1792 -> 15360 -> 1792, one and two images
    x = randn(2, 1025, 1792)
    w1, w2 = randn(1792, 15360, std=0.02), randn(15360, 1792, std=0.02)
    b1, b2 = randn(15360, std=0.1), randn(1792, std=0.1)
    lns, lnb = 1 + randn(1792, std=0.1), randn(1792, std=0.1)
    kw = dict(ln_scale=lns, ln_bias=lnb, ln_mode="post", residual=True)
    for xm, m in ((x[:1], 1025), (x, 2050)):
        run(f"fused_mlp_post_{m}x1792x15360",
            lambda: B.fused_mlp(xm, w1, b1, w2, b2, **kw),
            lambda: B.fused_mlp_reference(xm, w1, b1, w2, b2, **kw),
            atol=2e-2, rtol=2e-2)
    # E: the W8A8 EVA-4B MLP branch at 2 and 4 images, pre- and post-LN,
    # hidden blocks of 768
    q1, q2 = Q.quantize_kernel(w1), Q.quantize_kernel(w2)
    wq = (q1["kernel_q8"], q1["scale"], b1, q2["kernel_q8"], q2["scale"], b2)
    x4 = randn(4, 1025, 1792)
    for mode in ("post", "pre"):
        ekw = dict(kw, ln_mode=mode, bf=768)
        for xm, m in ((x, 2050), (x4, 4100)):
            run(f"fused_mlp_w8a8_{mode}_{m}x1792x15360",
                lambda: B.fused_mlp_w8a8(xm, *wq, **ekw),
                lambda: B.fused_mlp_w8a8_reference(xm, *wq, **ekw),
                atol=2e-2, rtol=2e-2)
            if not torch.equal(B.fused_mlp_w8a8(xm, *wq, **ekw),
                               B.fused_mlp_w8a8(xm, *wq, **ekw)):
                raise AssertionError("fused_mlp_w8a8: two runs gave "
                                     "different bits")
    print("  fused_mlp_w8a8: two runs give the same bits at M = 2050, 4100")
    del w1, w2, q1, q2, wq, x4
    # F: int4 projections of LLaMA-33B: qkv and the lm_head (ragged N) at 5
    # beam rows, gate_up at a 330-token prefill
    for m, k, n, tag in ((5, 6656, 19968, "qkv"), (5, 6656, 32274, "lm_head"),
                         (330, 6656, 35840, "gate_up")):
        p = Q.quantize_kernel_int4(randn(k, n, std=0.02))
        xm = randn(m, k)
        run(f"matmul_q4_{tag}_{m}x{k}x{n}",
            lambda: Q4.matmul_q4(xm, p["kernel_q4"], p["scale4"]),
            lambda: Q4.matmul_q4_reference(xm, p["kernel_q4"], p["scale4"]),
            atol=1e-2, rtol=1e-2)
        del p
    # G: the int4 decode MLP of LLaMA-33B, D = 6656, F = 17920 (block 256)
    gu = Q.quantize_kernel_int4(randn(6656, 35840, std=0.02))
    dn = Q.quantize_kernel_int4(randn(17920, 6656, std=0.02))
    gargs = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    for m in (1, 5):
        xm, wr = randn(m, 6656), 1 + randn(6656, std=0.1)
        run(f"fused_swiglu_q4_{m}x6656x17920",
            lambda: Q4.fused_swiglu_q4(xm, wr, *gargs),
            lambda: Q4.fused_swiglu_q4_reference(xm, wr, *gargs),
            atol=2e-2, rtol=2e-2)
    return results


def check_two_layer(card: str, image) -> None:
    """Phase 4: the same 2-layer full-width weights, card bf16 vs CPU fp32."""
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.cli.inference import (Emu1Runner, build_runner,
                                             image_system_msg)
    from emu_tpu_torch.models.emu1 import Emu1

    t0 = time.perf_counter()
    cpu = build_runner(full=True, device="cpu", seed=SEED, depth=2)
    gpu_model = Emu1(cpu.cfg, cast_tree(cpu.model.tree(), "cuda",
                                        torch.bfloat16))
    gpu = Emu1Runner(gpu_model, cpu.cfg, cpu.tokenizer)
    prompt = cpu.caption_prompt()
    ref = cpu.next_token_logits([image], prompt, system=image_system_msg)
    got = gpu.next_token_logits([image], prompt, system=image_system_msg)
    print(f"  2-layer full-width Emu1, vocab {ref.shape[-1]}, "
          f"{time.perf_counter() - t0:.1f} s")
    compare("logits_2layer_card_bf16_vs_cpu_fp32", got.cpu(), ref,
            atol=0.0, rtol=0.05)
    agree = int(got.float().argmax()) == int(ref.argmax())
    print(f"  argmax agrees: {agree}")


def run_full(card: str, images) -> None:
    """Phase 5: full-depth Emu1 through the runner, a few requests."""
    import torch
    from emu_tpu_torch.cli.inference import build_runner

    t0 = time.perf_counter()
    runner = build_runner(full=True, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    print(f"  built full Emu1 on the card in {time.perf_counter() - t0:.1f} s;"
          f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    vocab = runner.cfg.llama.extended_vocab_size

    def report(label, outs):
        """Decode rate as tokens returned to the caller (one sequence per
        prompt); beam search's hypotheses per second stand apart."""
        st = runner.last_stats
        steps = max(st["decode_steps"], 1)
        dec_s = max(st["decode_s"], 1e-9)
        beams = ("" if st["beams"] == 1 else
                 f" ({st['rows'] * st['beams'] * steps / dec_s:.1f} beam "
                 f"hypothesis tok/s over {st['beams']} beams)")
        print(f"  {label}: images={st['images']} rows={st['rows']} "
              f"encode {st['encode_s'] * 1e3:.1f} ms, prefill "
              f"{st['prefill_s'] * 1e3:.1f} ms, decode "
              f"{st['decode_s'] * 1e3 / steps:.2f} ms/step over {steps} steps,"
              f" {st['rows'] * steps / dec_s:.1f} returned tok/s{beams}  "
              f"[{card}]")
        for o in outs:
            print(f"    -> {o[:120]!r}")

    torch.cuda.reset_peak_memory_stats()
    out = runner.caption(images[0], max_new_tokens=MAX_NEW, beam_size=5)
    report("caption beam5", [out])
    out = runner.vqa(images[1], "What is the animal doing?",
                     max_new_tokens=MAX_NEW, beam_size=1)
    report("vqa greedy", [out])
    texts = [f"{runner.placeholder}Describe picture {i} in one sentence."
             for i in range(8)]
    ids = runner.generate_ids(images[:8], texts, max_new_tokens=MAX_NEW,
                              beam_size=1)
    assert ids.shape == (8, MAX_NEW) and int(ids.max()) < vocab
    report("batch-8 greedy",
           runner.tokenizer.batch_decode(ids.tolist())[:2])
    out = runner.generate(images[:3], runner.placeholder * 3
                          + "What changes between these three frames?",
                          max_new_tokens=MAX_NEW, beam_size=1)
    report("3-image greedy", [out])
    logits = runner.next_token_logits([images[0]], runner.caption_prompt())
    assert logits.shape == (1, vocab) and bool(torch.isfinite(logits).all())
    with torch.inference_mode():
        emb = runner.model.encode_image(torch.zeros(
            2, 224, 224, 3, device="cuda", dtype=torch.bfloat16))
    assert emb.shape == (2, 32, 5120) and bool(torch.isfinite(emb).all())
    print(f"  outputs finite; peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB")


def check_emu2_two_layer(card: str, image) -> None:
    """Phase 6: the same 2-layer full-width Emu2-Chat weights, card vs CPU
    (fp32, plain twins), bf16 and int4. Limits stated before the first run:
    max |logit error| <= 0.05 * max|ref| (bf16), 0.08 * max|ref| (int4)."""
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration

    t0 = time.perf_counter()
    cpu = EmuChatGeneration.from_config(instruct=True, seed=SEED,
                                        device="cpu", depth=2)
    request = [image, "Describe the image in one sentence."]
    print(f"  2-layer full-width Emu2-Chat built on the CPU in "
          f"{time.perf_counter() - t0:.1f} s")
    for mode, rtol in ((None, 0.05), ("int4", 0.08)):
        t0 = time.perf_counter()
        ref_pipe = (cpu if mode is None else
                    EmuChatGeneration(cpu.params, cpu.cfg, cpu.tokenizer,
                                      quantize=mode))
        ref = ref_pipe.next_token_logits(request)
        gpu = EmuChatGeneration(cast_tree(ref_pipe.params, "cuda",
                                          torch.bfloat16),
                                cpu.cfg, cpu.tokenizer)
        got = gpu.next_token_logits(request)
        print(f"  {mode or 'bf16'}: vocab {ref.shape[-1]}, "
              f"{time.perf_counter() - t0:.1f} s")
        compare(f"emu2_logits_2layer_card_{mode or 'bf16'}_vs_cpu_fp32",
                got.cpu(), ref, atol=0.0, rtol=rtol)
        print(f"  argmax agrees: {int(got.float().argmax()) == int(ref.argmax())}")
        del gpu, ref_pipe
        torch.cuda.empty_cache()


def run_emu2_full(card: str, images) -> None:
    """Phase 7: full-depth Emu2-Chat, int4 decoder and W8A8 tower."""
    import torch
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration

    t0 = time.perf_counter()
    chat = EmuChatGeneration.from_config(instruct=True, seed=SEED,
                                         device="cuda", quantize="int4")
    torch.cuda.synchronize()
    print(f"  built full Emu2-Chat int4 on the card in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    vocab = chat.cfg.llama.extended_vocab_size
    requests = [
        ("1 image + question, beam 5", [images[0], "What is shown here?"]),
        ("2-turn chat, 2 images, beam 5",
         [[images[1], "What is in this picture?"], ["A cat on a sofa."],
          [images[2], "How does this one differ from the first?"]]),
        ("8-frame video, beam 5",
         ["[VIDEO]", *images[:8], "[/VIDEO]", "What happens in the video?"]),
        ("text only, beam 5", [["Write one sentence about the sea."]]),
    ]
    for label, req in requests:
        torch.cuda.reset_peak_memory_stats()
        ids = chat.generate_ids([req], max_new_tokens=MAX_NEW)
        assert ids.shape == (1, MAX_NEW) and int(ids.max()) < vocab
        st = chat.last_stats
        steps = max(st["decode_steps"], 1)
        print(f"  {label}: images={st['images']} frames={st['frames']} "
              f"prompt={st['prompt_len']} encode {st['encode_s'] * 1e3:.1f} ms,"
              f" prefill {st['prefill_s'] * 1e3:.1f} ms, decode "
              f"{st['decode_s'] * 1e3 / steps:.2f} ms/step over {steps} steps,"
              f" peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  "
              f"[{card}]")
        text = chat.tokenizer.batch_decode(ids.cpu().numpy())[0]
        print(f"    -> {text[:120]!r}")
    logits = chat.next_token_logits(requests[0][1])
    assert logits.shape == (1, vocab) and bool(torch.isfinite(logits).all())
    print("  outputs finite")


KERNELS = [  # name, source, replaces, wrapper, checks (first one timed)
    ("attention", "emu_tpu_torch/csrc/attention.cu",
     "emu_tpu/ops/flash_attention.py:487", "A.attention",
     ["attention_vit_8x16x257x88", "attention_causal_8x40x80x128",
      "attention_vit_1x16x1025x112"]),
    ("fused_mlp", "emu_tpu_torch/csrc/fused_mlp.cu",
     "emu_tpu/ops/fused_mlp.py:357", "B.fused_mlp",
     ["fused_mlp_2056x1408x6144", "fused_mlp_257x1408x6144",
      "fused_mlp_post_1025x1792x15360", "fused_mlp_post_2050x1792x15360"]),
    ("add_rmsnorm", "emu_tpu_torch/csrc/rmsnorm.cu",
     "emu_tpu/ops/fused_norm.py:100", "C.rmsnorm_fwd",
     ["add_rmsnorm_640x5120", "add_rmsnorm_8x5120", "rms_norm_640x5120",
      "rms_norm_8x5120", "add_rmsnorm_330x6656", "add_rmsnorm_5x6656"]),
    ("decode_attention", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:166", "D.decode_attention",
     ["decode_attention_b8_40x256x128", "decode_attention_b5_40x256x128",
      "decode_attention_b5_52x384x128"]),
    ("fused_mlp_w8a8", "emu_tpu_torch/csrc/fused_mlp_w8a8.cu",
     "emu_tpu/ops/fused_mlp.py:194", "B.fused_mlp_w8a8",
     ["fused_mlp_w8a8_post_2050x1792x15360",
      "fused_mlp_w8a8_post_4100x1792x15360",
      "fused_mlp_w8a8_pre_2050x1792x15360",
      "fused_mlp_w8a8_pre_4100x1792x15360"]),
    ("matmul_q4", "emu_tpu_torch/csrc/q4_matmul.cu",
     "emu_tpu/ops/q4_matmul.py:91", "Q4.matmul_q4",
     ["matmul_q4_qkv_5x6656x19968", "matmul_q4_lm_head_5x6656x32274",
      "matmul_q4_gate_up_330x6656x35840"]),
    ("fused_swiglu_q4", "emu_tpu_torch/csrc/q4_matmul.cu",
     "emu_tpu/ops/q4_matmul.py:295", "Q4.fused_swiglu_q4",
     ["fused_swiglu_q4_5x6656x17920", "fused_swiglu_q4_1x6656x17920"]),
]


def drive(label: str, wrappers: dict, needed, fn, *args) -> dict:
    """Run one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was not launched."""
    for w in wrappers.values():
        w.launches = 0
    fn(*args)
    counts = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches in the {label} path: {counts}")
    for n in needed:
        if counts[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched in the {label}"
                                 " path")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "emu_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    from PIL import Image
    from emu_tpu_torch.ops import _cuda
    from emu_tpu_torch.ops import decode_attention as D
    from emu_tpu_torch.ops import flash_attention as A
    from emu_tpu_torch.ops import fused_mlp as B
    from emu_tpu_torch.ops import fused_norm as C
    from emu_tpu_torch.ops import q4_matmul as Q4
    mods = {"A": A, "B": B, "C": C, "D": D, "Q4": Q4}
    wrappers = {}
    for name, _, _, ref, _ in KERNELS:
        mod, attr = ref.split(".")
        wrappers[name] = getattr(mods[mod], attr)

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _cuda.build(verbose=True)
    _cuda.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_cuda.library_path().relative_to(ROOT)})")

    print("[3] kernels vs plain twins (bf16, the paths' shapes)")
    res = check_kernels(card)

    rng = np.random.RandomState(SEED)
    images = [Image.fromarray(rng.randint(0, 256, (224 + 16 * i, 256, 3),
                                          dtype=np.uint8)) for i in range(8)]
    print("[4] 2-layer full-width Emu1: card bf16 vs CPU fp32")
    check_two_layer(card, images[0])

    launches = {n: 0 for n in wrappers}

    def count(counts):
        for n, c in counts.items():
            launches[n] += c

    print("[5] full-depth Emu1 through Emu1Runner")
    count(drive("Emu1 caption", wrappers,
                ["attention", "fused_mlp", "add_rmsnorm", "decode_attention"],
                run_full, card, images))
    print("[6] 2-layer full-width Emu2-Chat: card (bf16, int4) vs CPU fp32")
    count(drive("Emu2 2-layer bf16 and int4", wrappers,
                ["attention", "fused_mlp", "add_rmsnorm", "matmul_q4"],
                check_emu2_two_layer, card, images[0]))
    print("[7] full-depth Emu2-Chat int4 through EmuChatGeneration")
    count(drive("Emu2-Chat int4", wrappers,
                ["attention", "add_rmsnorm", "decode_attention",
                 "fused_mlp_w8a8", "matmul_q4", "fused_swiglu_q4"],
                run_emu2_full, card, images))
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, source, replaces, _, keys in KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(res[k]["max_abs_err"] for k in keys),
            "ms": res[keys[0]]["ms"], "plain_ms": res[keys[0]]["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
