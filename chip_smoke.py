#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`emu_tpu_torch`) once on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from emu_tpu_torch/csrc (one nvcc per source, in
     parallel);
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the Emu1 caption path, the Emu2-Chat int4 path, training, the
     diffusion UNets, the ViTs, CLIP and the pooler give it, with the
     error, its tolerance
     and both times (kernel A against the plain chain at the UNets'
     cross-attention shapes, the measurement behind that route; kernel H
     against the fp32 route it replaced and, at every shape its TMA plan
     takes, against its mma.sync plan, the same bits twice; kernel D's
     four forms, dense and paged, with the plan each launch took, the
     paged chunk forms also against the dense ones bit for bit, and kernel
     G at 1, 5 and the continuous engine's 8 rows, the same bits twice; D
     int8 also at the engine's occupancy, rows of 16-264 in its 1024
     slots; C's backward with bf16 and fp32 weights, dx and dw the same
     bits twice);
  4. a full-width Emu1 cut to 2 layers, built from one seed: last-position
     logits of a caption prompt, an 8-frame video-QA prompt and a
     two-image interleaved prompt on the card (bf16, kernels) against the
     CPU (fp32, plain twins);
  5. the full-width, full-depth Emu1 (ViT-g, T5-base Causal Former,
     LLaMA-13B; random weights drawn on the card) answering caption/VQA
     requests through Emu1Runner, with every kernel's launch count: beam
     search and greedy, a two-image interleaved request and an 8-frame
     video-QA request at beam 5 (their launches held to the counts the
     structure gives), then a sampled caption (the server's sampling
     defaults, a seeded card generator: the same tokens twice, and top_k=1
     sampling equal to greedy), a beam-sample caption at 5 beams, a
     contrastive-search caption (penalty_alpha 0.6, top_k 4: kernel D at 4
     rows) and a trie-constrained VQA answering one of yes/no/unanswerable;
  6. a full-width Emu2-Chat cut to 2 EVA blocks and 2 LLaMA layers, built
     from one seed: last-position logits of one image + question on the
     card against the CPU (fp32, plain twins), in bf16 and in int4, then
     the same trees in fp32 on the card (plain routes) answering a request;
  7. the full-width, full-depth Emu2-Chat (EVA-4B, LLaMA-33B; random
     weights drawn and quantized int4 / W8A8 on the card one layer at a
     time) answering image, two-image chat, 8-frame video and text-only
     requests through EmuChatGeneration, with every kernel's launch count,
     then a sampled chat (the same text twice from one seed) and a
     contrastive chat;
  8. the continuous engine's decode forms on a full-width Emu2-Chat int4
     cut to 2 layers, int8 KV cache, teacher-forced: last-position logits
     of a bucket prefill, two packed mixed steps (a chunk and a short
     final chunk, as the engine packs them) and decode steps on the card
     against the CPU (fp32, plain twins); every call of kernels F, G and D
     in that run against its plain twin on the same inputs on the card;
  9. the full-depth Emu2-Chat int4 served over HTTP by the continuous
     engine (int8 KV, chunked prefill, per-request sampling, a 1-layer
     draft for speculative requests), exactly as `python -m
     emu_tpu_torch.serving` wires it: an image request, six text requests,
     a speculative and a sampled one, posted concurrently, with the device
     span of every engine program; then the same mix with a bf16 KV
     cache, unjudged; then the engine's decode step alone under
     torch.profiler (kernel time against wall);
 10. the paged KV lane at full width: paged_prefill_insert + 8
     paged_decode_steps against the dense cache, bf16 and int8;
 11. one Emu1 train step on a full-width Emu1 cut to 2 layers (2 x 256
     tokens, fp32 images), card (bf16 weights, kernels A and C with their
     backward kernels) against the CPU (fp32, plain twins): the loss and
     every parameter's gradient;
 12. the full-width, full-depth Emu1 trained through training.Trainer
     (random bf16 weights, fp32 224-px images, fused_adafactor,
     remat="named", 2 x 1024 tokens, 5 steps on one batch): finite, falling
     losses, ms per step split into forward+backward and optimizer,
     tokens/s, peak memory, then one step under torch.profiler;
 13. the full-width SDXL UNet (64² latent, context [2, 64, 1792], SDXL
     time ids) and SD1.5-class UNet (32² latent, context [2, 32, 5120]), one
     CFG-batch forward each, and a 32² decode of each VAE, card (bf16)
     against the CPU (fp32), with each forward's batched_mha and kernel A
     launches held to the count the UNet's structure and the routes give;
 14. the full-width Emu2-Gen (EVA-4B W8A8, LLaMA-33B int4, SDXL UNet and
     VAE bf16; random weights) through EmuVisualGeneration at 1024², 50
     Euler steps, CFG 3.0: a text prompt, an image + text prompt, an image
     alone; one UNet step under torch.profiler; one request posted over
     HTTP to /v1/mmg (code 0, a 1024² WEBP); every latent finite;
 15. the full-width Emu1 generation (bf16) through EmuGenerationPipeline at
     512², 50 PLMS steps, CFG 7.5: a text prompt and an image + text
     prompt, then one UNet step under torch.profiler;
 16. a SwiGLU ViT at EVA02-CLIP-L-14 widths (RoPE, sub-LN off): 2 layers
     card (bf16) against the CPU (fp32), then 24 layers at batch 32, img/s;
 17. the ViT-parts bench (`emu_tpu_torch.tools.bench_vit_parts`) at ViT-g
     and EVA-4B shapes: each part of a layer in µs beside its bound, and
     its W8A8 part (kernel E beside an int8 probe and kernel B);
 18. checkpoints at full width, synthesized by `emu_tpu_torch.synth` from
     seeded trees and loaded onto the card with the bytes, seconds and GB/s
     of each load: phase 4's 2-layer Emu1 as an HF sharded .bin in bf16 (>=
     3 shards) and a copy with peft LoRA pairs on q/k/v/o; phase 6's
     2-layer Emu2-Chat as one bf16 .safetensors, in bf16 and int4
     (`EmuChatGeneration.from_pretrained`); the whole SD1.5-class UNet and
     its VAE as diffusers component dirs. Every loaded leaf equals the
     written tree bit for bit (LoRA: merged on the host), the Emu1 caption
     tokens equal the drawn tree's, the int4 tree has from_config's bits;
 19. CLIP ViT-L/14 at 2 layers a tower, card bf16 against CPU fp32
     (image_embeds, text_embeds, clip_score), then at full depth
     (evaluate_clip_score of 32 images, img/s and prompts/s); the
     SafetyChecker at full width on two 512² images (flags equal the CPU
     fp32 run's) and riding one request of phase 15's pipeline; the
     attentional pooler at CoCa ViT-L/14 widths, card against CPU; the eval
     harness (COCO, VizWiz, VisDial from synthetic annotation files) on
     phase 5's Emu1 tree; device preprocessing against the CPU and PIL,
     and a device-mode request through phase 7's Emu2-Chat int4 tree
     (parked on the host between phases 7 and 19);
 20. the parallel paths (`emu_tpu_torch.parallel`): two processes on the
     one card in a gloo group (`emu_tpu_torch.tools.parallel_smoke`), each
     part at full width against the unsharded run on the same card: (a)
     Emu2-Chat cut to 2 layers through EmuChatGeneration(mesh=(1, 2)), bf16
     and int4 with the W8A8 tower, on two images, logits within phase 6's
     limits and 8 greedy tokens, and load_emu2_checkpoint(mesh=) of the
     same tree equal to the sharded chat's leaves, with each load's peak
     memory; (b) Emu1 cut to 2
     layers through Trainer(mesh=) at (2, 1) and (1, 2), 3 losses and the
     first step's gradients within phase 11's limits, the factored leaves'
     parameter deltas within 0.25 of their norm; (c) ring attention over
     2 x 4096 tokens, 40 x 128 heads, causal, output and gradients
     against kernel A and the backward kernels
     on the whole sequence (phase 3's block rule), each rank's kernel and
     send times apart; (d) pipeline_llama_hidden, 4 LLaMA-13B-width layers
     in 2 stages, 4 microbatches, forward and one gradient; each part's
     launch counts on both ranks;
 21. the data pipeline into the encode (`emu_tpu_torch.data`): 64 seeded
     PNGs and one missing file:// URL through video2dataset (center crop
     to 224, webdataset shards of 16, two spawned processes), read back by
     get_video_dataset at batch 8, each batch moved to the card,
     device_preprocessed and encoded by the full-depth Emu1 ViT-g: every
     URL accounted for, batches bit for bit the PIL decode of their tar
     members, encodes finite and one the same bits twice, kernel A, B and
     H launches as the tower's structure gives them, samples/s written and
     images/s loaded, moved and encoded, within 30 s.
The line before the last is the kernels' JSON summary (with each kernel's
bound and the time of its PyTorch yardstick: one call computing the same
function where there is one, for B the chain of calls that computes it,
for E torch._int_mm of its two products alone); the last line is {"ok": true, "device": {...}}. Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 1234
MAX_NEW = 32
# H100 SXM data-sheet peaks for the bound: HBM bytes/s, dense ops/s
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# training phases: the LLaMA-13B path's attention and norm shapes
TRAIN_B, TRAIN_S, TRAIN_LR = 2, 1024, 5e-3
# image generation: denoise steps of every pipeline request and of the
# request served over HTTP
GEN_STEPS, HTTP_GEN_STEPS = 50, 50
# end-to-end figures of this run, filled by the phases and printed together
# at the end beside the previous version's runs (PERF.md section 5: the
# working-tree and `git archive` runs after kernel B's and E's redesign;
# one figure where only one run recorded it, and the version before theirs
# where neither did)
E2E: dict = {}
EARLIER_E2E = {
    "emu2 1 image + question, beam 5 prefill ms": (108.23, 108.23),
    "emu2 1 image + question, beam 5 decode ms/step": (35.89, 52.92),
    "emu1 caption beam5 encode ms": (73.54, 77.05),
    "emu1 caption beam5 prefill ms": (39.10, 39.10),
    "emu1 caption beam5 decode ms/step": (39.31, 39.31),
    "served mix int8 KV tok/s": (22.94, 33.42),
    "engine decode step alone ms": (34.72, 47.48),
    "engine decode step kernel ms": (20.41, 20.48),
    "train ms/step": (1310.72, 1943.44),
    "SDXL UNet ms/step": (102.35, 124.71),
    "SDXL UNet profiled kernel ms": (69.42, 69.42),
    "SDXL UNet kernel H ms": (19.94, 19.94),
    "SD1.5 UNet ms/step": (46.00, 46.00),
    "SD1.5 UNet profiled kernel ms": (20.05, 20.05),
    "SwiGLU ViT img/s": (554.74, 857.26),
}


def bound(nbytes: float, ops: float, kind: str = "bf16"):
    """(least ms the card could take, "bytes" or "operations")."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def print_resources(log: str, lib) -> None:
    """Registers, shared memory and spills of the kernels redesigned for
    Hopper (A's forward, the W4A8 GEMM of F, batched_mha at each padded
    width, C's row kernel for bf16 and fp32 weights and its backward's at
    2048 x 5120 (five vectors a thread, the ring), the attention
    backward's dQ and dK/dV kernels at each padded width, H's TMA GEMM
    and B's two activation forms of it (GELU, SwiGLU), E's W8A8 GEMM (fc2,
    fc1), D's split row kernel (one query head a kv head) and split mma
    kernel (D 128) in bf16 and int8, dense and paged, G's decode plan at <= 8 rows, its
    dynamic shared memory at LLaMA-33B's widths):
    `cuobjdump
    --dump-resource-usage` on the built library (REG per thread, STACK
    bytes, where spills land, static SHARED), ptxas's spill stores/loads
    from the build log when this run built the library, and each kernel's
    dynamic shared memory from its own plan. With setmaxnreg (F, E, dK/dV)
    REG is the launch's allocation; the transform or producer warps then
    hand some to the consumers."""
    import re
    from emu_tpu_torch.ops import _cuda
    from emu_tpu_torch.ops import decode_attention as D
    from emu_tpu_torch.ops import fused_norm as C
    from emu_tpu_torch.ops import q4_matmul as Q4
    # the host's copies of the split designs' shared-memory formulas (the
    # plans size their grids with them) against the library's
    plan = Q4.decode_plan(5, 6656, 17920, 128, 128, 256)
    for name, p in (("gate_up", (1, 256, plan["gate_up"]["kmax"], 512)),
                    ("down", (1, 128, plan["down"]["kmax"], 256))):
        if lib.emu_wd_smem(*p) != plan[name]["smem"]:
            raise AssertionError(f"G's {name} shared memory: the plan's "
                                 f"{plan[name]['smem']} != the library's "
                                 f"{lib.emu_wd_smem(*p)}")
    for size in (1, 2):
        if lib.emu_decode_split_smem(1, 128, size) != D._rows_smem(128, size):
            raise AssertionError("D's row kernel shared memory: the plan's "
                                 "formula differs from the library's")
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "--dump-resource-usage",
                          str(_cuda.library_path())], capture_output=True,
                         text=True, check=True).stdout
    spills, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for ([A-Za-z0-9_]+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spills[cur] = f"{m.group(1)}/{m.group(2)} bytes spill stores/loads"
    dyn = {"attention_kernelILi64ELi128": lib.emu_attention_smem(64),
           "attention_kernelILi128ELi64": lib.emu_attention_smem(128),
           "w4a8_gemm_kernelILi1E": lib.emu_w4a8_smem(1),
           "w4a8_gemm_kernelILi2E": lib.emu_w4a8_smem(2),
           **{f"batched_mha_kernelILi{dp}E": lib.emu_batched_mha_smem(dp)
              for dp in (64, 128, 192, 256)},
           "add_rmsnorm_rows_kernelI13__nv_bfloat16E": 0,
           "add_rmsnorm_rows_kernelIfE": 0,
           **{f"add_rmsnorm_bwd_rows_kernelI{t}Li5EE":
              C.norm_bwd_plan(2048, 5120)["smem"]
              for t in ("13__nv_bfloat16", "f")},
           **{f"{kind}_kernelILi{dp}E": lib.emu_attention_bwd_smem(
               int(kind == "dkv"), dp) for kind in ("dq", "dkv")
              for dp in (64, 128)},
           **{f"dense_tma_kernelILi{epi}E": lib.emu_fused_dense_smem()
              for epi in (0, 1, 2)},
           **{f"w8a8_gemm_kernelILb{fc1}E": lib.emu_w8a8_smem()
              for fc1 in (0, 1)},
           **{f"decode_split_rows_kernelI{t}Li1E":
              lib.emu_decode_split_smem(1, 128, size)
              for t, size in (("13__nv_bfloat16", 2), ("a", 1))},
           **{f"decode_split_mma_kernelI{t}Li128ELb{paged}E":
              lib.emu_decode_split_smem(0, 128, size)
              for t, size in (("13__nv_bfloat16", 2), ("a", 1))
              for paged in (0, 1)},
           "w4a8_decode_kernelILi1ELi8ELb1E": plan["gate_up"]["smem"],
           "w4a8_decode_kernelILi1ELi4ELb0E": plan["down"]["smem"]}
    seen, name = set(), None
    for line in out.splitlines():   # "Function <name>:" then its REG line
        m = re.search(r"Function ([A-Za-z0-9_]+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                      line)
        key = m and name and next((k for k in dyn if k in name), None)
        if not key:
            continue
        seen.add(key)
        print(f"  resources {key}: {m.group(1)} registers, {m.group(3)} + "
              f"{dyn[key]} bytes shared (static + dynamic), stack "
              f"{m.group(2)} B, local {m.group(4)} B; "
              f"{spills.get(name, 'ptxas: library built before this run')}")
    if seen != set(dyn):
        raise AssertionError(f"resources: cuobjdump lists {sorted(seen)}")


def mlp_chain(x, w1, b1, w2, b2, w3=None, b3=None, ln_scale=None,
              ln_bias=None, *, activation="gelu", ln_mode=None,
              residual=False, eps=1e-6):
    """Kernel B's function as a chain of PyTorch calls (F.layer_norm,
    torch.addmm, F.gelu or silu times up, torch.addmm, the residual add),
    in the input's dtype: B's yardstick, since no single PyTorch call
    computes it. The port never calls it."""
    import torch
    import torch.nn.functional as F
    k = x.shape[-1]
    xf = x.reshape(-1, k)
    xn = (F.layer_norm(xf, (k,), ln_scale, ln_bias, eps) if ln_mode == "pre"
          else xf)
    if activation == "swiglu":
        h = F.silu(torch.addmm(b1, xn, w1)) * torch.addmm(b2, xn, w2)
        y = torch.addmm(b3, h, w3)
    else:
        y = torch.addmm(b2, F.gelu(torch.addmm(b1, xn, w1)), w2)
    if ln_mode == "post":
        y = F.layer_norm(y, (y.shape[-1],), ln_scale, ln_bias, eps)
    if residual:
        y = y + xf
    return y.reshape(*x.shape[:-1], -1)


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


def device_ms(fn, iters: int = 10, tries: int = 3):
    """The card's kernel time of one call of fn (every kernel it launches,
    summed by torch.profiler), without the host's share; None when no try
    recorded a kernel (the trace lost its events: it happens, rarely)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(tries):
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    return None


def device_split(fn, iters: int = 5) -> dict:
    """The card's time of one call of fn by kernel name, in ms
    (torch.profiler); empty when the trace lost its events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            split[e.name] = split.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
    return split


def print_split(label: str, fn, card: str) -> None:
    split = device_split(fn)
    shown = "; ".join(
        f"{name.replace('void ', '').replace('(anonymous namespace)::', '')[:48]}"
        f" {ms:.4f}" for name, ms in sorted(split.items(),
                                            key=lambda kv: -kv[1]))
    print(f"  {label}, card ms by kernel: {shown or 'not measured'}  "
          f"[{card}]")


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


# A backward output's magnitude falls off along the sequence under a causal
# mask (the first query rows and keys carry the largest gradients), so one
# limit scaled by max|ref| would let a wrong block of later rows pass. Each
# block of BWD_BLOCK rows is held to its own size instead.
BWD_REL, BWD_BLOCK = 1e-2, 64


def compare_blocks(name: str, got, ref, rel: float = BWD_REL,
                   block: int = BWD_BLOCK) -> dict:
    """Every block of `block` rows (dim -2: query rows of dQ, key rows of
    dK/dV, token rows of dx; a vector is one row) of every leading index:
    ||got - ref||_F <= rel * ||ref||_F + 1e-6 * sqrt(n) over the block, so a
    block whose reference is zero (rows that see no key, masked keys) must
    come out zero. Raises if any block is above; returns max |got - ref|."""
    import torch
    import torch.nn.functional as F
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    if got.dim() == 1:
        got, ref = got[None], ref[None]
    pad = (-got.shape[-2]) % block

    def blocks(t):
        t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(*t.shape[:-2], -1, block * t.shape[-1])

    diff, size = blocks(got - ref), blocks(ref)
    err_f = torch.linalg.vector_norm(diff, dim=-1)
    ref_f = torch.linalg.vector_norm(size, dim=-1)
    worst = float((err_f / (rel * ref_f + 1e-6 * size.shape[-1] ** 0.5))
                  .max())
    err = float((got - ref).abs().max())
    print(f"  {name}: max_abs_err={err:.6g}; per {block}-row block "
          f"||err||_F <= {rel} ||ref||_F + 1e-6 sqrt(n): worst block at "
          f"{worst:.4g} of its limit, median block ||err||/||ref|| "
          f"{float((err_f / ref_f.clamp_min(1e-30)).median()):.4g}")
    if not worst <= 1.0:
        raise AssertionError(f"{name}: a {block}-row block is {worst} times "
                             "its limit")
    return {"max_abs_err": err}


def check_kernels(card: str) -> dict:
    """Phase 3: every kernel against its twin at the paths' shapes, each
    with its bound and, where one exists, one PyTorch call computing the
    same function (timed as a yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from emu_tpu_torch.ops import _cuda
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

    def run(name, kernel, twin, atol, rtol, nbytes, ops, kind="bf16",
            library=None, view=None):
        """atol and rtol None: the backward's blocked limit
        (`compare_blocks`)."""
        got, ref = kernel(), twin()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if view is not None:       # what is compared (e.g. defined rows)
            got, ref = view(got), view(ref)
        res = {"max_abs_err": 0.0}
        for i, (a, b) in enumerate(zip(got, ref)):
            r = (compare_blocks(f"{name}[{i}]", a, b) if atol is None
                 else compare(f"{name}[{i}]", a, b, atol, rtol))
            res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
        res["ms"], res["plain_ms"] = cuda_ms(kernel), cuda_ms(twin)
        res["bound_ms"], res["bound_by"] = bound(nbytes, ops, kind)
        res["library_ms"] = None if library is None else cuda_ms(library)
        lib = ("none" if library is None
               else f"{res['library_ms']:.4f} ms")
        # the card's time alone beside the events: at small shapes the
        # events time the wrapper's host work
        res["device_ms"] = device_ms(kernel)
        dev = (", device not measured" if res["device_ms"] is None
               else f", device {res['device_ms']:.4f} ms")
        print(f"  {name}: kernel {res['ms']:.4f} ms{dev}, plain "
              f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), library {lib}  [{card}]")
        results[name] = res

    def attn_cost(b, h, sq, skv, d, pairs=None):
        """bytes of q, k, v, out (bf16); ops of QK^T and PV over `pairs`
        (query, key) pairs per head."""
        pairs = sq * skv if pairs is None else pairs
        return 2 * (2 * b * h * sq * d + 2 * b * h * skv * d), \
            4 * b * h * pairs * d

    # A1: ViT-g self-attention, batch 8, q/v biases, ragged S = 257
    q, k, v = (randn(8, 257, 16, 88).transpose(1, 2) for _ in range(3))
    qb, vb = randn(16, 88, std=0.5), randn(16, 88, std=0.5)
    run("attention_vit_8x16x257x88", lambda: A.mha_bhsd(q, k, v, qb, vb,
                                                        scale=88 ** -0.5),
        lambda: A.attention_reference(q, k, v, qb, vb, scale=88 ** -0.5),
        1e-2, 1e-2, *attn_cost(8, 16, 257, 257, 88),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=88 ** -0.5))
    # A2: LLaMA-13B prefill, causal, left-padded kv_valid
    s = 80
    q, k, v = (randn(8, 40, s, 128) for _ in range(3))
    pads = torch.arange(8, device=dev) * 5
    valid = torch.arange(s, device=dev)[None, :] >= pads[:, None]
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    amask = causal[None, None] & valid[:, None, None, :]
    run("attention_causal_8x40x80x128",
        lambda: A.attention(q, k, v, kv_valid=valid, scale=128 ** -0.5,
                            causal=True),
        lambda: A.attention_reference(q, k, v, kv_valid=valid,
                                      scale=128 ** -0.5, causal=True),
        1e-2, 1e-2, *attn_cost(8, 40, s, s, 128, pairs=s * (s + 1) // 2),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=amask, scale=128 ** -0.5))

    # A3: Emu2-Chat's LLaMA-33B prefill as phase 7 runs it: one row of 330
    # tokens, 52 heads of 128, causal, kv_valid all set
    s = 330
    q, k, v = (randn(1, 52, s, 128) for _ in range(3))
    valid = torch.ones(1, s, dtype=torch.bool, device=dev)
    amask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    run("attention_causal_1x52x330x128",
        lambda: A.attention(q, k, v, kv_valid=valid, scale=128 ** -0.5,
                            causal=True),
        lambda: A.attention_reference(q, k, v, kv_valid=valid,
                                      scale=128 ** -0.5, causal=True),
        1e-2, 1e-2, *attn_cost(1, 52, s, s, 128, pairs=s * (s + 1) // 2),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=amask, scale=128 ** -0.5))

    def mlp_cost(m, k, f, n, wbytes=2.0):
        return (2 * m * k + wbytes * (k * f + f * n) + 2 * (f + n + 2 * k)
                + 2 * m * n), 2 * m * k * f + 2 * m * f * n

    def same_bits(name, fn):
        """No kernel here sums with atomics (D's split merges, G's cluster
        sums, B's and E's products add in a fixed order): a second run
        gives the same bits."""
        if not torch.equal(fn(), fn()):
            raise AssertionError(f"{name}: two runs gave different bits")

    # B: ViT-g MLP branch, M = 8 * 257 rows, 1408 -> 6144 -> 1408; one
    # image (257 rows); batch 32 (phase 17's 8224 rows). Library: the
    # chain of PyTorch calls that computes the same function (no single
    # call does), timed as one call site
    x = randn(32, 257, 1408)
    w1, w2 = randn(1408, 6144, std=0.02), randn(6144, 1408, std=0.02)
    b1, b2 = randn(6144, std=0.1), randn(1408, std=0.1)
    lns, lnb = 1 + randn(1408, std=0.1), randn(1408, std=0.1)
    kw = dict(ln_scale=lns, ln_bias=lnb, ln_mode="pre", residual=True)
    for xm in (x[:8], x[:1], x):
        m = xm.shape[0] * 257
        run(f"fused_mlp_{m}x1408x6144",
            lambda: B.fused_mlp(xm, w1, b1, w2, b2, **kw),
            lambda: B.fused_mlp_reference(xm, w1, b1, w2, b2, **kw),
            2e-2, 2e-2, *mlp_cost(m, 1408, 6144, 1408),
            library=lambda: mlp_chain(xm, w1, b1, w2, b2, **kw))
        same_bits(f"fused_mlp at M = {m}",
                  lambda: B.fused_mlp(xm, w1, b1, w2, b2, **kw))
    print("  fused_mlp: two runs give the same bits at M = 2056, 257, 8224")
    print_split("fused_mlp at M = 2056", lambda: B.fused_mlp(
        x[:8], w1, b1, w2, b2, **kw), card)
    del x

    def norm_cost(rows, w, add, wbytes=2):
        return (2 * rows * w * (4 if add else 2) + wbytes * w
                + 4 * rows), 4 * rows * w

    def norm_y_exact(w, xr, rr):
        """y = x + r of the add form, the same bits as the plain add."""
        if not torch.equal(C.rmsnorm_fwd(w, xr, rr)[0], xr + rr):
            raise AssertionError(f"add_rmsnorm {tuple(xr.shape)}: y differs "
                                 "from x + r")

    # C: the norm without add (library: F.rms_norm) and add_rmsnorm, over
    # prefill rows (8 * 80) and decode rows (8), W = 5120; then the add form
    # with an fp32 weight, read as it is stored
    w = 1 + randn(5120, std=0.1)
    for rows in (640, 8):
        xr, rr = randn(rows, 5120), randn(rows, 5120)
        run(f"rms_norm_{rows}x5120", lambda: C.rms_norm_fused(w, xr),
            lambda: C.rmsnorm_reference(w, xr)[1], 1e-2, 1e-2,
            *norm_cost(rows, 5120, False),
            library=lambda: F.rms_norm(xr, (5120,), w, eps=1e-6))
        run(f"add_rmsnorm_{rows}x5120",
            lambda: C.rmsnorm_fwd(w, xr, rr)[:2],
            lambda: C.rmsnorm_reference(w, xr, rr)[:2], 1e-2, 1e-2,
            *norm_cost(rows, 5120, True))
        norm_y_exact(w, xr, rr)
    w32 = 1 + torch.randn(5120, device=dev, generator=g) * 0.1
    xr, rr = randn(640, 5120), randn(640, 5120)
    run("add_rmsnorm_640x5120_w_fp32", lambda: C.rmsnorm_fwd(w32, xr, rr)[:2],
        lambda: C.rmsnorm_reference(w32, xr, rr)[:2], 1e-2, 1e-2,
        *norm_cost(640, 5120, True, 4))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run_d(name, kernel, twin, cost, library=None,
              wrapper=D.decode_attention):
        """Kernel D at one shape: against its twin, the same bits twice,
        and the plan decode_plan gave the launch (counted in `wrapper`'s
        plans). Returns the plan."""
        run(name, kernel, twin, 1e-2, 1e-2, *cost, library=library)
        same_bits(name, kernel)
        before = dict(wrapper.plans)
        kernel()
        plan = {k: v - before[k] for k, v in wrapper.plans.items()
                if v != before[k]}
        print(f"  {name}: the same bits twice; plan {plan}")
        return plan

    def decode_cost(b, h, hkv, d, lens, qn=1, itemsize=2, extra=True,
                    scales=False):
        """bytes: q, the VALID cache rows of the layer (this run's data),
        their scales, the extra chunk, the mask and out; ops: QK^T and PV
        over each query's visible columns."""
        n_valid = int(lens.sum())
        kv = 2 * n_valid * hkv * d * itemsize + (8 * n_valid * hkv
                                                 if scales else 0)
        ex = 2 * 2 * b * hkv * qn * d if extra else 0
        nbytes = 4 * b * qn * h * d + kv + ex + b * int(lens.max())
        tri = qn * (qn + 1) // 2 if extra else 0
        ops = 4 * d * h * (qn * n_valid + b * tri)
        return nbytes, ops

    def sdpa_mask(valid, qn=1, extra=True):
        """Boolean SDPA mask [B, 1, qn, S (+ qn)] of kernel D's columns."""
        m = valid[:, None, None, :].expand(-1, 1, qn, -1)
        if not extra:
            return m
        tri = torch.ones(qn, qn, dtype=torch.bool, device=dev).tril()
        return torch.cat([m, tri[None, None].expand(m.shape[0], 1, qn, qn)],
                         -1)

    # D: decode against a stacked 2-layer cache, ragged kv_valid, extra column
    for b in (8, 5):
        kc, vc = randn(2, b, 40, 256, 128), randn(2, b, 40, 256, 128)
        qd = randn(b, 1, 40, 128)
        kn, vn = randn(b, 40, 1, 128), randn(b, 40, 1, 128)
        lens = 100 + 19 * torch.arange(b, device=dev)
        valid = torch.arange(256, device=dev)[None, :] < lens[:, None]
        dkw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
        kcat = torch.cat([kc[1], kn], 2)
        vcat = torch.cat([vc[1], vn], 2)
        qt, m = qd.transpose(1, 2), sdpa_mask(valid)
        run_d(f"decode_attention_b{b}_40x256x128",
              lambda: D.decode_attention(qd, kc, vc, valid, **dkw),
              lambda: D.decode_attention_reference(qd, kc, vc, valid, **dkw),
              decode_cost(b, 40, 40, 128, lens),
              library=lambda: F.scaled_dot_product_attention(
                  qt, kcat, vcat, attn_mask=m, scale=128 ** -0.5))

    # --- the Emu2-Chat int4 path's shapes ---------------------------------
    # A: EVA-4B self-attention, one 448-px image, q/v biases, D = 112
    q, k, v = (randn(1, 1025, 16, 112).transpose(1, 2) for _ in range(3))
    qb, vb = randn(16, 112, std=0.5), randn(16, 112, std=0.5)
    run("attention_vit_1x16x1025x112",
        lambda: A.mha_bhsd(q, k, v, qb, vb, scale=112 ** -0.5),
        lambda: A.attention_reference(q, k, v, qb, vb, scale=112 ** -0.5),
        1e-2, 1e-2, *attn_cost(1, 16, 1025, 1025, 112),
        library=lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=112 ** -0.5))
    # C: LLaMA-33B norms, prefill and beam-decode rows, W = 6656
    w = 1 + randn(6656, std=0.1)
    for rows in (330, 5):
        xr, rr = randn(rows, 6656), randn(rows, 6656)
        run(f"add_rmsnorm_{rows}x6656", lambda: C.rmsnorm_fwd(w, xr, rr)[:2],
            lambda: C.rmsnorm_reference(w, xr, rr)[:2], 1e-2, 1e-2,
            *norm_cost(rows, 6656, True))
        norm_y_exact(w, xr, rr)
    # D: 5 beams, 52 heads of 128, a 384-slot stacked cache
    kc, vc = randn(2, 5, 52, 384, 128), randn(2, 5, 52, 384, 128)
    qd = randn(5, 1, 52, 128)
    kn, vn = randn(5, 52, 1, 128), randn(5, 52, 1, 128)
    lens = torch.full((5,), 330, device=dev)
    valid = (torch.arange(384, device=dev)[None, :] < 330).expand(5, 384)
    valid = valid.contiguous()
    dkw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
    kcat, vcat = torch.cat([kc[1], kn], 2), torch.cat([vc[1], vn], 2)
    qt, m = qd.transpose(1, 2), sdpa_mask(valid)
    run_d("decode_attention_b5_52x384x128",
          lambda: D.decode_attention(qd, kc, vc, valid, **dkw),
          lambda: D.decode_attention_reference(qd, kc, vc, valid, **dkw),
          decode_cost(5, 52, 52, 128, lens),
          library=lambda: F.scaled_dot_product_attention(
              qt, kcat, vcat, attn_mask=m, scale=128 ** -0.5))
    del kc, vc, kcat, vcat

    # --- kernel D's serving forms (continuous engine, speculative verify,
    # paged lane) at Emu2-Chat widths: 52 heads of 128, S = 1024 ----------
    S, H = 1024, 52
    lens8 = 600 + 50 * torch.arange(8, device=dev)
    valid8 = torch.arange(S, device=dev)[None, :] < lens8[:, None]

    def int8_planes(*shape):
        vals = torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)
        return vals, torch.rand(shape[:-1], device=dev, generator=g) * 0.02

    def chunk_extra(b, qn):
        """k_new/v_new as the decoder passes them: transposed views of the
        [B, qn, Hkv, D] projections."""
        return (randn(b, qn, H, 128).transpose(1, 2),
                randn(b, qn, H, 128).transpose(1, 2))

    # D-int8: the decode step over a stacked 60-layer int8 cache, layer 59
    shape = (60, 8, H, S, 128)
    kq = torch.zeros(shape, dtype=torch.int8, device=dev)
    vq = torch.zeros(shape, dtype=torch.int8, device=dev)
    ks = torch.zeros(shape[:-1], device=dev)
    vs = torch.zeros(shape[:-1], device=dev)
    kq[59], ks[59] = int8_planes(*shape[1:])
    vq[59], vs[59] = int8_planes(*shape[1:])
    qd = randn(8, 1, H, 128)
    kn, vn = chunk_extra(8, 1)
    dkw = dict(scale=128 ** -0.5, layer=59, k_new=kn, v_new=vn)
    run_d("decode_int8_b8_52x1024x128_l59",
          lambda: D.decode_attention(qd, kq, vq, valid8, ks, vs, **dkw),
          lambda: D.decode_attention_reference(qd, kq, vq, valid8, ks, vs,
                                               **dkw),
          decode_cost(8, H, H, 128, lens8, itemsize=1, scales=True))
    # ... and at the continuous engine's own occupancy: 8 rows of 16-264
    # tokens in its 1024-slot cache
    lens_e = torch.tensor([16, 40, 64, 100, 150, 200, 240, 264], device=dev)
    valid_e = torch.arange(S, device=dev)[None, :] < lens_e[:, None]
    run_d("decode_int8_engine_b8_52x1024x128",
          lambda: D.decode_attention(qd, kq, vq, valid_e, ks, vs, **dkw),
          lambda: D.decode_attention_reference(qd, kq, vq, valid_e, ks, vs,
                                               **dkw),
          decode_cost(8, H, H, 128, lens_e, itemsize=1, scales=True))
    # D-chunk int8: a 32-token mixed step at 8 rows, same cache
    qd = randn(8, 32, H, 128)
    kn, vn = chunk_extra(8, 32)
    dkw = dict(scale=128 ** -0.5, layer=59, k_new=kn, v_new=vn)
    run_d("decode_chunk_int8_b8_q32_52x1024x128",
          lambda: D.decode_attention(qd, kq, vq, valid8, ks, vs, **dkw),
          lambda: D.decode_attention_reference(qd, kq, vq, valid8, ks, vs,
                                               **dkw),
          decode_cost(8, H, H, 128, lens8, qn=32, itemsize=1, scales=True))
    del kq, vq, ks, vs
    # D-chunk bf16: a speculative verify (qn 5, B 1) and a mixed step (32)
    kc, vc = randn(2, 8, H, S, 128), randn(2, 8, H, S, 128)
    for b, qn in ((1, 5), (8, 32)):
        qd = randn(b, qn, H, 128)
        kn, vn = chunk_extra(b, qn)
        kcb, vcb, vb_ = kc[:, :b].contiguous(), vc[:, :b].contiguous(), \
            valid8[:b].contiguous()
        dkw = dict(scale=128 ** -0.5, layer=1, k_new=kn, v_new=vn)
        kcat = torch.cat([kcb[1], kn], 2)
        vcat = torch.cat([vcb[1], vn], 2)
        qt, m = qd.transpose(1, 2), sdpa_mask(vb_, qn)
        run_d(f"decode_chunk_bf16_b{b}_q{qn}_52x1024x128",
              lambda: D.decode_attention(qd, kcb, vcb, vb_, **dkw),
              lambda: D.decode_attention_reference(qd, kcb, vcb, vb_, **dkw),
              decode_cost(b, H, H, 128, lens8[:b], qn=qn),
              library=lambda: F.scaled_dot_product_attention(
                  qt, kcat, vcat, attn_mask=m, scale=128 ** -0.5))
    del kc, vc, kcb, vcb, kcat, vcat
    # D-paged: 8 rows of 64 pages of 16 through a shuffled table, bf16 and
    # int8 (scales already gathered to the logical view): the decode step
    # (Sq = 1) and the 32-query chunk form, the latter also against the
    # dense chunk form over the same logical cache, bit for bit. No one
    # PyTorch call reads a page pool: no library time
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
            qd = randn(8, qn, H, 128)
            kn, vn = chunk_extra(8, qn)
            pkw = dict(scale=128 ** -0.5, k_scale=pks, v_scale=pvs, layer=1,
                       k_new=kn, v_new=vn)
            name = (f"paged_{tag}_b8_52x1024x128_p16" if qn == 1 else
                    f"paged_chunk_{tag}_b8_q32_52x1024x128_p16")
            plan = run_d(
                name, lambda: D.paged_decode_attention(qd, kp, vp, table,
                                                       valid8, **pkw),
                lambda: D.paged_decode_attention_reference(qd, kp, vp, table,
                                                           valid8, **pkw),
                decode_cost(8, H, H, 128, lens8, qn=qn,
                            itemsize=1 if quant else 2, scales=quant),
                wrapper=D.paged_decode_attention)
            if plan != {"rows" if qn == 1 else "mma": 1}:
                raise AssertionError(f"{name}: took the plan {plan}")
        # the dense chunk form over the pages gathered to the logical cache
        kd, vd = (torch.stack([torch.zeros_like(D.gather_pages(t[1], table)),
                               D.gather_pages(t[1], table)]) for t in (kp, vp))
        paged = D.paged_decode_attention(qd, kp, vp, table, valid8, **pkw)
        dense = D.decode_attention(qd, kd, vd, valid8, pks, pvs, **{
            k: v for k, v in pkw.items() if k not in ("k_scale", "v_scale")})
        if not torch.equal(paged, dense):
            raise AssertionError(f"paged_chunk_{tag}: differs from the dense "
                                 "chunk form over the same logical cache")
        print(f"  paged_chunk_{tag}: the dense chunk form's bits over the "
              "same logical cache")
        del kp, vp, kd, vd
    torch.cuda.empty_cache()

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
            2e-2, 2e-2, *mlp_cost(m, 1792, 15360, 1792),
            library=lambda: mlp_chain(xm, w1, b1, w2, b2, **kw))
        same_bits(f"fused_mlp post at M = {m}",
                  lambda: B.fused_mlp(xm, w1, b1, w2, b2, **kw))
    # E: the W8A8 EVA-4B MLP branch at 2, 4 and 8 images (phase 7's
    # two-image and 8-frame requests), pre- and post-LN, hidden blocks of
    # 768. Library: torch._int_mm of its two products alone (int8 operands
    # of the same shapes, int32 out), no scale, activation or
    # requantization
    q1, q2 = Q.quantize_kernel(w1), Q.quantize_kernel(w2)
    wq = (q1["kernel_q8"], q1["scale"], b1, q2["kernel_q8"], q2["scale"], b2)
    x8 = randn(8, 1025, 1792)

    def int_mm_pair(m):
        xq = torch.randint(-127, 128, (m, 1792), device=dev, generator=g,
                           dtype=torch.int8)
        hq = torch.randint(-127, 128, (m, 15360), device=dev, generator=g,
                           dtype=torch.int8)
        return lambda: (torch._int_mm(xq, wq[0]), torch._int_mm(hq, wq[3]))

    for mode in ("post", "pre"):
        ekw = dict(kw, ln_mode=mode, bf=768)
        for images in (2, 4, 8):
            xm, m = x8[:images], 1025 * images
            nb, ops = mlp_cost(m, 1792, 15360, 1792, wbytes=1.0)
            run(f"fused_mlp_w8a8_{mode}_{m}x1792x15360",
                lambda: B.fused_mlp_w8a8(xm, *wq, **ekw),
                lambda: B.fused_mlp_w8a8_reference(xm, *wq, **ekw),
                2e-2, 2e-2, nb + 4 * (15360 + 1792), ops, "int8",
                library=int_mm_pair(m))
            same_bits(f"fused_mlp_w8a8 {mode} at M = {m}",
                      lambda: B.fused_mlp_w8a8(xm, *wq, **ekw))
    print_split("fused_mlp_w8a8 post at M = 4100", lambda: B.fused_mlp_w8a8(
        x8[:4], *wq, **dict(kw, ln_mode="post", bf=768)), card)
    plan = B.w8a8_plan(8200, 1792, 15360, 1792, 768)
    print("  fused_mlp_w8a8: two runs give the same bits at M = 2050, 4100, "
          f"8200; fc1's wave: {_cuda.library().emu_w8a8_fc1_clusters(plan['cluster'])}"
          f" clusters of {plan['cluster']} blocks  [{card}]")
    del w1, w2, q1, q2, wq, x8
    # F: int4 projections of LLaMA-33B: qkv and the lm_head (ragged N) at 5
    # beam rows; gate_up at a 330-token prefill, the engine's 32-row chunk,
    # 17 rows and q4_plan's 1024-row edge; library: torch.matmul on the
    # weight dequantized to bf16 beforehand
    for k, n, tag, rows in ((6656, 19968, "qkv", (5,)),
                            (6656, 32274, "lm_head", (5,)),
                            (6656, 35840, "gate_up", (330, 17, 32, 1024))):
        p = Q.quantize_kernel_int4(randn(k, n, std=0.02))
        wd = Q.dequantize_int4(p, bf)
        for m in rows:
            xm = randn(m, k)
            run(f"matmul_q4_{tag}_{m}x{k}x{n}",
                lambda: Q4.matmul_q4(xm, p["kernel_q4"], p["scale4"]),
                lambda: Q4.matmul_q4_reference(xm, p["kernel_q4"],
                                               p["scale4"]),
                1e-2, 1e-2,
                2 * m * k + k * n / 2 + 4 * (k // 128) * n + 2 * m * n,
                2 * m * k * n, "int8", library=lambda: torch.matmul(xm, wd))
            if not torch.equal(Q4.matmul_q4(xm, p["kernel_q4"], p["scale4"]),
                               Q4.matmul_q4(xm, p["kernel_q4"], p["scale4"])):
                raise AssertionError(f"matmul_q4 at {m} rows: two runs gave "
                                     "different bits")
        print(f"  matmul_q4: two runs give the same bits at M = {rows}")
        del p, wd
    # G: the int4 decode MLP of LLaMA-33B, D = 6656, F = 17920 (block 256)
    gu = Q.quantize_kernel_int4(randn(6656, 35840, std=0.02))
    dn = Q.quantize_kernel_int4(randn(17920, 6656, std=0.02))
    gargs = (gu["kernel_q4"], gu["scale4"], dn["kernel_q4"], dn["scale4"])
    for m in (1, 5, 8):   # 8: the continuous engine's slots
        xm, wr = randn(m, 6656), 1 + randn(6656, std=0.1)
        nb = (4 * m * 6656 + 2 * 6656 + 6656 * 35840 / 2
              + 4 * 52 * 35840 + 17920 * 6656 / 2 + 4 * 140 * 6656)
        run(f"fused_swiglu_q4_{m}x6656x17920",
            lambda: Q4.fused_swiglu_q4(xm, wr, *gargs),
            lambda: Q4.fused_swiglu_q4_reference(xm, wr, *gargs),
            2e-2, 2e-2, nb, 2 * m * 6656 * 35840 + 2 * m * 17920 * 6656,
            "int8")
        same_bits(f"fused_swiglu_q4 at {m} rows",
                  lambda: Q4.fused_swiglu_q4(xm, wr, *gargs))
        plan = Q4.decode_plan(m, 6656, 17920, 128, 128, 256, sms)
        shown = ", ".join(
            f"{k}: {p['blocks'] // p['ks']} clusters of {p['ks']} "
            f"({p['blocks_per_sm']} blocks an SM)"
            for k, p in ((k, plan[k]) for k in ("gate_up", "down")))
        print(f"  fused_swiglu_q4 at {m} rows: the same bits twice; plan "
              f"{shown}")
    del gu, dn, gargs
    torch.cuda.empty_cache()
    check_training_kernels(run, randn, attn_cost, results)
    check_diffusion_kernels(run, randn, attn_cost, results)
    check_dense_and_vit_kernels(run, randn, attn_cost, mlp_cost, results,
                                card)
    check_clip_kernels(run, randn, attn_cost)
    return results


# phase 19's attention shapes on kernel A: CLIP's causal text tower (32
# prompts of 77 tokens, 12 heads of 64) and the attentional pooler's 256
# queries against 257 ViT tokens (batch 8, 8 heads of 96)
CLIP_CAUSAL = (32, 77, 12, 64)
POOLER_CROSS = (8, 256, 8, 96, 257)


def check_clip_kernels(run, randn, attn_cost) -> None:
    """Phase 3, the CLIP and pooler paths' kernel A shapes (their dense
    shapes are in DENSE_PLAIN, the vision tower's batched_mha at 32 x 257 x
    16 x 64 in ROUTE_SHAPES), each against the plain chain its fp32 route
    runs, SDPA beside it; the route each shape takes is printed. Limit:
    1e-2 + 1e-2 * max|ref|."""
    import torch.nn.functional as F
    from emu_tpu_torch.ops import attention as att
    from emu_tpu_torch.ops import flash_attention as A

    b, s, h, d = CLIP_CAUSAL
    q, k, v = randn(b, s, 3, h, d).unbind(2)
    sc = d ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    run(f"attention_causal_{b}x{h}x{s}x{d}",
        lambda: A.flash_attention(q, k, v, scale=sc, causal=True),
        lambda: att.grouped_attention(q, k, v, scale=sc, causal=True),
        1e-2, 1e-2, *attn_cost(b, h, s, s, d, pairs=s * (s + 1) // 2),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=sc,
                                                       is_causal=True))
    print(f"  CLIP text tower {b}x{s}x{h}x{d} causal: the route takes "
          f"{att.attention_route(q, k, v, causal=True)}")
    b, sq, h, d, skv = POOLER_CROSS
    q = randn(b, sq, h, d)
    k, v = randn(b, skv, 2, h, d).unbind(2)
    sc = d ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    run(f"cross_{b}x{sq}x{h}x{d}_kv{skv}",
        lambda: A.flash_attention(q, k, v, scale=sc),
        lambda: att.grouped_attention(q, k, v, scale=sc), 1e-2, 1e-2,
        *attn_cost(b, h, sq, skv, d),
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=sc))
    print(f"  attentional pooler {b}x{sq}x{h}x{d} against {skv} keys: the "
          f"route takes {att.attention_route(q, k, v)}")


# the UNets' latent self-attention shapes at batch 2 (CFG): SDXL at 1024²
# (its 32² level), SD1.5 at 512² (its 32², 16² and 8² levels), and a ragged
# S at the widest head batched_mha takes
MHA_SHAPES = [(2, 1024, 20, 64), (2, 1024, 8, 80), (2, 256, 8, 160),
              (2, 64, 8, 160), (2, 257, 8, 256)]
# every self-attention shape on a path that both batched_mha and kernel A
# (D <= 128) take: the UNets' 1024- and 4096-token levels (SDXL's and
# SD1.5's 64² levels) and the SwiGLU ViT's 257 tokens at batch 32; each
# goes to the kernel measured faster
ROUTE_SHAPES = [(2, 1024, 20, 64), (2, 1024, 8, 80), (32, 257, 16, 64),
                (2, 4096, 10, 64), (2, 4096, 8, 40)]
# the UNets' cross-attention: latent queries against the 64 (Emu2-Gen) or
# 32 (Emu1) conditioning embeddings, at the head widths kernel A takes
CROSS_SHAPES = [(2, 4096, 10, 64, 64), (2, 1024, 20, 64, 64),
                (2, 4096, 8, 40, 32), (2, 1024, 8, 80, 32)]


def check_diffusion_kernels(run, randn, attn_cost, results) -> None:
    """Phase 3, the image-generation path's attention: batched_mha at the
    UNets' self-attention shapes (token-major views of one [B, S, 3, H, D]
    projection, as the UNet reads them); batched_mha against kernel A
    non-causal at every self-attention shape both take (ROUTE_SHAPES), the
    measurement behind `attention_route`'s MHA_MIN_S / MHA_MAX_S; and
    kernel A against the plain chain at the
    cross-attention shapes, the measurement behind sending that attention
    to kernel A. Limit: 1e-2 + 1e-2 * max|ref|."""
    import torch
    import torch.nn.functional as F
    from emu_tpu_torch.ops import attention as att
    from emu_tpu_torch.ops import flash_attention as A

    def sdpa(q, k, v, scale):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    for b, s, h, d in MHA_SHAPES + [x for x in ROUTE_SHAPES
                                    if x not in MHA_SHAPES]:
        q, k, v = randn(b, s, 3, h, d).unbind(2)
        sc = d ** -0.5
        run(f"batched_mha_{b}x{s}x{h}x{d}",
            lambda: A.batched_mha(q, k, v, scale=sc),
            lambda: A.batched_mha_reference(q, k, v, scale=sc), 1e-2, 1e-2,
            *attn_cost(b, h, s, s, d), library=sdpa(q, k, v, sc))
    for b, s, h, d in ROUTE_SHAPES:
        q, k, v = randn(b, s, 3, h, d).unbind(2)
        sc = d ** -0.5
        run(f"attention_noncausal_{b}x{s}x{h}x{d}",
            lambda: A.flash_attention(q, k, v, scale=sc),
            lambda: A.batched_mha_reference(q, k, v, scale=sc), 1e-2, 1e-2,
            *attn_cost(b, h, s, s, d), library=sdpa(q, k, v, sc))
    print(f"  self-attention route (MHA_MIN_S, MHA_MAX_S = {att.MHA_MIN_S}, "
          f"{att.MHA_MAX_S}), by the card's time:")
    for b, s, h, d in ROUTE_SHAPES:
        m = results[f"batched_mha_{b}x{s}x{h}x{d}"]
        a = results[f"attention_noncausal_{b}x{s}x{h}x{d}"]
        # the card's times, or the events' where a trace was lost
        key = ("device_ms" if None not in (m["device_ms"], a["device_ms"])
               else "ms")
        faster = "batched_mha" if m[key] < a[key] else "flash"
        q = torch.empty(b, s, h, d, device="meta", dtype=torch.bfloat16)
        route = att.attention_route(q, q, q)
        dm, da = (("not measured" if x is None else f"{x:.4f}")
                  for x in (m["device_ms"], a["device_ms"]))
        print(f"    {b}x{s}x{h}x{d}: batched_mha {m['ms']:.4f} ms (device "
              f"{dm}), kernel A {a['ms']:.4f} ms (device {da}): {faster} is "
              f"faster by {key}; the route takes {route}"
              f"{'' if route == faster else ' (DIFFERS)'}")
    for b, sq, h, d, skv in CROSS_SHAPES:
        q = randn(b, sq, h, d)
        k, v = randn(b, skv, 2, h, d).unbind(2)
        sc = d ** -0.5
        name = f"cross_{b}x{sq}x{h}x{d}_kv{skv}"
        run(name, lambda: A.flash_attention(q, k, v, scale=sc),
            lambda: att.grouped_attention(q, k, v, scale=sc), 1e-2, 1e-2,
            *attn_cost(b, h, sq, skv, d), library=sdpa(q, k, v, sc))
        kern, plain = results[name]["ms"], results[name]["plain_ms"]
        print(f"  {name}: kernel A {kern:.4f} ms, plain chain {plain:.4f} ms: "
              f"{'kernel A' if kern < plain else 'the plain chain'} is faster"
              f" (the route: {att.attention_route(q, k, v)})")
    torch.cuda.empty_cache()


# kernel H's shapes (M, K, N): the plain form at the SDXL UNet's GEGLU
# proj_in and proj_out and its 64²-level to_out (CFG batch 2), the time
# embedding, ViT-g's attention proj (8 images), the short grids of the
# SD1.5 UNet's 8² level (its to_out and GEGLU proj_out) and of the Causal
# Former's projection (one image), CLIP's text fc1 (32 prompts of 77
# tokens) and ViT-L/14 fc1 (32 images); the pre form at the UNet block's
# norm3 + proj_in (64² level) and ViT-g's LN1 + qkv (32 images); the post
# form with the residual at EVA-4B's proj + LN + residual (8 images)
DENSE_PLAIN = [(2048, 1280, 10240), (2048, 5120, 1280), (8192, 640, 640),
               (2, 320, 1280), (2056, 1408, 1408), (128, 1280, 1280),
               (128, 5120, 1280), (32, 768, 5120), (2464, 768, 3072),
               (8224, 1024, 4096)]
DENSE_PRE = [(8192, 640, 5120), (8224, 1408, 4224)]
DENSE_POST = [(8200, 1792, 1792)]
# the shapes H's mma.sync plan takes: ViT-g's patch embedding (8 images of
# 256 patches, K = 14 * 14 * 3 = 588, not a multiple of 8)
DENSE_MMA = [(2048, 588, 1408)]
# kernel B's SwiGLU form at EVA02-CLIP-L's widths (1024 -> 2730 -> 1024),
# 8 and 32 images of 257 tokens
SWIGLU_ROWS = [257 * 8, 257 * 32]
# mha_packed_qkv at ViT-g (32 images) and EVA-4B (8 images)
PACKED_SHAPES = [(32, 257, 16, 88), (8, 1025, 16, 112)]


def check_dense_and_vit_kernels(run, randn, attn_cost, mlp_cost,
                                results, card: str) -> None:
    """Phase 3, the kernels ported last: H in its three forms (plain, pre,
    post + residual), each also timed against the fp32 route it replaces
    (`_matmul_f32` + bias, the plain form's twin), the same bits twice at
    every shape; H's mma.sync plan at the shapes it takes (the time
    embedding's 2 rows, the patch embedding); B's SwiGLU form; and
    `mha_packed_qkv` on the packed projection (B's library: the chain of
    PyTorch calls, `mlp_chain`). Limits: H plain and pre,
    mha_packed_qkv 1e-2 + 1e-2 * max|ref|; H post + residual and B SwiGLU
    2e-2 + 2e-2 * max|ref| (as B). Library: cuBLAS through torch.addmm
    (fp32 output where the installed torch takes out_dtype, else bf16: one
    rounding apart), SDPA for the attention."""
    import torch
    import torch.nn.functional as F
    from emu_tpu_torch.ops import flash_attention as A
    from emu_tpu_torch.ops import fused_mlp as B

    def addmm_fp32(b, x, w):
        return torch.addmm(b.float(), x, w, out_dtype=torch.float32)

    probe = randn(16, 16)
    try:
        addmm_fp32(probe[0], probe, probe)
        library, lib_note = addmm_fp32, "fp32 output (out_dtype)"
    except (TypeError, RuntimeError):
        library = lambda b, x, w: torch.addmm(b, x, w)        # noqa: E731
        lib_note = "bf16 output: one rounding apart from H"
    print(f"  H's library call: torch.addmm, {lib_note}")

    def dense_bytes(m, k, n, extra=0):
        return 2 * (m * k + k * n + m * n) + 4 * n + extra

    for m, k, n in DENSE_PLAIN:
        x, w, b = randn(m, k), randn(k, n, std=k ** -0.5), randn(n, std=0.5)
        run(f"fused_dense_{m}x{k}x{n}", lambda: B.fused_dense(x, w, b),
            lambda: B.fused_dense_reference(x, w, b), 1e-2, 1e-2,
            dense_bytes(m, k, n), 2 * m * k * n,
            library=lambda: library(b, x, w))
    for m, k, n in DENSE_PRE:
        x, w, b = randn(m, k), randn(k, n, std=k ** -0.5), randn(n, std=0.5)
        lns, lnb = 1 + randn(k, std=0.1), randn(k, std=0.1)
        kw = dict(ln_mode="pre", eps=1e-5)
        run(f"fused_dense_pre_{m}x{k}x{n}",
            lambda: B.fused_dense(x, w, b, lns, lnb, **kw),
            lambda: B.fused_dense_reference(x, w, b, lns, lnb, **kw),
            1e-2, 1e-2, dense_bytes(m, k, n, 8 * k), 2 * m * k * n)
    for m, k, n in DENSE_POST:
        x, w, b = randn(m, k), randn(k, n, std=k ** -0.5), randn(n, std=0.5)
        lns, lnb, res = 1 + randn(n, std=0.1), randn(n, std=0.1), randn(m, n)
        kw = dict(residual=res, ln_mode="post")
        run(f"fused_dense_post_{m}x{k}x{n}",
            lambda: B.fused_dense(x, w, b, lns, lnb, **kw),
            lambda: B.fused_dense_reference(x, w, b, lns, lnb, **kw),
            2e-2, 2e-2, dense_bytes(m, k, n, 8 * n + 2 * m * n),
            2 * m * k * n)
    for m, k, n in DENSE_MMA:
        x, w, b = randn(m, k), randn(k, n, std=k ** -0.5), randn(n, std=0.5)
        if B.fused_dense_plan(m, k, n, True) != "mma":
            raise AssertionError(f"fused_dense {m}x{k}x{n}: not the mma plan")
        run(f"fused_dense_mma_{m}x{k}x{n}", lambda: B.fused_dense(x, w, b),
            lambda: B.fused_dense_reference(x, w, b), 1e-2, 1e-2,
            dense_bytes(m, k, n), 2 * m * k * n,
            library=lambda: library(b, x, w))
    for name, r in results.items():
        if name.startswith("fused_dense_"):
            print(f"  {name}: H {r['ms']:.4f} ms against the fp32 route it "
                  f"replaces (x.float() @ w.float() + b, in the twin) "
                  f"{r['plain_ms']:.4f} ms: {r['plain_ms'] / r['ms']:.2f}x")
    # every shape: the same bits twice, and which plan it took
    for form, shapes in ((None, DENSE_PLAIN), ("pre", DENSE_PRE),
                         ("post", DENSE_POST)):
        for m, k, n in shapes:
            x, w, b = randn(m, k), randn(k, n, std=k ** -0.5), randn(n)
            dim = k if form == "pre" else n
            lns, lnb = ((1 + randn(dim, std=0.1), randn(dim, std=0.1))
                        if form else (None, None))
            res = randn(m, n) if form == "post" else None

            def h():
                return B.fused_dense(x, w, b, lns, lnb, res, ln_mode=form,
                                     eps=1e-5)
            if not torch.equal(h(), h()):
                raise AssertionError(f"fused_dense {form} {m}x{k}x{n}: two "
                                     "runs gave different bits")
            name = (f"fused_dense_{form + '_' if form else ''}"
                    f"{m}x{k}x{n}")
            r = results[name]
            print(f"  {name}: plan {B.fused_dense_plan(m, k, n, True)}, the "
                  f"same bits twice; {r['ms']:.4f} ms (device "
                  f"{r['device_ms']})  [{card}]")
    torch.cuda.empty_cache()

    k, f = 1024, 2730
    w1, w2 = randn(k, f, std=k ** -0.5), randn(k, f, std=k ** -0.5)
    w3 = randn(f, k, std=f ** -0.5)
    b1, b2, b3 = randn(f, std=0.1), randn(f, std=0.1), randn(k, std=0.1)
    lns, lnb = 1 + randn(k, std=0.1), randn(k, std=0.1)
    for mode in ("pre", "post"):
        for m in SWIGLU_ROWS:
            x = randn(m, k)
            kw = dict(activation="swiglu", ln_scale=lns, ln_bias=lnb,
                      ln_mode=mode, residual=True)
            nb, ops = mlp_cost(m, k, f, k)
            run(f"fused_mlp_swiglu_{mode}_{m}x{k}x{f}",
                lambda: B.fused_mlp(x, w1, b1, w2, b2, w3, b3, **kw),
                lambda: B.fused_mlp_reference(x, w1, b1, w2, b2, w3, b3,
                                              **kw),
                2e-2, 2e-2, nb + 2 * (k * f + f), ops + 2 * m * k * f,
                library=lambda: mlp_chain(x, w1, b1, w2, b2, w3, b3, **kw))
            if not torch.equal(B.fused_mlp(x, w1, b1, w2, b2, w3, b3, **kw),
                               B.fused_mlp(x, w1, b1, w2, b2, w3, b3, **kw)):
                raise AssertionError("fused_mlp swiglu: two runs gave "
                                     "different bits")
    print("  fused_mlp swiglu: two runs give the same bits at every row")
    del w1, w2, w3
    torch.cuda.empty_cache()

    for b, s, h, d in PACKED_SHAPES:
        qkv = randn(b, s, 3 * h * d)
        sc = d ** -0.5
        qt, kt, vt = (t.transpose(1, 2)
                      for t in qkv.view(b, s, 3, h, d).unbind(2))
        run(f"mha_packed_qkv_{b}x{s}x{h}x{d}",
            lambda: A.mha_packed_qkv(qkv, h, d, scale=sc),
            lambda: A.mha_packed_qkv_reference(qkv, h, d, scale=sc),
            1e-2, 1e-2, *attn_cost(b, h, s, s, d),
            library=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                           scale=sc))
    torch.cuda.empty_cache()


def check_training_kernels(run, randn, attn_cost, results) -> None:
    """Phase 3, the training path's kernels at its shapes (LLaMA-13B, 40
    heads of 128, 2 x 1024 tokens, causal, a left-padded row): kernel A
    with its lse, the dQ and dK/dV kernels (also GQA rep 2, and at 4096
    causal keys, the TPU's tiled backward tier), the norm backward at
    2048 x 5120 with and without the add (and with an fp32 w), and kernel A
    at Sq = Skv = 8192 (the TPU's streaming tier)."""
    import torch
    import torch.nn.functional as F
    from emu_tpu_torch.ops import flash_attention as A
    from emu_tpu_torch.ops import fused_norm as C
    from emu_tpu_torch.tools import bench_norm_bwd

    dev = torch.device("cuda")
    b, h, s, d = TRAIN_B, 40, TRAIN_S, 128
    scale = d ** -0.5
    pads = torch.tensor([0, 37], device=dev)
    valid = torch.arange(s, device=dev)[None] >= pads[:, None]
    amask = (torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
             & valid[:, None, None, :])
    # rows that see a valid key (causal, Sq == Skv: row i iff i >= pad)
    seen = valid[:, None, :].expand(b, h, s)

    def bhsd(n_heads):
        """[B, H, S, D] views of token-major memory, as on the path."""
        return randn(b, s, n_heads, d).transpose(1, 2)

    q, k, v, do = bhsd(h), bhsd(h), bhsd(h), bhsd(h)
    pairs = s * (s + 1) // 2
    nb, ops = attn_cost(b, h, s, s, d, pairs=pairs)
    run(f"attention_lse_causal_{b}x{h}x{s}x{d}",
        lambda: A._attention_fwd(q, k, v, None, None, valid, scale, True,
                                 True),
        lambda: A.attention_reference(q, k, v, kv_valid=valid, scale=scale,
                                      causal=True, with_lse=True),
        1e-2, 1e-2, nb + 4 * b * h * s, ops,
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=amask, scale=scale),
        view=lambda t: (t[0], t[1].masked_fill(~seen, 0.0)))
    o, lse = A._attention_fwd(q, k, v, None, None, valid, scale, True, True)

    def sdpa_backward(q, k, v):
        """autograd of SDPA with the same boolean mask, forward excluded"""
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        rep = q.shape[1] // k.shape[1]
        kk, vv = (t.repeat_interleave(rep, 1) for t in leaves[1:])
        out = F.scaled_dot_product_attention(leaves[0], kk, vv,
                                             attn_mask=amask, scale=scale)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    tile = 2 * b * h * s * d                       # bytes of one bf16 plane
    prod = 2 * b * h * pairs * d                   # ops of one S x S x D product
    for tag, kk, vv in (("", k, v), ("_gqa2", k[:, ::2], v[:, ::2])):
        kw = dict(scale=scale, causal=True)
        o, lse = A._attention_fwd(q, kk, vv, None, None, valid, scale, True,
                                  True)
        _, d_row = A.attention_bwd_dq(q, kk, vv, o, lse, do, valid, **kw)
        kv_tile = tile * kk.shape[1] // h
        lib = sdpa_backward(q, kk, vv)
        run(f"attention_bwd_dq{tag}_{b}x{h}x{s}x{d}",
            lambda: A.attention_bwd_dq(q, kk, vv, o, lse, do, valid, **kw)[0],
            lambda: A.attention_bwd_reference(q, kk, vv, o, lse, do, valid,
                                              **kw)[0], None, None,
            4 * tile + 2 * kv_tile + 8 * b * h * s, 3 * prod, library=lib)
        run(f"attention_bwd_dkv{tag}_{b}x{h}x{s}x{d}",
            lambda: A.attention_bwd_dkv(q, kk, vv, lse, do, d_row, valid,
                                        **kw),
            lambda: A.attention_bwd_reference(q, kk, vv, o, lse, do, valid,
                                              **kw)[1:], None, None,
            2 * tile + 4 * kv_tile + 8 * b * h * s, 4 * prod, library=lib)
        one = A.attention_bwd_dkv(q, kk, vv, lse, do, d_row, valid, **kw)
        two = A.attention_bwd_dkv(q, kk, vv, lse, do, d_row, valid, **kw)
        if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
            raise AssertionError(f"attention_bwd_dkv{tag}: two runs gave "
                                 "different bits")
        del lib, one, two
    print("  attention_bwd_dkv: two runs give the same bits (MHA, GQA rep 2)")
    # the backward as one function: five products (the two kernels recompute
    # S = QK^T and dP = dO V^T, seven in all); reads q, k, v, o, do and lse,
    # writes dq, dk, dv
    one_ms, one_by = bound(8 * tile + 4 * b * h * s, 5 * prod)
    two = results[f"attention_bwd_dq_{b}x{h}x{s}x{d}"]["ms"] + \
        results[f"attention_bwd_dkv_{b}x{h}x{s}x{d}"]["ms"]
    print(f"  attention backward {b}x{h}x{s}x{d} as one function: bound "
          f"{one_ms:.4f} ms ({one_by}); dQ + dK/dV kernels {two:.4f} ms")
    del q, k, v, do, o, lse, d_row
    torch.cuda.empty_cache()

    # the norm backward, bf16 w in both forms and an fp32 w (read as stored)
    rows, wd = b * s, 5120
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for add, w_fp32 in ((True, False), (False, False), (True, True)):
        norm = bench_norm_bwd.case(rows, wd, add, w_fp32, gen)
        name, args = norm["name"], norm["args"]
        run(name, lambda: C.rmsnorm_bwd(*args),
            lambda: C.rmsnorm_bwd_reference(*args), None, None,
            norm["nbytes"], norm["ops"], "fp32", library=norm["library"])
        one, two = (C.rmsnorm_bwd(*args) for _ in range(2))
        if not (torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])):
            raise AssertionError(f"{name}: two runs gave different bits")
        plan = C.norm_bwd_plan(rows, wd, sms)
        print(f"  {name}: dx and dw the same bits twice; plan {plan}")
        del norm, args, one, two
    torch.cuda.empty_cache()

    # the backward at 4096 causal keys, the TPU's tiled tier
    # (flash_attention.py:778, which takes causal Sq, Skv >= 4096)
    ts, kw = 4096, dict(scale=scale, causal=True)
    q, k, v, do = (randn(1, 8, ts, d) for _ in range(4))
    o, lse = A._attention_fwd(q, k, v, None, None, None, scale, True, True)
    _, d_row = A.attention_bwd_dq(q, k, v, o, lse, do, **kw)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale)
    lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
    tile, prod = 2 * 8 * ts * d, 2 * 8 * (ts * (ts + 1) // 2) * d
    run(f"attention_bwd_dq_1x8x{ts}x{d}",
        lambda: A.attention_bwd_dq(q, k, v, o, lse, do, **kw)[0],
        lambda: A.attention_bwd_reference(q, k, v, o, lse, do, **kw)[0],
        None, None, 6 * tile + 8 * 8 * ts, 3 * prod, library=lib)
    run(f"attention_bwd_dkv_1x8x{ts}x{d}",
        lambda: A.attention_bwd_dkv(q, k, v, lse, do, d_row, **kw),
        lambda: A.attention_bwd_reference(q, k, v, o, lse, do, **kw)[1:],
        None, None, 6 * tile + 8 * 8 * ts, 4 * prod, library=lib)
    del q, k, v, do, o, lse, d_row, leaves, out, lib
    torch.cuda.empty_cache()

    # kernel A at 8192 keys, causal: the TPU's streaming tier
    ls = 8192
    q, k, v = (randn(1, 8, ls, d) for _ in range(3))
    run(f"attention_causal_1x8x{ls}x{d}",
        lambda: A.attention(q, k, v, scale=scale, causal=True),
        lambda: A.attention_reference(q, k, v, scale=scale, causal=True),
        1e-2, 1e-2, *attn_cost(1, 8, ls, ls, d, pairs=ls * (ls + 1) // 2),
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale))
    del q, k, v
    torch.cuda.empty_cache()


# phases 4-5: the interleaved and video-QA prompts (two images, 8 frames)
INTERLEAVED = ("[<IMG_PLH>]The first picture. [<IMG_PLH>]The second one. "
               "What differs between them?")
VIDEO_QUESTION = "What happens in the video?"


def check_two_layer(card: str, images) -> None:
    """Phase 4: the same 2-layer full-width weights, card bf16 vs CPU fp32:
    last-position logits of a caption prompt (one image), an 8-frame
    video-QA prompt and a two-image interleaved prompt (the prompts of
    `Emu1Runner.video_qa` and `.interleaved`), each within 0.05 of
    max|ref|."""
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.cli.inference import (Emu1Runner, build_runner,
                                             image_system_msg,
                                             video_system_msg)
    from emu_tpu_torch.models.emu1 import Emu1

    t0 = time.perf_counter()
    cpu = build_runner(full=True, device="cpu", seed=SEED, depth=2)
    gpu_model = Emu1(cpu.cfg, cast_tree(cpu.model.tree(), "cuda",
                                        torch.bfloat16))
    gpu = Emu1Runner(gpu_model, cpu.cfg, cpu.tokenizer)
    prompts = [
        ("logits_2layer_card_bf16_vs_cpu_fp32", images[:1],
         cpu.caption_prompt(), image_system_msg),
        ("logits_2layer_video_8_frames_card_bf16_vs_cpu_fp32", images[:8],
         cpu.video_prompt(8, VIDEO_QUESTION), video_system_msg),
        ("logits_2layer_interleaved_2_images_card_bf16_vs_cpu_fp32",
         images[:2], cpu.interleaved_prompt(INTERLEAVED), ""),
    ]
    for name, imgs, prompt, system in prompts:
        t1 = time.perf_counter()
        ref = cpu.next_token_logits(imgs, prompt, system=system)
        got = gpu.next_token_logits(imgs, prompt, system=system)
        print(f"  2-layer full-width Emu1, {len(imgs)} image(s), prompt "
              f"{gpu.last_stats['prompt_len']} tokens, vocab {ref.shape[-1]},"
              f" {time.perf_counter() - t1:.1f} s")
        compare(name, got.cpu(), ref, atol=0.0, rtol=0.05)
        agree = int(got.float().argmax()) == int(ref.argmax())
        print(f"  argmax agrees: {agree}")
    print(f"  phase 4: {time.perf_counter() - t0:.1f} s")


def emu1_launches(cfg, steps: int) -> dict:
    """The launches of one Emu1Runner request (one prompt row, greedy or
    beam: a beam step is one model call over all beams) whose images go
    through one encode, with `steps` decode steps: the tower's
    (`tower_launches`, one forward at any batch), kernel H's plain TMA form
    on the Causal Former's projection (32 rows an image), and in the LLaMA
    kernel A per layer in the prefill, kernel C twice a layer (the input
    norm; the residual add and post-attention norm) in the prefill and in
    every decode step, and kernel D (Sq = 1, bf16) per layer per decode
    step. Its denses have no bias and take torch.matmul, its final norm is
    `layers.rms_norm`; the Causal Former runs no kernel."""
    out = tower_launches(cfg.vision.layers, 1)
    n = cfg.llama.num_hidden_layers
    out["fused_dense"] += 1
    out["attention"] += n
    out["add_rmsnorm"] = 2 * n * (1 + steps)
    out["decode_attention"] = n * steps
    return out


def run_full(card: str, images, wrappers: dict) -> dict:
    """Phase 5: full-depth Emu1 through the runner, a few requests; the
    interleaved and video-QA requests' launches held to `emu1_launches`.
    Returns the fingerprint of its tree (phase 19 evaluates the same
    tree)."""
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
        E2E[f"emu1 {label} encode ms"] = st["encode_s"] * 1e3
        E2E[f"emu1 {label} prefill ms"] = st["prefill_s"] * 1e3
        E2E[f"emu1 {label} decode ms/step"] = st["decode_s"] * 1e3 / steps
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
    flows = [
        ("interleaved 2 images beam5", lambda: runner.interleaved(
            images[:2], INTERLEAVED, max_new_tokens=MAX_NEW)),
        ("video 8 frames beam5", lambda: runner.video_qa(
            images[:8], VIDEO_QUESTION, max_new_tokens=MAX_NEW)),
    ]
    for label, request in flows:
        before = {n: w.launches for n, w in wrappers.items()}
        out = request()
        got = {n: w.launches - before[n] for n, w in wrappers.items()}
        report(label, [out])
        want = {n: 0 for n in wrappers}
        want.update(emu1_launches(runner.cfg,
                                  runner.last_stats["decode_steps"]))
        if got != want:
            raise AssertionError(f"phase 5 {label}: launches {got}, the "
                                 f"structure gives {want}")
        print(f"    prompt {runner.last_stats['prompt_len']} tokens; "
              "launches as the structure gives them: "
              f"{ {n: c for n, c in got.items() if c} }")
    decode_modes(runner, images, report)
    logits = runner.next_token_logits([images[0]], runner.caption_prompt())
    assert logits.shape == (1, vocab) and bool(torch.isfinite(logits).all())
    with torch.inference_mode():
        emb = runner.model.encode_image(torch.zeros(
            2, 224, 224, 3, device="cuda", dtype=torch.bfloat16))
    assert emb.shape == (2, 32, 5120) and bool(torch.isfinite(emb).all())
    print(f"  outputs finite; peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB")
    return tree_fingerprint(runner.model.tree())


# the server form's sampling defaults (serving/backend.py)
SAMPLING = dict(do_sample=True, top_k=3, top_p=0.9, temperature=0.7)


def card_generator(seed: int):
    import torch
    return torch.Generator(device="cuda").manual_seed(seed)


@contextlib.contextmanager
def decode_rows():
    """The row counts of every kernel D call (the batch of its q) inside
    the block, recorded at the attention dispatcher."""
    from emu_tpu_torch.ops import attention as OA
    rows, orig = [], OA.decode_attention

    def recorded(q, *args, **kwargs):
        rows.append(q.shape[0])
        return orig(q, *args, **kwargs)

    OA.decode_attention = recorded
    try:
        yield rows
    finally:
        OA.decode_attention = orig


@contextlib.contextmanager
def step_logits():
    """The fp32 logits of every LLaMA logits call inside the block (the
    prefill's last position, then each decode step), recorded at
    `llama.logits`."""
    from emu_tpu_torch.models import llama
    out, orig = [], llama.logits

    def recorded(params, hidden):
        y = orig(params, hidden)
        out.append(y.float())
        return y

    llama.logits = recorded
    try:
        yield out
    finally:
        llama.logits = orig


def maximal_tokens(tokens, logits, eos: int) -> int:
    """Assert that each generated token (one row) is a maximal score of
    its step (EOS masked at step 0: min_length 1); return the number of
    steps whose maximum was tied."""
    ties = 0
    for t, (lg, tok) in enumerate(zip(logits, tokens)):
        scores = lg[0].clone()
        if t == 0:
            scores[eos] = float("-inf")
        best = scores.max()
        assert scores[tok] == best, f"step {t}: token {tok} is not maximal"
        ties += int(int((scores == best).sum()) > 1)
        if tok == eos:
            break
    return ties


def decode_modes(runner, images, report) -> None:
    """Phase 5's other decoding modes on the full-depth Emu1: a sampled
    caption (the server's sampling defaults) from a seeded card generator,
    twice, and top_k=1 sampling against greedy; a beam-sample caption at 5
    beams; a contrastive-search caption (its kernel D calls at 4 rows); a
    trie-constrained VQA whose answer is one of its candidates."""
    import torch
    from emu_tpu_torch.cli.inference import image_system_msg

    def caption(**kw):
        out = runner.generate_ids([images[0]], [runner.caption_prompt()],
                                  system=image_system_msg,
                                  max_new_tokens=MAX_NEW, **kw)
        return out, runner.tokenizer.batch_decode(out.tolist())

    a, text = caption(beam_size=1, generator=card_generator(SEED), **SAMPLING)
    report("caption sampled", text)
    b, _ = caption(beam_size=1, generator=card_generator(SEED), **SAMPLING)
    assert torch.equal(a, b), "sampling is not reproducible from its seed"
    greedy, _ = caption(beam_size=1)
    with step_logits() as logits:
        top1, _ = caption(beam_size=1, do_sample=True, top_k=1,
                          generator=card_generator(SEED + 1))
    ties = maximal_tokens(top1[0].tolist(), logits,
                          runner.tokenizer.eos_token_id)
    same = torch.equal(top1, greedy)
    # top-k keeps every score equal to the k-th (HF's and the JAX
    # package's rule): top_k=1 samples among tied maxima, so it equals
    # greedy exactly when no step's maximum is tied
    assert same or ties, "top_k=1 sampling is not greedy"
    print("  sampled caption: the same tokens twice from one seed; top_k=1 "
          f"sampling took a maximal token at every step ({ties} steps with a"
          f" tied maximum), {'equal to' if same else 'differing from'} "
          "greedy's tokens")
    _, text = caption(beam_size=5, generator=card_generator(SEED + 2),
                      **SAMPLING)
    report("caption beam-sample 5", text)
    with decode_rows() as rows:
        _, text = caption(beam_size=1, penalty_alpha=0.6, top_k=4)
    report("caption contrastive k4", text)
    assert rows and set(rows) == {4}, f"contrastive D rows {set(rows)}"
    print(f"  contrastive: {len(rows)} kernel D calls, all at 4 rows")
    cands = ["yes", "no", "unanswerable"]
    trie = runner.candidate_trie(cands)
    ids = runner.vqa_choice_ids(images[1], "Is there an animal in the "
                                "picture?", cands)[0].tolist()
    eos = runner.tokenizer.eos_token_id
    seqs = [runner.tokenizer.encode(" " + c, add_bos=False) + [eos]
            for c in cands]
    n = ids.index(eos) + 1
    assert ids[:n] in seqs and trie["allowed"].shape[1] == int(
        runner.model.decoder.embed_tokens.shape[0])
    report("vqa trie", [cands[seqs.index(ids[:n])]])


def dequantized_int4(tree):
    """The tree with every int4 dense ({kernel_q4, scale4}) replaced by its
    dequantized fp32 kernel: on the CPU it computes what the card's fp32
    route computes on the int4 tree (dequantize, fp32 product), where the
    int4 tree itself runs kernel F's twin, which also rounds the
    activations to int8 (W4A8)."""
    import torch
    from emu_tpu_torch.ops import quant as Q
    if isinstance(tree, dict):
        if "kernel_q4" in tree:
            out = {k: v for k, v in tree.items()
                   if k not in ("kernel_q4", "scale4")}
            out["kernel"] = Q.dequantize_int4(tree, torch.float32)
            return out
        return {k: dequantized_int4(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantized_int4(v) for v in tree]
    return tree


def check_emu2_two_layer(card: str, image) -> None:
    """Phase 6: the same 2-layer full-width Emu2-Chat weights, card vs CPU
    (fp32, plain twins), bf16 and int4; then the same trees in fp32 on the
    card (the plain routes) answering a request. Limits stated before the
    first run: max |logit error| <= 0.05 * max|ref| (bf16), 0.08 * max|ref|
    (int4), 0.01 * max|ref| (fp32 on the card against the CPU computing the
    same function: the float tree, and the int4 tree with its int4 denses
    dequantized, since the card's fp32 route dequantizes them)."""
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
        # fp32 on the card: kernels D, F and G take bf16 only, so fp32
        # activations take the plain routes (the prefill and one greedy
        # request of 4 tokens, decode steps included); in int4 that route
        # dequantizes the weights and keeps the activations in fp32
        f32 = EmuChatGeneration(cast_tree(ref_pipe.params, "cuda"), cpu.cfg,
                                cpu.tokenizer)
        got = f32.next_token_logits(request).cpu()
        witness = ref
        if mode == "int4":
            witness = EmuChatGeneration(dequantized_int4(ref_pipe.params),
                                        cpu.cfg, cpu.tokenizer
                                        ).next_token_logits(request)
            w4a8 = float((got.float() - ref).abs().max()
                         / ref.abs().max())
            print(f"  fp32 int4 on the card against the CPU's W4A8 twin "
                  f"(a different function: activations rounded to int8): "
                  f"{w4a8:.6g} of max|ref|, not judged")
        compare(f"emu2_logits_2layer_card_fp32_{mode or 'float'}_vs_cpu_fp32",
                got, witness, atol=0.0, rtol=0.01)
        ids = f32.generate_ids([request], num_beams=1, max_new_tokens=4)
        assert ids.shape == (1, 4)
        print(f"  fp32 on the card ({mode or 'float weights'}): a 4-token "
              "greedy request answered")
        del gpu, ref_pipe, f32, witness
        torch.cuda.empty_cache()


def run_emu2_full(card: str, images):
    """Phase 7: full-depth Emu2-Chat, int4 decoder and W8A8 tower.
    Returns the pipeline (phase 19 runs its tree in device mode)."""
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
        E2E[f"emu2 {label} encode ms"] = st["encode_s"] * 1e3
        E2E[f"emu2 {label} prefill ms"] = st["prefill_s"] * 1e3
        E2E[f"emu2 {label} decode ms/step"] = st["decode_s"] * 1e3 / steps
        print(f"  {label}: images={st['images']} frames={st['frames']} "
              f"prompt={st['prompt_len']} encode {st['encode_s'] * 1e3:.1f} ms,"
              f" prefill {st['prefill_s'] * 1e3:.1f} ms, decode "
              f"{st['decode_s'] * 1e3 / steps:.2f} ms/step over {steps} steps,"
              f" peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB  "
              f"[{card}]")
        text = chat.tokenizer.batch_decode(ids.cpu().numpy())[0]
        print(f"    -> {text[:120]!r}")
    for label, kw in (("sampled", dict(num_beams=1, **SAMPLING)),
                      ("contrastive k4", dict(penalty_alpha=0.6, top_k=4))):
        texts = [chat.generate_batch([requests[0][1]], max_new_tokens=MAX_NEW,
                                     generator=card_generator(SEED), **kw)[0]
                 for _ in range(2 if kw.get("do_sample") else 1)]
        st = chat.last_stats
        steps = max(st["decode_steps"], 1)
        E2E[f"emu2 1 image, {label} decode ms/step"] = (st["decode_s"] * 1e3
                                                       / steps)
        assert all(isinstance(t, str) for t in texts) and st["beams"] == 1
        assert texts[0] == texts[-1], "sampled chat differs between seeds"
        print(f"  1 image + question, {label}: prefill "
              f"{st['prefill_s'] * 1e3:.1f} ms, decode "
              f"{st['decode_s'] * 1e3 / steps:.2f} ms/step over {steps} steps"
              f"{' (the same text twice from one seed)' if len(texts) > 1 else ''}"
              f"  [{card}]")
        print(f"    -> {texts[0][:120]!r}")
    logits = chat.next_token_logits(requests[0][1])
    assert logits.shape == (1, vocab) and bool(torch.isfinite(logits).all())
    print("  outputs finite")
    return chat


# phase 8's card-side W4A8 witness, per call: each kernel's output within
# this share of max|twin| of its plain twin's on the same inputs on the card
# (phase 3's rtol for each kernel, without its atol)
WITNESS_RTOL = {"matmul_q4": 0.01, "fused_swiglu_q4": 0.02,
                "decode_attention": 0.01}


# phase 8's logits limit, a share of max|ref|, set from two readings on
# the H100: every form at seeds 1234-1239 reads 0.059-0.094 (W4A8
# requantizes each activation row at its own max, so the card's bf16
# rounding moves these logits by that much); two planted faults of the
# packed mixed step (its chunk reading the neighbouring slot's rows; its
# chunk never committed) read 1.11-1.50 at seeds 1234-1236
ENGINE_LOGIT_RTOL = 0.15


def check_engine_two_layer(card: str) -> float:
    """Phase 8: the continuous engine's decode forms on a full-width
    Emu2-Chat int4 decoder cut to 2 layers, int8 KV cache, teacher-forced,
    card (bf16) against the CPU (fp32, plain twins), as the engine runs
    them: a bucket prefill of 2 rows, two packed mixed steps
    (`llama.decode_packed_rows`: 2 decode rows + a third slot's 52-token
    admission in a chunk of 32 and a final chunk of 20 padded to 32, the
    second reading the first's committed rows through the folded cache)
    and 3 decode steps. Limit: max |logit error| <= ENGINE_LOGIT_RTOL *
    max|ref|. Returns the largest absolute logit error (phase 9's
    yardstick).

    Then the card-side W4A8 witness (`twin_witness` of
    `tools/probe_w4a8_twins.py`): in the card's run,
    every call of kernels F, G and D is held against its plain twin on the
    same inputs on the card, so the comparison measures the kernels' error
    alone, without the fp32-against-bf16 rounding of the check above. Limit
    stated before its first run: each call's max |kernel - twin| <=
    WITNESS_RTOL[kernel] * max|twin| (0.01 for F and D, 0.02 for G: phase
    3's rtol). No logits-level comparison against the twins is made:
    W4A8 re-quantizes every activation row to int8 at its own max, so one
    bf16 ulp moved in 0.1% of one product's outputs moves these logits by
    2-5% of their max (`python -m emu_tpu_torch.tools.probe_w4a8_twins`
    prints that whole-run comparison)."""
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.models import llama
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration
    from emu_tpu_torch.tools.probe_w4a8_twins import twin_witness

    t0 = time.perf_counter()
    cpu = EmuChatGeneration.from_config(instruct=True, seed=SEED,
                                        device="cpu", depth=2,
                                        quantize="int4")
    cfg = cpu.cfg.llama
    dec_cpu = cpu.params["decoder"]
    dec_gpu = cast_tree(dec_cpu, "cuda", torch.bfloat16)
    g = torch.Generator().manual_seed(SEED)
    ids = torch.randint(3, cfg.vocab_size, (3, 64), generator=g)
    forced = torch.randint(3, cfg.vocab_size, (5, 3), generator=g)
    mask = torch.ones(2, 64, dtype=torch.long)
    mask[1, :24] = 0                     # a left-padded bucket row

    def run(dec, dev):
        out = {}
        cache = llama.init_cache(cfg, 3, 256, device=dev, quant=True)
        small = llama.init_cache(cfg, 2, 64, device=dev, quant=True)
        m = mask.to(dev)
        h, small = llama.prefill(dec, cfg, llama.embed(dec, ids[:2].to(dev)),
                                 m, small)
        out["prefill"] = llama.logits(dec, h[:, -1])
        for n, plane in cache.items():
            plane[:, :2, :, :64] = small[n]
        sm = torch.zeros(3, 256, dtype=torch.bool, device=dev)
        sm[:2, :64] = m.bool()
        slots = torch.tensor([64, 64, 0], device=dev)
        pos = torch.cat([m.sum(1), torch.zeros(1, dtype=torch.long,
                                                device=dev)])
        # slot 2 admits ids[2, :52] in two chunks, as `_mixed` packs them
        for t, (lo, qlen) in enumerate(((0, 32), (32, 20))):
            chunk = torch.nn.functional.pad(
                llama.embed(dec, ids[2, lo:lo + qlen].to(dev)),
                (0, 0, 0, 32 - qlen))
            tok = torch.cat([llama.embed(dec, forced[t].to(dev)), chunk])
            h, _ = llama.decode_packed_rows(dec, cfg, cache, tok, 2, slots,
                                            sm, pos)
            out[f"mixed{t + 1}"] = llama.logits(
                dec, h[torch.tensor([0, 1, 2 + qlen], device=dev)])
            sm[torch.arange(2, device=dev), slots[:2]] = True
            sm[2, lo:lo + qlen] = True
            step = torch.tensor([1, 1, qlen], device=dev)
            slots, pos = slots + step, pos + step
        for t in range(2, 5):
            sm[torch.arange(3, device=dev), slots] = True
            h, _ = llama.decode_step_rows(
                dec, cfg, cache, llama.embed(dec, forced[t].to(dev)[:, None]),
                slots, sm, pos)
            out[f"decode{t - 1}"] = llama.logits(dec, h[:, 0])
            slots, pos = slots + 1, pos + 1
        return out

    calls = []
    with torch.inference_mode():
        ref = run(dec_cpu, "cpu")
        with twin_witness(calls):
            got = run(dec_gpu, "cuda")
    print(f"  2-layer full-width Emu2-Chat int4, int8 KV: "
          f"{time.perf_counter() - t0:.1f} s")

    def margin(name, e, scale, rtol):
        limit = rtol * scale
        print(f"    {name}: margin {limit - e:.6g} ({e:.6g} of its "
              f"{limit:.6g}, {e / limit:.4f} of the limit)")

    err = 0.0
    for name in ref:
        compare(f"engine_2layer_int8kv_{name}", got[name].cpu(), ref[name],
                atol=0.0, rtol=ENGINE_LOGIT_RTOL)
        e = float((got[name].cpu().float() - ref[name]).abs().max())
        margin(f"{name} card vs CPU fp32", e, float(ref[name].abs().max()),
               ENGINE_LOGIT_RTOL)
        err = max(err, e)
        agree = (got[name].cpu().float().argmax(-1) == ref[name].argmax(-1))
        print(f"    {name}: argmax agrees on {int(agree.sum())} of "
              f"{agree.numel()} rows")
    print("  card-side W4A8 witness: each call of F, G, D against its plain "
          f"twin on the same inputs on the card, limits {WITNESS_RTOL} of "
          "max|twin|")
    bad = []
    for kernel, rtol in WITNESS_RTOL.items():
        mine = [c for c in calls if c[0] == kernel]
        if not mine:
            raise AssertionError(f"phase 8 witness: no call of {kernel}")
        worst = max(mine, key=lambda c: c[2] / max(c[3], 1e-30))
        margin(f"{kernel}, {len(mine)} calls, worst at input "
               f"{worst[1]}", worst[2], worst[3], rtol)
        bad += [c for c in mine if not c[2] <= rtol * c[3]]
    if bad:
        raise AssertionError(f"phase 8 witness: calls above their limits: "
                             f"{bad}")
    del dec_gpu
    torch.cuda.empty_cache()
    return err


def train_batch(cfg, seq: int):
    """Two rows of an image's tokens ([IMG] + 32 <image> + [/IMG]) and
    random text, the second padded on the right by 16 (kv_valid at work,
    and no query row without a visible key: such rows' gradients follow the
    flash backward's convention on the card and the plain chain's on the
    CPU, a difference phase 3 and the CPU tests pin); fp32 224-px images;
    the special ids (pad, [IMG], [/IMG], <image>) at the end of the base
    vocab, as the tokenizer adds them."""
    import torch
    v = cfg.llama.vocab_size
    special = (v, v + 1, v + 2, v + 3)
    g = torch.Generator().manual_seed(SEED)
    ids = torch.randint(3, v, (TRAIN_B, seq), generator=g)
    n = cfg.n_causal
    ids[:, 0], ids[:, 1], ids[:, 2 + n] = 1, v + 1, v + 2
    ids[:, 2:2 + n] = v + 3
    mask = torch.ones_like(ids)
    ids[1, -16:], mask[1, -16:] = v, 0
    images = torch.randn(TRAIN_B, 224, 224, 3, generator=g) * 0.5
    return images, ids, mask, special


def check_train_two_layer(card: str) -> None:
    """Phase 11: one Emu1 train step's loss and gradients, a full-width
    Emu1 cut to 2 layers (phase 4's model), 2 x 256 tokens, fp32 images,
    card (bf16 weights, remat "named") against the CPU (fp32, plain twins,
    no remat). Limits stated before the first run: |loss_card - loss_cpu|
    <= 0.01 * |loss_cpu|; every leaf ||g_card - g_cpu|| <= 0.1 ||g_cpu||
    (a leaf with no gradient on the CPU has none on the card)."""
    import torch
    from emu_tpu_torch import bridge, training
    from emu_tpu_torch.cli.inference import with_depth
    from emu_tpu_torch.config import Emu1Config
    from emu_tpu_torch.models import emu1
    from emu_tpu_torch.ops.layers import Init

    t0 = time.perf_counter()
    cfg = with_depth(Emu1Config(), 2)
    tree = emu1.init(cfg, Init(generator=torch.Generator().manual_seed(SEED)))
    images, ids, mask, special = train_batch(cfg, 256)

    def loss_and_grads(dev, dtype, remat):
        params = bridge.trainable(bridge.cast_tree(tree, dev, dtype))
        loss = training.emu1_loss(params, cfg, images.to(dev), ids.to(dev),
                                  mask.to(dev), special, remat)
        loss.backward()
        return float(loss.detach()), {n: t.grad.float().cpu()
                             for n, t in bridge.flatten(params).items()}

    ref_loss, ref = loss_and_grads("cpu", None, False)
    t1 = time.perf_counter()
    loss, got = loss_and_grads("cuda", torch.bfloat16, "named")
    torch.cuda.synchronize()
    print(f"  2-layer full-width Emu1 train step: CPU fp32 {t1 - t0:.1f} s "
          f"(with the build), card {time.perf_counter() - t1:.1f} s")
    rel_loss = abs(loss - ref_loss) / abs(ref_loss)
    print(f"  loss card {loss:.6f} vs CPU {ref_loss:.6f}: rel {rel_loss:.6g}"
          f" (limit 0.01)")
    if not rel_loss <= 0.01:
        raise AssertionError(f"train step loss: relative error {rel_loss}")
    errs = {}
    for name, g in ref.items():
        norm = float(g.norm())
        diff = float((got[name] - g).norm())
        if norm == 0.0:
            if diff != 0.0:
                raise AssertionError(f"grad {name}: zero on the CPU, not on "
                                     "the card")
            continue
        errs[name] = diff / norm
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    print(f"  {len(errs)} leaves with a gradient ({len(ref) - len(errs)} "
          f"without); ||g_card - g_cpu|| / ||g_cpu|| max {worst[0][1]:.6g} "
          f"(limit 0.1), median {worst[len(worst) // 2][1]:.6g}")
    for name, e in worst[:4]:
        print(f"    {e:.6g}  {name}")
    if worst[0][1] > 0.1:
        raise AssertionError(f"grad {worst[0][0]}: relative error "
                             f"{worst[0][1]}")
    del got
    torch.cuda.empty_cache()


def run_train_full(card: str) -> None:
    """Phase 12: the full-depth Emu1 trained through training.Trainer,
    5 steps on one batch (2 x 1024 tokens); then one step under
    torch.profiler (kernel time against the unprofiled step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)
    from torch.profiler import ProfilerActivity, profile
    from emu_tpu_torch import bridge, optim, training
    from emu_tpu_torch.config import Emu1Config
    from emu_tpu_torch.models import emu1
    from emu_tpu_torch.ops.layers import Init

    t0 = time.perf_counter()
    cfg = Emu1Config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tree = emu1.init(cfg, Init(device="cuda", dtype=torch.bfloat16,
                               generator=gen))
    images, ids, mask, special = train_batch(cfg, TRAIN_S)
    trainer = training.Trainer(cfg, tree, optim.fused_adafactor(TRAIN_LR),
                               special, remat="named", device="cuda")
    del tree
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t, _ in bridge.grad_leaves(trainer.params))
    print(f"  built full Emu1 for training in {time.perf_counter() - t0:.1f}"
          f" s: {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated "
          f"(bf16 weights and grad buffers)")

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    # the optimizer's span in each step, from torch's global step hooks (the
    # trainer builds its optimizer in its first step)
    opt_starts, opt_spans = [], []
    hooks = (register_optimizer_step_pre_hook(
        lambda *_: opt_starts.append(event())),
        register_optimizer_step_post_hook(
        lambda *_: opt_spans.append((opt_starts[-1], event()))))
    torch.cuda.reset_peak_memory_stats()
    losses, spans = [], []
    for _ in range(5):
        s = event()
        losses.append(trainer.step(images, ids, mask))
        spans.append((s, event()))
    for h in hooks:
        h.remove()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [s.elapsed_time(e) for s, e in spans]
    opt_ms = [s.elapsed_time(e) for s, e in opt_spans]
    tokens = TRAIN_B * TRAIN_S
    steady = sum(step_ms[1:]) / len(step_ms[1:])
    steady_opt = sum(opt_ms[1:]) / len(opt_ms[1:])
    print(f"  losses {[round(x, 6) for x in losses]}")
    for i, (a, o) in enumerate(zip(step_ms, opt_ms)):
        print(f"    step {i}: {a:.2f} ms = forward+backward {a - o:.2f} ms "
              f"+ optimizer {o:.2f} ms")
    E2E["train ms/step"] = steady
    print(f"  steps 1-4: {steady:.2f} ms/step (forward+backward "
          f"{steady - steady_opt:.2f}, optimizer {steady_opt:.2f}), "
          f"{tokens / steady * 1e3:.1f} tokens/s ({TRAIN_B} x {TRAIN_S}); "
          f"peak {peak:.2f} GiB  [{card}]")
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"training: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training: the loss did not fall {losses}")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(images, ids, mask)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    print(f"  one step under torch.profiler: kernels {busy:.2f} ms against "
          f"{steady:.2f} ms unprofiled (busy {busy / steady:.2f})  [{card}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:9.3f} ms  {name[:90]}")
    del trainer
    torch.cuda.empty_cache()


def attention_plan(cfg, lat: int, ctx_len: int, batch: int = 2) -> dict:
    """Launches of batched_mha and kernel A that one UNet forward on a
    lat² latent must make, from the UNet's structure (every Transformer2D
    block: one self-attention, one cross-attention against ctx_len keys)
    and `ops.attention.attention_route`."""
    import torch
    from emu_tpu_torch.ops import attention as att
    n = len(cfg.block_out_channels)
    levels = []          # (resolution, channels, heads, transformer blocks)
    for i, kind in enumerate(cfg.down_block_types):
        if kind == "CrossAttnDownBlock2D":
            levels += [(lat >> i, cfg.block_out_channels[i],
                        cfg.attention_head_dim[i],
                        cfg.transformer_layers_per_block[i])
                       ] * cfg.layers_per_block
    levels.append((lat >> (n - 1), cfg.block_out_channels[-1],
                   cfg.attention_head_dim[-1],
                   cfg.transformer_layers_per_block[-1]))
    for i, kind in enumerate(cfg.up_block_types):
        j = n - 1 - i
        if kind == "CrossAttnUpBlock2D":
            levels += [(lat >> j, cfg.block_out_channels[j],
                        cfg.attention_head_dim[j],
                        cfg.transformer_layers_per_block[j])
                       ] * (cfg.layers_per_block + 1)
    plan = {"batched_mha": 0, "flash": 0, "plain": 0}
    for res, ch, heads, blocks in levels:
        q = torch.empty(batch, res * res, heads, ch // heads, device="meta",
                        dtype=torch.bfloat16)
        kv = torch.empty(batch, ctx_len, heads, ch // heads, device="meta",
                         dtype=torch.bfloat16)
        plan[att.attention_route(q, q, q)] += blocks
        plan[att.attention_route(q, kv, kv)] += blocks
    return plan


def unet_launches(fn):
    """(batched_mha, kernel A) launches made by fn(), and fn()'s result."""
    import torch
    from emu_tpu_torch.ops import flash_attention as A
    b0, a0 = A.batched_mha.launches, A.attention.launches
    out = fn()
    torch.cuda.synchronize()
    return (A.batched_mha.launches - b0, A.attention.launches - a0), out


def check_plan(label: str, counts, plan: dict) -> None:
    want = (plan["batched_mha"], plan["flash"])
    print(f"  {label}: batched_mha {counts[0]}, kernel A {counts[1]} launches"
          f" per UNet forward (structure and routes: {want[0]}, {want[1]}; "
          f"plain chain {plan['plain']})")
    if tuple(counts) != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def check_diffusion_card_vs_cpu(card: str) -> None:
    """Phase 13: the full-width SDXL and SD1.5 UNets (one CFG-batch forward
    each) and both VAEs (one decode each), built on the CPU in fp32 from one
    seed, card (bf16, kernels) against the CPU (fp32, plain twins), at cut
    resolutions: SDXL on a 64² latent (transformer levels of 1024 and 256
    tokens, both through batched_mha) with the regression-width context
    [2, 64, 1792] and SDXL time ids; SD1.5 on a 32² latent (1024, 256 and
    64 tokens) with a [2, 32, 5120] context; each VAE decoding a 32²
    latent. Limit stated before the first run: max |err| <= 0.05 *
    max|ref|, as the other bf16 card-vs-CPU phases."""
    import torch
    from emu_tpu_torch.bridge import cast_tree, flatten
    from emu_tpu_torch.config import UNetConfig, VAEConfig
    from emu_tpu_torch.diffusion import unet, vae
    from emu_tpu_torch.ops.layers import Init

    g = torch.Generator().manual_seed(SEED)

    def bf(t):
        return t.to("cuda", torch.bfloat16)

    conv_rounding(card)
    for name, cfg, lat, m in (("sdxl", UNetConfig.emu2_sdxl(), 64, 64),
                              ("sd15", UNetConfig.emu1_sd15(), 32, 32)):
        t0 = time.perf_counter()
        params = unet.init(cfg, Init(
            generator=torch.Generator().manual_seed(SEED)))
        x = torch.randn(2, lat, lat, 4, generator=g)
        ts = torch.tensor([500.0, 500.0])
        ctx = torch.randn(2, m, cfg.cross_attention_dim, generator=g)
        kw, gkw = {}, {}
        if cfg.addition_embed_type == "text_time":
            ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2)
            kw = {"added_text_embeds": ctx.mean(1), "added_time_ids": ids}
            gkw = {"added_text_embeds": bf(ctx).mean(1),
                   "added_time_ids": ids.cuda()}
        with torch.inference_mode():
            ref = unet.forward(params, cfg, x, ts, ctx, **kw)
            t1 = time.perf_counter()
            gparams = cast_tree(params, "cuda", torch.bfloat16)
            del params
            counts, got = unet_launches(lambda: unet.forward(
                gparams, cfg, bf(x), ts.cuda(), bf(ctx), **gkw))
        n_par = sum(v.numel() for v in flatten(gparams).values())
        print(f"  {name} UNet ({n_par / 1e9:.3f} B parameters), {lat}² latent,"
              f" context [2, {m}, {cfg.cross_attention_dim}]: CPU fp32 build +"
              f" forward {t1 - t0:.1f} s")
        check_plan(f"{name} UNet, {lat}² latent", counts,
                   attention_plan(cfg, lat, m))
        compare(f"unet_{name}_{lat}x{lat}_card_bf16_vs_cpu_fp32", got.cpu(),
                ref, atol=0.0, rtol=0.05)
        del gparams, got, ref
        torch.cuda.empty_cache()
    for i, (name, vcfg) in enumerate((("sdxl", VAEConfig()),
                                      ("sd15", VAEConfig.sd15()))):
        params = vae.init(vcfg, Init(
            generator=torch.Generator().manual_seed(SEED + 1 + i)))
        z = torch.randn(1, 32, 32, 4, generator=g)
        with torch.inference_mode():
            ref = vae.decode(params, vcfg, z)
            got = vae.decode(cast_tree(params, "cuda", torch.bfloat16), vcfg,
                             bf(z))
        assert got.shape == (1, 256, 256, 3)
        compare(f"vae_{name}_decode_32x32_card_bf16_vs_cpu_fp32", got.cpu(),
                ref, atol=0.0, rtol=0.05)
    torch.cuda.empty_cache()


def conv_rounding(card: str) -> None:
    """How far the card's bf16 conv (cuDNN, the bias added to the rounded
    bf16 product) lands from the JAX package's rule (bias added to the
    fp32 product, rounded once), at a UNet conv's shape (3x3, 320 -> 320 on
    a 128² map, batch 2): the share of elements that differ and the largest
    difference against max|ref|. Printed, not
    judged: phase 13's limit holds the whole model."""
    import torch
    import torch.nn.functional as F
    from emu_tpu_torch.diffusion import layers as D
    g = torch.Generator("cuda").manual_seed(SEED)
    x = torch.randn(2, 128, 128, 320, device="cuda", generator=g)
    p = {"kernel": torch.randn(3, 3, 320, 320, device="cuda", generator=g)
         * (9 * 320) ** -0.5,
         "bias": torch.randn(320, device="cuda", generator=g) * 0.5}
    xb = x.bfloat16()
    pb = {k: v.bfloat16() for k, v in p.items()}
    got = D.conv2d(pb, xb).float()
    w = pb["kernel"].float().permute(3, 2, 0, 1)
    ref = (F.conv2d(xb.float().permute(0, 3, 1, 2), w, padding=1)
           .permute(0, 2, 3, 1) + pb["bias"].float()).bfloat16().float()
    diff = (got - ref).abs()
    print(f"  bf16 conv rounding (3x3, 320->320, 2x128x128): "
          f"{float((diff > 0).float().mean()):.4f} of elements differ from "
          f"the single-rounded value; max |diff| "
          f"{float(diff.max() / ref.abs().max()):.2e} of max|ref|  [{card}]")


def generate_and_report(card: str, pipe, label: str, inputs, size: int,
                        steps: int, guidance: float) -> dict:
    """One request through a generation pipeline: the image at the asked
    size, every step's latents finite (checked after the run, no sync per
    step), and its figures: conditioning (the regression, or the encode),
    UNet ms per step from CUDA events between the steps' callbacks, the
    VAE decode, seconds per image, peak memory. Returns the figures."""
    import torch
    events, finite = [], []

    def callback(i, latents):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append(e)
        finite.append(torch.isfinite(latents).all())

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe(inputs, height=size, width=size, num_inference_steps=steps,
               guidance_scale=guidance,
               generator=torch.Generator("cuda").manual_seed(SEED),
               callback=callback)
    wall = time.perf_counter() - t0
    image = out.image if hasattr(out, "image") else out[0]
    if image.size != (size, size):
        raise AssertionError(f"{label}: image {image.size}")
    if not all(bool(f) for f in finite) or not finite:
        raise AssertionError(f"{label}: non-finite latents at a step")
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    st = pipe.last_stats
    fig = {"condition_ms": st["condition_s"] * 1e3,
           "unet_ms_per_step": sum(step_ms) / len(step_ms),
           "denoise_s": st["denoise_s"], "decode_ms": st["decode_s"] * 1e3,
           "s_per_image": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"  {label}: {len(events)} UNet steps, condition "
          f"{fig['condition_ms']:.1f} ms, UNet {fig['unet_ms_per_step']:.2f} "
          f"ms/step (min {min(step_ms):.2f}, max {max(step_ms):.2f}), denoise "
          f"{fig['denoise_s']:.2f} s, VAE decode {fig['decode_ms']:.1f} ms, "
          f"{wall:.2f} s per image, peak {fig['peak_gib']:.1f} GiB; every "
          f"latent finite  [{card}]")
    return fig


def profile_unet_step(card: str, pipe, lat: int, ctx_len: int,
                      step_ms: float) -> None:
    """One CFG-batch UNet forward of the pipeline's UNet at its full
    resolution under torch.profiler (random inputs of the path's shapes):
    kernel time against the unprofiled step (busy share) and the top
    kernels; its batched_mha and kernel A launches against the plan."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from emu_tpu_torch.diffusion import unet

    cfg = pipe.unet_cfg
    dev, bf = torch.device("cuda"), torch.bfloat16
    x = torch.randn(2, lat, lat, cfg.in_channels, device=dev, dtype=bf)
    ctx = torch.randn(2, ctx_len, cfg.cross_attention_dim, device=dev,
                      dtype=bf)
    ts = torch.full((2,), 500.0, device=dev)
    kw = {}
    if cfg.addition_embed_type == "text_time":
        kw = {"added_text_embeds": ctx.mean(1), "added_time_ids":
              torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                           device=dev)}
    with torch.inference_mode():
        def fwd():
            return unet.forward(pipe.unet_params, cfg, x, ts, ctx, **kw)
        counts, _ = unet_launches(fwd)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
    check_plan(f"{lat}² latent", counts, attention_plan(cfg, lat, ctx_len))
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    unet_name = "SDXL" if lat == 128 else "SD1.5"
    E2E[f"{unet_name} UNet ms/step"] = step_ms
    E2E[f"{unet_name} UNet profiled kernel ms"] = busy
    E2E[f"{unet_name} UNet kernel A ms"] = sum(
        ms for name, ms in by_name.items() if "attention_kernel" in name)
    E2E[f"{unet_name} UNet batched_mha ms"] = sum(
        ms for name, ms in by_name.items() if "batched_mha_kernel" in name)
    E2E[f"{unet_name} UNet kernel H ms"] = sum(
        ms for name, ms in by_name.items() if any(
            k in name for k in ("dense_tma_kernel", "dense_kernel",
                                "ln_rows_kernel")))
    print(f"  one UNet step under torch.profiler: kernels {busy:.2f} ms "
          f"against {step_ms:.2f} ms unprofiled (busy {busy / step_ms:.2f})"
          f"  [{card}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.3f} ms  {name[:90]}")


def run_emu2_gen(card: str, images) -> None:
    """Phase 14: the full-width Emu2-Gen (EVA-4B W8A8, LLaMA-33B int4, the
    SDXL UNet and VAE in bf16; random weights) at 1024², 50 Euler steps,
    CFG 3.0: a text prompt, an image + text prompt, an image alone
    (autoencoding); then one request over HTTP to /v1/mmg through the
    port's EmuHTTPServer and generation Helper (code 0, a 1024² WEBP)."""
    import base64
    import io
    import torch
    from PIL import Image
    from emu_tpu_torch.pipelines.visual_generation import EmuVisualGeneration
    from emu_tpu_torch.serving.backend import EmuHTTPServer, make_server
    from emu_tpu_torch.serving.helper import Helper

    t0 = time.perf_counter()
    pipe = EmuVisualGeneration.from_config(seed=SEED, device="cuda",
                                           quantize="int4")
    torch.cuda.synchronize()
    print(f"  built full Emu2-Gen (int4 decoder, W8A8 tower, bf16 SDXL UNet "
          f"and VAE) in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    figs = []
    for label, inputs in (
            ("text prompt", ["a red bicycle leaning on a stone wall"]),
            ("image + text prompt", [images[0], "in the style of a sketch"]),
            ("image alone (autoencoding)", [images[1]])):
        figs.append(generate_and_report(card, pipe, label, inputs, 1024,
                                        GEN_STEPS, 3.0))
    print(f"  SDXL UNet {figs[0]['unet_ms_per_step']:.2f} ms/step; 279.39 "
          "before the biased dense took kernel H (PERF.md section 5)")
    profile_unet_step(card, pipe, 128, pipe.emu_cfg.n_query,
                      figs[0]["unet_ms_per_step"])

    helper = Helper(lambda i: pipe, 1)
    httpd = make_server(EmuHTTPServer(None, helper), "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        t1 = time.perf_counter()
        res = post_form(httpd.server_address[1], {
            "log_id": "gen", "prompt": json.dumps(
                [["TEXT", "a lighthouse at dusk"]]),
            "classifier_free_guidance": "3.0", "steps": str(HTTP_GEN_STEPS)},
            {}, path="/v1/mmg")
        wall = time.perf_counter() - t1
    finally:
        httpd.shutdown()
    if res["code"] != 0:
        raise AssertionError(f"/v1/mmg: code {res['code']}: {res['data']}")
    img = Image.open(io.BytesIO(base64.b64decode(res["data"])))
    if img.format != "WEBP" or img.size != (1024, 1024):
        raise AssertionError(f"/v1/mmg: {img.format} {img.size}")
    print(f"  /v1/mmg over HTTP, {HTTP_GEN_STEPS} steps: code 0, a "
          f"{img.size[0]}x{img.size[1]} WEBP in {wall:.2f} s  [{card}]")
    # the server's handler and the thread hold the pipeline too
    del pipe, helper, httpd, server
    gc.collect()
    torch.cuda.empty_cache()


def run_emu1_gen(card: str, images):
    """Phase 15: the full-width Emu1 generation pipeline (ViT-g, Causal
    Former, LLaMA-13B, the SD1.5-class UNet with cross-attention 5120 and
    the SD1.5 VAE, bf16, random weights) at 512², 50 PLMS steps (51 UNet
    calls), CFG 7.5: a text prompt and an image + text prompt. Returns the
    pipeline (phase 19 runs the safety checker and the eval harness on
    it)."""
    import torch
    from emu_tpu_torch.pipelines.emu1_pipeline import EmuGenerationPipeline

    t0 = time.perf_counter()
    pipe = EmuGenerationPipeline.from_config(seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  built full Emu1 generation (bf16) in {time.perf_counter() - t0:.1f}"
          f" s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    figs = [generate_and_report(card, pipe, label, inputs, 512, GEN_STEPS,
                                7.5)
            for label, inputs in (
                ("text prompt", ["a bowl of fruit on a wooden table"]),
                ("image + text prompt", [images[2], "as a watercolor"]))]
    print(f"  SD1.5 UNet {figs[0]['unet_ms_per_step']:.2f} ms/step; 64.06 "
          "before the biased dense took kernel H (PERF.md section 5)")
    profile_unet_step(card, pipe, 64, pipe.emu_cfg.n_causal,
                      figs[0]["unet_ms_per_step"])
    return pipe


def png_bytes(image) -> bytes:
    import io
    buf = io.BytesIO()
    image.save(buf, "PNG")
    return buf.getvalue()


def post_form(port: int, fields: dict, files: dict, path: str = "/v1/mmc"
              ) -> dict:
    import io
    import urllib.request
    import uuid
    boundary = uuid.uuid4().hex
    out = io.BytesIO()
    for k, v in fields.items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{k}\"\r\n\r\n{v}\r\n".encode())
    for k, data in files.items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{k}\"; filename=\"{k}.png\"\r\n"
                  f"Content-Type: image/png\r\n\r\n".encode())
        out.write(data + b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=out.getvalue(),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def words(n: int, tag: str) -> str:
    """A prompt of n SimpleTokenizer tokens (one per word)."""
    return " ".join(f"{tag}{i}" for i in range(n))


def serve_mix(card: str, chat, draft, images, kv_quant: bool) -> dict:
    """Serve the request mix over HTTP through the objects `python -m
    emu_tpu_torch.serving` wires; returns {tag: (latency s, done at,
    reply)} and prints the mix's figures."""
    import torch
    from emu_tpu_torch.serving.backend import EmuHTTPServer, make_server
    from emu_tpu_torch.serving.continuous_helper import ContinuousChatHelper

    helper = ContinuousChatHelper(chat, max_slots=8, max_len=1024,
                                  draft=draft, kv_cache_quant=kv_quant,
                                  chunk_size=32, block_steps=8,
                                  per_request_sampling=True)
    eng = helper.engine
    # device span of each engine program: CUDA events around every decode
    # step, mixed step and bucket prefill (read once the mix is done; a
    # speculative request's kernels interleave on the same stream)
    spans = {"decode": [], "mixed": [], "prefill": []}

    def timed(kind, fn):
        def run(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a)
            end.record()
            spans[kind].append((start, end))
            return out
        return run

    eng._step_body = timed("decode", eng._step_body)
    eng._mixed = timed("mixed", eng._mixed)
    eng._prefill = timed("prefill", eng._prefill)
    finished = eng.finished
    n_tokens = [0]

    def counted_finished():
        out = finished()
        n_tokens[0] += sum(len(v) for v in out.values())
        return out

    eng.finished = counted_finished
    httpd = make_server(EmuHTTPServer(helper, None), "127.0.0.1", 0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    img = {"img0": png_bytes(images[0])}
    mix = [  # tag, prompt, files, new tokens, extra fields, post delay (s)
        ("image_q", [["IMAGE", "img0"], ["TEXT", "What is shown here?"]],
         img, 32, {}, 0.0),
        ("text200", [["TEXT", words(200, "a")]], {}, 128, {}, 0.0),
        ("text120", [["TEXT", words(120, "b")]], {}, 96, {}, 0.05),
        ("text160", [["TEXT", words(160, "c")]], {}, 48, {}, 0.1),
        ("text80", [["TEXT", words(80, "d")]], {}, 32, {}, 0.15),
        ("text40", [["TEXT", words(40, "e")]], {}, 64, {}, 0.2),
        ("text16", [["TEXT", words(16, "f")]], {}, 16, {}, 0.5),
        ("spec40", [["TEXT", words(40, "g")]], {}, 32,
         {"speculative": "true"}, 0.25),
        ("sample60", [["TEXT", words(60, "h")]], {}, 32,
         {"do_sample": "true", "temperature": "0.7"}, 0.3),
    ]
    done = {}
    t_start = time.perf_counter()

    def go(tag, prompt, files, new, extra, delay):
        time.sleep(delay)
        t0 = time.perf_counter()
        res = post_form(port, {"log_id": tag, "prompt": json.dumps(prompt),
                               "max_new_tokens": str(new), **extra}, files)
        t1 = time.perf_counter()
        done[tag] = (t1 - t0, t1, res)

    torch.cuda.reset_peak_memory_stats()
    threads = [threading.Thread(target=go, args=m) for m in mix]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t_start
    httpd.shutdown()
    helper.shutdown()
    if any(th.is_alive() for th in threads) or len(done) != len(mix):
        raise AssertionError("serving: a request did not come back")
    torch.cuda.synchronize()
    label = "int8 KV" if kv_quant else "bf16 KV (unjudged)"
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in spans.items()}
    n_steps = len(ms["decode"]) + len(ms["mixed"])
    E2E[f"served mix {'int8' if kv_quant else 'bf16'} KV tok/s"] = \
        n_tokens[0] / wall
    print(f"  [{label}] {len(mix)} requests in {wall:.2f} s: engine "
          f"{len(ms['decode'])} decode + {len(ms['mixed'])} mixed steps, "
          f"{wall * 1e3 / max(n_steps, 1):.2f} ms per step (wall / steps), "
          f"{n_tokens[0]} engine tokens, {n_tokens[0] / wall:.1f} "
          f"tok/s; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB"
          f"  [{card}]")
    print("    device spans: " + "; ".join(
        f"{k} {len(v)} x {sum(v) / max(len(v), 1):.2f} ms = "
        f"{sum(v) / 1e3:.2f} s" for k, v in ms.items())
        + f" (of {wall:.2f} s wall)")
    for tag, _, _, new, _, _ in mix:
        lat, _, res = done[tag]
        print(f"    {tag}: {new} new tokens, {lat * 1e3:.0f} ms, code "
              f"{res['code']} -> {str(res['data'])[:60]!r}")
    return helper, done


def run_serving(card: str, images, logit_err: float):
    """Phase 9: the full-depth Emu2-Chat int4 over HTTP, int8 KV (judged)
    then bf16 KV (unjudged). Returns the chat pipeline for phase 10."""
    import dataclasses
    import torch
    from emu_tpu_torch.generation.speculative import speculative_generate
    from emu_tpu_torch.models import llama
    from emu_tpu_torch.ops.layers import Init
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration

    t0 = time.perf_counter()
    chat = EmuChatGeneration.from_config(instruct=True, seed=SEED,
                                         device="cuda", quantize="int4")
    cfg = chat.cfg.llama
    dcfg = dataclasses.replace(cfg, num_hidden_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    draft = (llama.init(dcfg, Init(device="cuda", dtype=torch.bfloat16,
                                   generator=gen), fused=True, quant="int4"),
             dcfg)
    torch.cuda.synchronize()
    print(f"  built full Emu2-Chat int4 and a 1-layer draft in "
          f"{time.perf_counter() - t0:.1f} s")

    helper, done = serve_mix(card, chat, draft, images, kv_quant=True)
    bad = {t: r for t, (_, _, r) in done.items() if r["code"] != 0}
    if bad:
        raise AssertionError(f"serving: replies with code != 0: {bad}")
    if not done["text16"][1] < done["text200"][1]:
        raise AssertionError("serving: the shortest request, posted after "
                             "the longest, did not finish first")
    print("  every reply code 0; text16 (posted 0.5 s after text200) "
          "finished first")

    # speculative vs the engine's greedy stream, token by token: equal
    # wherever the greedy top-1/top-2 logit gap exceeds 2x phase 8's error
    eos = chat.tokenizer.eos_token_id
    emb, mask, ids = chat.embed_inputs([words(40, "g")])
    with torch.inference_mode():
        spec = speculative_generate(chat.params["decoder"], cfg, draft[0],
                                    dcfg, ids[0], max_new=32, k=4, eos=eos)
    eng = helper.engine
    rid = eng.submit(emb, mask, 32)
    greedy = eng.run_until_drained()[rid]
    helper.close()
    with torch.inference_mode():
        full = torch.tensor([list(ids[0]) + greedy[:-1]], device="cuda")
        cache = llama.init_cache(cfg, 1, full.shape[1], device="cuda")
        h, _ = llama.prefill(chat.params["decoder"], cfg,
                             llama.embed(chat.params["decoder"], full),
                             torch.ones_like(full), cache)
        top2 = llama.logits(chat.params["decoder"],
                            h[0, ids.shape[1] - 1:]).float().topk(2, -1)
    gaps = (top2.values[:, 0] - top2.values[:, 1]).tolist()
    n_eq = 0
    for t, (a, b) in enumerate(zip(spec, greedy)):
        if a != b:
            print(f"  speculative and engine greedy first differ at step {t}"
                  f" ({a} vs {b}; greedy top-1/top-2 gap {gaps[t]:.4f}, "
                  f"2x logit error {2 * logit_err:.4f})")
            if gaps[t] > 2 * logit_err:
                raise AssertionError("speculative decoding left the greedy "
                                     "stream where the greedy margin is "
                                     "wide")
            break
        n_eq += 1
    print(f"  speculative == engine greedy for {n_eq} of "
          f"{min(len(spec), len(greedy))} tokens (int8-KV engine vs "
          f"bf16-KV verify)")

    helper, _ = serve_mix(card, chat, draft, images, kv_quant=False)
    helper.close()
    torch.cuda.empty_cache()
    profile_engine_decode(card, chat)
    return chat


def profile_engine_decode(card: str, chat) -> None:
    """The engine's decode step alone (8 slots, int8 KV, no HTTP and no
    speculative thread): wall per step of one step_block(8), then the
    kernel time of the same block under torch.profiler, so busy = kernel
    time / unprofiled wall (the profiler slows the host, not the kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from emu_tpu_torch.generation.continuous import ContinuousEngine

    eng = ContinuousEngine(chat.params["decoder"], chat.cfg.llama,
                           max_slots=8, max_len=1024, eos_token_id=None,
                           kv_cache_quant=True)
    rows = []
    for i, n in enumerate((16, 40, 60, 80, 120, 160, 200, 200)):
        emb, mask, _ = chat.embed_inputs([words(n, f"p{i}_")])
        rows.append((emb, mask, 64))
    eng.submit_many(rows)
    with torch.inference_mode():
        eng.record_block(eng.step_block(8))          # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.record_block(eng.step_block(8))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 8 * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng.record_block(eng.step_block(8))
            torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / 8
    busy = sum(by_name.values())
    E2E["engine decode step alone ms"] = wall
    E2E["engine decode step kernel ms"] = busy
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  engine decode alone (8 slots, int8 KV, max_len 1024): "
          f"{wall:.2f} ms/step wall, kernels {busy:.2f} ms/step (busy "
          f"{busy / wall:.2f})  [{card}]")
    for name, t in top:
        print(f"    {t:8.3f} ms/step  {name[:90]}")
    eng.close()
    torch.cuda.empty_cache()


def check_paged(card: str, chat) -> None:
    """Phase 10: the paged KV lane at full width (the full-depth Emu2-Chat
    int4 decoder): paged_prefill_insert + 8 paged_decode_steps against the
    dense cache's decode_step_rows, teacher-forced, bf16 and int8; logits
    within kernel D's tolerance (1e-2 + 1e-2 * max|ref|)."""
    import torch
    from emu_tpu_torch.generation import paged_kv
    from emu_tpu_torch.models import llama

    dec, cfg = chat.params["decoder"], chat.cfg.llama
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    ids = torch.randint(3, cfg.vocab_size, (2, 64), device=dev, generator=g)
    forced = torch.randint(3, cfg.vocab_size, (8, 2), device=dev,
                           generator=g)
    page, per_row = 16, 8                 # 128 logical positions per row
    one = torch.ones(1, 64, dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for quant in (False, True):
            dense = llama.init_cache(cfg, 2, page * per_row, device=dev,
                                     quant=quant)
            paged = paged_kv.init_paged_cache(cfg, 2 * per_row + 4, page,
                                              max_slots=2,
                                              pages_per_slot=per_row,
                                              device=dev, quant=quant)
            alloc = paged_kv.PageAllocator(2 * per_row + 4)
            alloc.alloc(3)                # so the pages are not in order
            for r in range(2):
                emb = llama.embed(dec, ids[r:r + 1])
                small = llama.init_cache(cfg, 1, 64, device=dev, quant=quant)
                _, small = llama.prefill(dec, cfg, emb, one, small)
                for n, plane in dense.items():
                    plane[:, r:r + 1, :, :64] = small[n]
                paged_kv.paged_prefill_insert(dec, cfg, paged, emb, one,
                                              alloc.alloc(5), r)
            slots = torch.full((2,), 64, device=dev)
            mask = torch.zeros(2, page * per_row, dtype=torch.bool,
                               device=dev)
            mask[:, :64] = True
            err = 0.0
            for t in range(8):
                mask[:, 64 + t] = True
                emb = llama.embed(dec, forced[t][:, None])
                hd, _ = llama.decode_step_rows(dec, cfg, dense, emb, slots,
                                               mask, slots)
                hp, _ = paged_kv.paged_decode_step(dec, cfg, paged, emb,
                                                   slots, mask, slots)
                r = compare(f"paged_{'int8' if quant else 'bf16'}_step{t}",
                            llama.logits(dec, hp[:, 0]),
                            llama.logits(dec, hd[:, 0]), 1e-2, 1e-2)
                err = max(err, r["max_abs_err"])
                slots = slots + 1
            print(f"  paged lane {'int8' if quant else 'bf16'}: 8 steps, "
                  f"max |logit diff| vs dense {err:.6g}")
    print(f"  paged lane in {time.perf_counter() - t0:.1f} s  [{card}]")


def eva02_l_config(layers: int = 24):
    """EVA02-CLIP-L-14's published vision widths (EVA-CLIP's
    EVA02-CLIP-L-14.json: 24 x 1024, heads of 64, mlp_ratio 2.6667 ->
    hidden 2730, patch 14 at 224 px, 257 tokens, SwiGLU MLP, 2-D RoPE with
    pt_hw_seq_len 16 and intp_freq), with one cut: sub-LN off (the
    published config sets it), since a sub-LN keeps the MLP off the fused
    kernel in both packages. No shipped config sets naiveswiglu."""
    from emu_tpu_torch.config import VisionConfig
    return VisionConfig(image_size=224, patch_size=14, width=1024,
                        layers=layers, head_width=64, mlp_ratio=2.6667,
                        naiveswiglu=True, subln=False, rope=True,
                        pt_hw_seq_len=16, intp_freq=True)


def run_swiglu_vit(card: str) -> None:
    """Phase 16: the SwiGLU ViT at EVA02-CLIP-L widths through
    vit.forward_features: 2 layers, card (bf16: kernel H, the RoPE route's
    attention, kernel B's SwiGLU form) against the CPU (fp32, plain), limit
    0.05 * max|ref| stated before the first run; then all 24 layers at
    batch 32, images per second from CUDA events over 3 forwards."""
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.models import vit
    from emu_tpu_torch.ops.layers import Init

    cfg2 = eva02_l_config(2)
    assert (cfg2.mlp_hidden, cfg2.num_heads, cfg2.seq_len) == (2730, 16, 257)
    params = vit.init(cfg2, Init(generator=torch.Generator().manual_seed(
        SEED)))
    images = torch.randn(2, 224, 224, 3,
                         generator=torch.Generator().manual_seed(SEED)) * 0.5
    with torch.inference_mode():
        ref = vit.forward_features(params, cfg2, images)
        got = vit.forward_features(cast_tree(params, "cuda", torch.bfloat16),
                                   cfg2, images.to("cuda", torch.bfloat16))
    assert got.shape == (2, 257, 1024)
    compare("swiglu_vit_2layer_card_bf16_vs_cpu_fp32", got.cpu(), ref,
            atol=0.0, rtol=0.05)

    cfg = eva02_l_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = vit.init(cfg, Init(device="cuda", dtype=torch.bfloat16,
                                generator=gen))
    x = (torch.randn(32, 224, 224, 3, device="cuda", generator=gen) * 0.5
         ).to(torch.bfloat16)
    with torch.inference_mode():
        out = vit.forward_features(params, cfg, x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            out = vit.forward_features(params, cfg, x)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 3
    if out.shape != (32, 257, 1024) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"swiglu vit: {tuple(out.shape)} or non-finite")
    E2E["SwiGLU ViT img/s"] = 32e3 / ms
    print(f"  SwiGLU ViT (EVA02-CLIP-L widths, sub-LN off), 24 layers, batch "
          f"32 at 224 px: {ms:.2f} ms per forward, {32e3 / ms:.1f} img/s; "
          f"output finite  [{card}]")
    del params, x, out
    torch.cuda.empty_cache()


def run_vit_parts(card: str) -> None:
    """Phase 17: the ViT-parts bench (`emu_tpu_torch.tools.
    bench_vit_parts`) at ViT-g's and EVA-4B's shapes on the card, with its
    W8A8 part (kernel E beside the int8 probe and kernel B)."""
    import torch
    from emu_tpu_torch.tools import bench_vit_parts
    for model in ("g", "4b"):
        bench_vit_parts.run(model, "cuda", out=lambda ln: print(f"  {ln}"),
                            int8=True)
        torch.cuda.empty_cache()


# phase 18 writes its synthesized checkpoints here (ignored by git) and
# removes them when it ends
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# phase 18's shard cap: the 2-layer Emu1's 2.1 GB of bf16 in >= 3 shards
SHARD_BYTES = 768 * 2 ** 20


def synced(fn):
    """(fn(), seconds), timed with the card synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def path_bytes(path: Path) -> int:
    if path.is_file():
        return path.stat().st_size
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def report_load(card: str, label: str, path: Path, write_s: float,
                load_s: float) -> None:
    nbytes = path_bytes(path)
    E2E[f"checkpoint {label} load GB/s"] = nbytes / 1e9 / load_s
    print(f"  {label}: {nbytes / 1e9:.3f} GB written in {write_s:.2f} s, "
          f"loaded onto the card in {load_s:.2f} s, "
          f"{nbytes / 1e9 / load_s:.2f} GB/s (files in the page cache)  "
          f"[{card}]")


def equal_trees(label: str, got, want) -> None:
    """Every leaf of `got` equals `want`'s: names, dtypes, shapes, bits."""
    import torch
    from emu_tpu_torch.bridge import flatten
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w), f"{label}: leaves differ {set(g) ^ set(w)}"
    bad = [k for k, v in w.items()
           if g[k].dtype != v.dtype or g[k].shape != v.shape
           or not torch.equal(g[k], v)]
    assert not bad, f"{label}: leaves not equal: {bad[:6]}"
    print(f"  {label}: {len(w)} leaves equal, bit for bit")


def run_checkpoints(card: str, images) -> None:
    """Phase 18: checkpoints at full width, synthesized from seeded trees
    drawn on the card (`synth.invert_*`) and loaded back onto it, with the
    bytes, seconds and GB/s of each load: the 2-layer Emu1 (phase 4's) as
    an HF sharded .bin in bf16 (>= 3 shards) and a copy with peft LoRA
    pairs on q/k/v/o; the 2-layer Emu2-Chat (phase 6's) as one bf16
    .safetensors, loaded in bf16 and int4; the whole SD1.5-class UNet and
    its VAE as diffusers component dirs. Every loaded leaf equals the
    written tree (LoRA: the tree merged on the host), the Emu1 caption
    tokens equal the drawn tree's, and the int4 tree has the bits of
    `EmuChatGeneration(tree, quantize="int4")` (what from_config does)."""
    import shutil
    import torch
    from emu_tpu_torch import checkpoint as ck
    from emu_tpu_torch import synth
    from emu_tpu_torch.cli.inference import (Emu1Runner, image_system_msg,
                                             tokenizer_for)
    from emu_tpu_torch.cli.inference import with_depth as emu1_depth
    from emu_tpu_torch.config import (Emu1Config, Emu2Config, UNetConfig,
                                      VAEConfig)
    from emu_tpu_torch.diffusion import unet, vae
    from emu_tpu_torch.models import emu1, emu2
    from emu_tpu_torch.ops.layers import Init
    from emu_tpu_torch.ops.lora import merge_lora_state_dict
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration
    from emu_tpu_torch.pipelines.chat import with_depth as emu2_depth

    bf = torch.bfloat16
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    CKPT_DIR.mkdir(parents=True)
    free = shutil.disk_usage(CKPT_DIR).free
    print(f"  {free / 1e9:.1f} GB free under {CKPT_DIR.relative_to(ROOT)}")
    assert free > 16e9, "phase 18 writes about 10 GB of checkpoints"

    def init(seed):
        return Init(device="cuda", dtype=bf, generator=card_generator(seed))

    try:
        # Emu1, 2 layers at full width: an HF sharded .bin in bf16
        cfg = emu1_depth(Emu1Config(), 2)
        tree = emu1.init(cfg, init(SEED))
        sd = synth.invert_emu1(tree, cfg)
        path = CKPT_DIR / "emu1"
        index, write_s = synced(lambda: synth.save_sharded(
            sd, str(path), SHARD_BYTES, bf))
        with open(index) as f:
            shards = len(set(json.load(f)["weight_map"].values()))
        assert shards >= 3, f"{shards} shards"
        loaded, load_s = synced(lambda: ck.load_emu1_checkpoint(
            str(path), cfg, bf, "cuda"))
        report_load(card, f"Emu1 2-layer sharded .bin ({shards} shards)",
                    path, write_s, load_s)
        equal_trees("Emu1 2-layer against the written tree", loaded, tree)

        def caption(t):
            r = Emu1Runner(emu1.Emu1(cfg, t), cfg, tokenizer_for(cfg))
            return r.generate_ids([images[0]], [r.caption_prompt()],
                                  system=image_system_msg,
                                  max_new_tokens=MAX_NEW, beam_size=5)

        assert torch.equal(caption(loaded), caption(tree)), \
            "the loaded Emu1's caption differs from the drawn tree's"
        print("  Emu1 2-layer: the loaded tree's beam-5 caption tokens equal "
              "the drawn tree's")
        del loaded

        # the same with peft LoRA pairs (r 16) on q/k/v/o, merged on load
        g = card_generator(SEED + 5)
        lora = dict(sd)
        qkvo = [f"decoder.lm.model.layers.{i}.self_attn.{n}_proj"
                for i in range(2) for n in "qkvo"]
        for base in qkvo:
            out_f, in_f = sd[base + ".weight"].shape
            lora[base + ".lora_A.weight"] = (torch.randn(
                16, in_f, generator=g, device="cuda") * 0.02).to(bf)
            lora[base + ".lora_B.weight"] = (torch.randn(
                out_f, 16, generator=g, device="cuda") * 0.02).to(bf)
        path = CKPT_DIR / "emu1_lora"
        _, write_s = synced(lambda: synth.save_sharded(
            lora, str(path), SHARD_BYTES, bf))
        loaded, load_s = synced(lambda: ck.load_emu1_checkpoint(
            str(path), cfg, bf, "cuda"))
        report_load(card, "Emu1 2-layer + LoRA sharded .bin", path, write_s,
                    load_s)
        host = merge_lora_state_dict({k: v.cpu() for k, v in lora.items()
                                      if any(k.startswith(b) for b in qkvo)})
        want = {k: v for k, v in tree.items()}
        dec = dict(tree["decoder"])
        layers = dict(dec["layers"])
        attn = {n: dict(p) for n, p in layers["self_attn"].items()}
        for n in "qkvo":
            attn[f"{n}_proj"]["kernel"] = torch.stack([
                host[f"decoder.lm.model.layers.{i}.self_attn.{n}_proj.weight"]
                .t() for i in range(2)]).cuda()
        layers["self_attn"] = attn
        dec["layers"] = layers
        want["decoder"] = dec
        equal_trees("Emu1 2-layer + LoRA (merged on the host)", loaded, want)
        del loaded, lora, sd, tree, want, host

        # Emu2-Chat, 2 layers at full width: one bf16 .safetensors
        cfg2 = emu2_depth(Emu2Config.chat(), 2)
        tree2 = emu2.init(cfg2, init(SEED + 1))
        path = CKPT_DIR / "emu2_chat.safetensors"
        _, write_s = synced(lambda: synth.write_safetensors(
            synth.invert_emu2(tree2, cfg2), str(path), bf))
        pipe, load_s = synced(lambda: EmuChatGeneration.from_pretrained(
            str(path), instruct=True, dtype=bf, device="cuda", depth=2,
            fuse=False))
        report_load(card, "Emu2-Chat 2-layer .safetensors bf16", path,
                    write_s, load_s)
        equal_trees("Emu2-Chat 2-layer bf16 against the written tree",
                    pipe.params, tree2)
        del pipe
        pipe, load_s = synced(lambda: EmuChatGeneration.from_pretrained(
            str(path), instruct=True, dtype=bf, device="cuda", depth=2,
            quantize="int4"))
        report_load(card, "Emu2-Chat 2-layer .safetensors -> int4", path,
                    write_s, load_s)
        ref = EmuChatGeneration(tree2, cfg2, quantize="int4")
        equal_trees("Emu2-Chat 2-layer int4 (against from_config's "
                    "quantization of the same tree)", pipe.params,
                    ref.params)
        ids = pipe.generate_ids([[images[0], "What is shown here?"]],
                                num_beams=1, max_new_tokens=4)
        assert ids.shape == (1, 4)
        del pipe, ref, tree2, ids

        # the SD1.5-class UNet (0.968 B) and its VAE: diffusers dirs
        ucfg, vcfg = UNetConfig.emu1_sd15(), VAEConfig.sd15()
        u, v = unet.init(ucfg, init(SEED + 2)), vae.init(vcfg, init(SEED + 3))
        upath, vpath = CKPT_DIR / "sd15" / "unet", CKPT_DIR / "sd15" / "vae"
        _, write_s = synced(lambda: synth.write_safetensors(
            synth.invert_unet(u, ucfg, {}),
            str(upath / "diffusion_pytorch_model.safetensors"), bf))
        loaded, load_s = synced(lambda: ck.convert_unet(
            ck.load_state_dict(str(upath)), ucfg, bf, "cuda"))
        report_load(card, "SD1.5 UNet diffusers dir (.safetensors)", upath,
                    write_s, load_s)
        equal_trees("SD1.5 UNet against the written tree", loaded, u)
        vpath.mkdir(parents=True)
        _, write_s = synced(lambda: torch.save(
            {k: t.to("cpu") for k, t in synth.invert_vae(v, vcfg, {}).items()},
            vpath / "diffusion_pytorch_model.bin"))
        loaded, load_s = synced(lambda: ck.convert_vae(
            ck.load_state_dict(str(vpath)), vcfg, bf, "cuda"))
        report_load(card, "SD1.5 VAE diffusers dir (.bin)", vpath, write_s,
                    load_s)
        equal_trees("SD1.5 VAE against the written tree", loaded, v)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


# --- phase 19: CLIP, the safety checker, the pooler, the eval harness and
# device preprocessing ---------------------------------------------------

CLIP_BATCH = 32


def tree_fingerprint(tree) -> dict:
    """{leaf path: [per-slice sums of its bit patterns]}, integer sums, so
    equal trees give equal fingerprints whatever the reduction order; a
    stacked leaf is summed one layer at a time."""
    import torch
    from emu_tpu_torch import bridge
    out = {}
    for name, t in bridge.flatten(tree).items():
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]
        out[name] = [int(s.view(bits).sum()) for s in
                     (t if t.dim() > 2 else (t,))]
    return out


def clip_ids(n: int, seed: int, cfg):
    """[n, max positions] seeded ids of a CLIPTextConfig's vocab with the
    eot (the vocab's last id) once a row and padding after it, as CLIP's
    tokenizer writes a prompt."""
    import numpy as np
    rng = np.random.RandomState(seed)
    vocab, length = cfg.vocab_size, cfg.max_position_embeddings
    ids = rng.randint(1, vocab - 2, (n, length))
    for i, end in enumerate(rng.randint(length // 8, length, n)):
        ids[i, end] = vocab - 1
        ids[i, end + 1:] = 0
    return ids


def check_clip_two_layer(card: str) -> None:
    """Phase 19 (a): CLIP at openai/clip-vit-large-patch14's widths, two
    layers a tower, card bf16 against the CPU fp32, 0.05 * max|ref|:
    image_embeds, text_embeds, clip_score and the similarity logits (the
    scores' cosines before the clamp at 0)."""
    import dataclasses
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.models import clip as C
    from emu_tpu_torch.ops.layers import Init

    full = C.CLIPConfig()
    cfg = C.CLIPConfig(
        vision=dataclasses.replace(full.vision, num_layers=2),
        text=dataclasses.replace(full.text, num_layers=2))
    cpu = C.init(cfg, Init(generator=torch.Generator().manual_seed(SEED)))
    gpu = cast_tree(cpu, "cuda", torch.bfloat16)
    g = torch.Generator().manual_seed(SEED + 1)
    size = cfg.vision.image_size
    pix = torch.randn(4, size, size, 3, generator=g).to(torch.bfloat16)
    ids = torch.from_numpy(clip_ids(4, SEED, cfg.text))
    with torch.inference_mode():
        for name, fn in (
                ("image_embeds", lambda p, x, t: C.image_embeds(p, cfg, x)),
                ("text_embeds",
                 lambda p, x, t: C.text_embeds(p["text"], cfg.text, t)),
                ("clip_score",
                 lambda p, x, t: C.clip_score(p, cfg, x, t)),
                ("similarity_logits",       # the unclamped cosines, scaled
                 lambda p, x, t: C.similarity_logits(p, cfg, x, t)[0])):
            ref = fn(cpu, pix.float(), ids)
            got = fn(gpu, pix.cuda(), ids.cuda())
            compare(f"clip_2layer_{name}_card_bf16_vs_cpu_fp32", got.cpu(),
                    ref, atol=0.0, rtol=0.05)


def run_clip_full(card: str) -> None:
    """Phase 19 (b): the full CLIP ViT-L/14 on the card (random bf16
    weights): evaluate_clip_score of 32 seeded 256x320 images against 32
    seeded prompts (fp32 pixels: the towers compute in the pixels' dtype),
    then the image tower at batch 32 in bf16 and the text tower, timed."""
    import numpy as np
    import torch
    from emu_tpu_torch.mm_eval.metrics.clip_score import evaluate_clip_score
    from emu_tpu_torch.models import clip as C
    from emu_tpu_torch.ops.layers import Init

    cfg = C.CLIPConfig()
    params = C.init(cfg, Init(device="cuda", dtype=torch.bfloat16,
                              generator=card_generator(SEED)))
    rng = np.random.RandomState(SEED)
    images01 = rng.rand(CLIP_BATCH, 256, 320, 3).astype(np.float32)
    ids = clip_ids(CLIP_BATCH, SEED + 1, cfg.text)
    t0 = time.perf_counter()
    out = evaluate_clip_score(params, cfg, images01, ids,
                              batch_size=CLIP_BATCH)
    score_s = time.perf_counter() - t0
    scores = np.asarray(out["scores"])
    if scores.shape != (CLIP_BATCH,) or not np.isfinite(scores).all() or \
            not ((scores >= 0) & (scores <= 100)).all():
        raise AssertionError(f"clip scores {scores}")
    with torch.inference_mode():
        pix = C.clip_preprocess(images01, cfg.vision.image_size,
                                "cuda").to(torch.bfloat16)
        ids_t = torch.from_numpy(ids).cuda()
        img_ms = cuda_ms(lambda: C.image_embeds(params, cfg, pix), 5, 1)
        txt_ms = cuda_ms(lambda: C.text_embeds(params["text"], cfg.text,
                                               ids_t), 5, 1)
    E2E["CLIP ViT-L/14 image_embeds img/s"] = CLIP_BATCH / img_ms * 1e3
    E2E["CLIP text_embeds prompts/s"] = CLIP_BATCH / txt_ms * 1e3
    print(f"  evaluate_clip_score, {CLIP_BATCH} images (fp32 pixels): "
          f"{score_s:.2f} s, CLIP score {out['clip_score']:.3f}; image_embeds"
          f" at batch {CLIP_BATCH}, bf16 pixels: {img_ms:.2f} ms, "
          f"{CLIP_BATCH / img_ms * 1e3:.1f} img/s; text_embeds of "
          f"{CLIP_BATCH} x {ids.shape[1]} tokens: {txt_ms:.2f} ms, "
          f"{CLIP_BATCH / txt_ms * 1e3:.1f} prompts/s  [{card}]")


def run_safety_checker(card: str, pipe, images) -> None:
    """Phase 19 (c): the SafetyChecker at full width (CLIP ViT-L/14, 17 + 3
    concepts, fp32 on the card) on two 512² images (noise; a flat dark
    red). A random tower maps any two images to nearly parallel embeddings,
    so concept 0 is the part of image 0's projected embedding orthogonal to
    image 1's, with its threshold at half image 0's cosine with it (and
    the special-care thresholds out of reach): image 0 is flagged and
    blacked out, image 1 (cosine 0) is not, and the CPU fp32 run's flags
    are the same. Then the checker rides one image + text
    request of phase 15's EmuGenerationPipeline."""
    import numpy as np
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.models import safety_checker as SC
    from emu_tpu_torch.ops.layers import Init

    cfg = SC.CLIPVisionConfig()
    params = SC.init(cfg, Init(device="cuda", generator=card_generator(
        SEED + 2)))
    rng = np.random.RandomState(SEED + 2)
    images01 = rng.rand(2, 512, 512, 3).astype(np.float32)
    images01[1] = np.asarray([0.6, 0.1, 0.1], np.float32)
    with torch.inference_mode():
        emb = SC.clip_image_embeds(params, cfg, SC.clip_preprocess(
            images01, cfg.image_size, "cuda"))
        e0, e1 = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        concept = e0 - (e0 @ e1) * e1
        concept = concept / torch.linalg.vector_norm(concept)
        sim, own = float(e0 @ e1), float(e0 @ concept)
    if not own > 2e-3:
        raise AssertionError(f"safety checker: the two images' embeddings "
                             f"are too alike to tell apart (cos {sim})")
    params["concept_embeds"][0] = concept
    params["concept_embeds_weights"][0] = own / 2
    # special-care scores add 0.01 to an image's concept scores: thresholds
    # above 1 keep that shift off image 1's margin (the CPU tests hold the
    # adjustment to the JAX package)
    params["special_care_embeds_weights"].fill_(1.5)
    checker = SC.SafetyChecker(params, cfg)
    checker(images01)                                   # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, flags = checker(images01)
    ms = (time.perf_counter() - t0) * 1e3 / len(images01)
    cpu_out, cpu_flags = SC.SafetyChecker(cast_tree(params, "cpu"),
                                          cfg)(images01)
    print(f"  safety checker: cos(image 0, image 1) {sim:.6f}; concept 0 "
          f"at cos {own:.6f} from image 0, threshold {own / 2:.6f}; flags "
          f"{flags} (CPU fp32 "
          f"{cpu_flags}); {ms:.1f} ms per image  [{card}]")
    if flags != [True, False] or cpu_flags != flags:
        raise AssertionError(f"safety flags {flags}, CPU {cpu_flags}")
    if out[0].max() != 0 or not np.array_equal(out[1], images01[1]) or \
            not np.array_equal(cpu_out, out):
        raise AssertionError("safety checker: the blacked-out images differ")
    pipe.safety_checker = checker
    try:
        image, nsfw = pipe([images[2], "as a watercolor"], height=512,
                           width=512, num_inference_steps=20,
                           generator=torch.Generator("cuda").manual_seed(SEED))
    finally:
        pipe.safety_checker = None
    if image.size != (512, 512) or not (
            isinstance(nsfw, list) and len(nsfw) == 1
            and isinstance(nsfw[0], bool)):
        raise AssertionError(f"generation with the checker: {nsfw}")
    print(f"  EmuGenerationPipeline with the checker, 20 PLMS steps at 512²: "
          f"nsfw_content_detected {nsfw}")


def check_pooler(card: str) -> None:
    """Phase 19 (d): the attentional pooler at open_clip's CoCa ViT-L/14
    widths (width 768, context 1024, 256 queries, 8 heads) over 257 tokens,
    batch 8, card bf16 against the CPU fp32, 0.05 * max|ref|."""
    import torch
    from emu_tpu_torch.bridge import cast_tree
    from emu_tpu_torch.ops import pooler as P
    from emu_tpu_torch.ops.layers import Init

    g = torch.Generator().manual_seed(SEED + 3)
    cpu = P.attentional_pooler_init(768, 1024, Init(generator=g))
    tokens = torch.randn(8, 257, 1024, generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        ref = P.attentional_pooler(cpu, tokens.float(), n_head=8)
        got = P.attentional_pooler(cast_tree(cpu, "cuda", torch.bfloat16),
                                   tokens.cuda(), n_head=8)
    if got.shape != (8, 256, 768):
        raise AssertionError(f"pooler output {tuple(got.shape)}")
    compare("attentional_pooler_card_bf16_vs_cpu_fp32", got.cpu(), ref,
            atol=0.0, rtol=0.05)


def write_eval_files(root: Path, images) -> None:
    """Synthetic annotation files: COCO (2 images, a gt file), VizWiz (1
    question), VisDial (1 dialog of 1 round, 100 options)."""
    names = [f"COCO_val2014_{i:012d}.jpg" for i in range(2)]
    for rel, img in ((f"coco/images/{names[0]}", images[3]),
                     (f"coco/images/{names[1]}", images[4]),
                     ("vizwiz/val/VizWiz_val_0.jpg", images[5]),
                     ("visdial/VisualDialog_val2018/"
                      "VisualDialog_val2018_000000000007.jpg", images[6])):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        img.save(root / rel)

    def dump(rel, obj):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(obj))

    dump("coco/annotations/coco_karpathy_test.json",
         [{"image": n, "caption": ["a test image"]} for n in names])
    dump("coco/annotations/coco_karpathy_test_gt.json", {"annotations": [
        {"image_id": i, "caption": c} for i in range(2)
        for c in ("a photo of noise", "random colored pixels")]})
    dump("vizwiz/val.json", [{"image": "VizWiz_val_0.jpg",
                              "question": "what is this"}])
    dump("visdial/visdial_1.0_val.json", {"data": {
        "questions": ["what is in the picture"],
        "answers": [f"answer number {i}" for i in range(100)],
        "dialogs": [{"image_id": 7, "caption": "a picture", "dialog": [
            {"question": 0, "answer": 3,
             "answer_options": list(range(100))}]}]}})


def run_eval_harness(card: str, pipe, fingerprint: dict, images) -> None:
    """Phase 19 (e): `evaluate_engine` with EmuEvalModel over phase 5's
    full-depth Emu1 tree, held here by phase 15's pipeline (the same seed
    draws the same bits: checked against phase 5's fingerprint), on COCO
    (beam 5, gt metrics), VizWiz (beam 5 + trie answerability) and VisDial
    (100 options ranked by loss, 100 one-row forwards)."""
    import math
    import tempfile
    import torch
    from emu_tpu_torch.cli.inference import tokenizer_for
    from emu_tpu_torch.mm_eval.engine import EvalArguments, evaluate_engine
    from emu_tpu_torch.mm_eval.model import EmuEvalModel

    model = EmuEvalModel(pipe.emu_params, pipe.emu_cfg,
                         tokenizer_for(pipe.emu_cfg))
    if tree_fingerprint(model.params) != fingerprint:
        raise AssertionError("phase 15's Emu1 tree is not phase 5's")
    print("  the eval model's tree is phase 5's, leaf for leaf (fingerprint)")
    answerability = []
    answer = model.generate_answerability

    def recorded(samples, candidates):
        out = answer(samples, candidates)
        answerability.extend(out)
        return out
    model.generate_answerability = recorded
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_eval_files(root, images)
        for name, n, out_file in (("coco", 2, "coco_answer.json"),
                                  ("vizwiz", 1, "vizwiz_answer.json"),
                                  ("visdial", 1, "visdial_answer.json")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metric = evaluate_engine(model, EvalArguments(
                output_path=str(root / "out"), dataset_name=name,
                batch_size=2, root_path=str(root)))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            saved = json.loads((root / "out" / out_file).read_text())
            if len(saved) != n:
                raise AssertionError(f"{name}: {len(saved)} answers, not {n}")
            if name == "coco" and not all(math.isfinite(v)
                                          for v in metric.values()):
                raise AssertionError(f"coco metrics {metric}")
            if name != "coco" and metric["n"] != n:
                raise AssertionError(f"{name}: n = {metric['n']}")
            if name == "vizwiz" and not all(
                    a.strip() in ("yes", "no") for a in answerability):
                raise AssertionError(f"answerability {answerability}")
            if name == "visdial" and sorted(saved[0]["ranks"]) != list(
                    range(100)):
                raise AssertionError("visdial ranks are not a permutation")
            E2E[f"eval {name} s/sample"] = dt / n
            shown = {k: round(v, 4) for k, v in metric.items()
                     if k != "file"}
            print(f"  {name}: {n} sample(s) in {dt:.2f} s, {dt / n:.2f} "
                  f"s/sample; {shown}"
                  f"{'; answerability ' + str(answerability) if name == 'vizwiz' else ''}"
                  f"  [{card}]")
    del model


def run_device_preprocess(card: str, chat, images) -> None:
    """Phase 19 (f): device_preprocess on the card against the port's CPU
    run (1e-5) and the PIL host path (mean abs < 0.15, corr > 0.98, the
    JAX package's bounds), then one image request through phase 7's
    Emu2-Chat int4 tree in preprocess_mode="device": its image batch is
    device_preprocess of the same bytes; ms per image of both paths."""
    import numpy as np
    import torch
    from emu_tpu_torch.pipelines import preprocess as pre
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration

    size = chat.cfg.vision.image_size
    raw = np.array(pre.to_uint8_rgb(images[0]))
    card_x = pre.device_preprocess(torch.from_numpy(raw).cuda()[None], size)
    cpu_x = pre.device_preprocess(torch.from_numpy(raw)[None], size)
    compare("device_preprocess_card_vs_cpu", card_x.cpu(), cpu_x, atol=1e-5,
            rtol=0.0)
    host = pre.preprocess_image(images[0], size)
    dev = card_x[0].cpu().numpy()
    mean_abs = float(np.abs(host - dev).mean())
    corr = float(np.corrcoef(host.ravel(), dev.ravel())[0, 1])
    print(f"  device vs PIL host path at {size}²: mean |diff| {mean_abs:.4f}"
          f" (< 0.15), corr {corr:.5f} (> 0.98)")
    if not (mean_abs < 0.15 and corr > 0.98):
        raise AssertionError("device_preprocess strays from the host path")
    dev_chat = EmuChatGeneration(chat.params, chat.cfg, chat.tokenizer,
                                 preprocess_mode="device")
    want = pre.device_preprocess(torch.from_numpy(raw).cuda()[None],
                                 size).to(dev_chat._img_dtype)
    if not torch.equal(dev_chat._image_batch([dev_chat._preprocess(
            images[0])]), want):
        raise AssertionError("device-mode image batch != device_preprocess")

    def per_image_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    host_ms = per_image_ms(lambda: chat._image_batch([chat._preprocess(
        images[0])]))
    dev_ms = per_image_ms(lambda: dev_chat._image_batch(
        [dev_chat._preprocess(images[0])]))
    ids = dev_chat.generate_ids([[images[0], "What is shown here?"]],
                                max_new_tokens=MAX_NEW)
    vocab = chat.cfg.llama.extended_vocab_size
    if ids.shape != (1, MAX_NEW) or int(ids.max()) >= vocab:
        raise AssertionError(f"device-mode chat ids {tuple(ids.shape)}")
    text = dev_chat.tokenizer.batch_decode(ids.cpu().numpy())[0]
    st = dev_chat.last_stats
    E2E["device preprocess ms/image"] = dev_ms
    E2E["host preprocess ms/image"] = host_ms
    print(f"  preprocessing a {images[0].size[0]}x{images[0].size[1]} image "
          f"to {size}²: host (PIL + copy) {host_ms:.2f} ms, device (raw "
          f"bytes + resize on the card) {dev_ms:.2f} ms per image; device-"
          f"mode request: encode {st['encode_s'] * 1e3:.1f} ms, prefill "
          f"{st['prefill_s'] * 1e3:.1f} ms  [{card}]")
    print(f"    -> {text[:120]!r}")


# one backward design replaces both TPU tiers: _flash_bwd_whole and
# _flash_bwd_tiled
BWD_REPLACES = ("emu_tpu/ops/flash_attention.py:938, "
                "emu_tpu/ops/flash_attention.py:778")
KERNELS = [  # name, source, replaces, wrapper, checks (first one timed)
    ("attention", "emu_tpu_torch/csrc/attention.cu",
     "emu_tpu/ops/flash_attention.py:487", "A.attention",
     ["attention_vit_8x16x257x88", "attention_causal_8x40x80x128",
      "attention_causal_1x52x330x128",
      "attention_vit_1x16x1025x112", "attention_causal_1x8x8192x128",
      "attention_noncausal_2x4096x10x64", "attention_noncausal_2x4096x8x40",
      "attention_noncausal_2x1024x20x64", "attention_noncausal_2x1024x8x80",
      "attention_noncausal_32x257x16x64", "cross_2x4096x10x64_kv64",
      "cross_2x1024x20x64_kv64", "cross_2x4096x8x40_kv32",
      "cross_2x1024x8x80_kv32", "attention_causal_32x12x77x64",
      "cross_8x256x8x96_kv257"]),
    ("batched_mha", "emu_tpu_torch/csrc/batched_mha.cu",
     "emu_tpu/ops/flash_attention.py:250", "A.batched_mha",
     ["batched_mha_2x1024x20x64", "batched_mha_2x1024x8x80",
      "batched_mha_2x256x8x160", "batched_mha_2x64x8x160",
      "batched_mha_2x257x8x256", "batched_mha_2x4096x10x64",
      "batched_mha_2x4096x8x40", "batched_mha_32x257x16x64"]),
    ("attention_lse", "emu_tpu_torch/csrc/attention.cu",
     "emu_tpu/ops/flash_attention.py:559", "A.attention:lse",
     ["attention_lse_causal_2x40x1024x128"]),
    ("attention_bwd_dq", "emu_tpu_torch/csrc/attention_bwd.cu",
     BWD_REPLACES, "A.attention_bwd_dq",
     ["attention_bwd_dq_2x40x1024x128", "attention_bwd_dq_gqa2_2x40x1024x128",
      "attention_bwd_dq_1x8x4096x128"]),
    ("attention_bwd_dkv", "emu_tpu_torch/csrc/attention_bwd.cu",
     BWD_REPLACES, "A.attention_bwd_dkv",
     ["attention_bwd_dkv_2x40x1024x128",
      "attention_bwd_dkv_gqa2_2x40x1024x128",
      "attention_bwd_dkv_1x8x4096x128"]),
    ("rmsnorm_bwd", "emu_tpu_torch/csrc/rmsnorm.cu",
     "emu_tpu/ops/fused_norm.py:139", "C.rmsnorm_bwd",
     ["rmsnorm_bwd_add_2048x5120", "rmsnorm_bwd_rms_2048x5120",
      "rmsnorm_bwd_add_2048x5120_w_fp32"]),
    ("fused_mlp", "emu_tpu_torch/csrc/fused_mlp.cu",
     "emu_tpu/ops/fused_mlp.py:357", "B.fused_mlp:gelu",
     ["fused_mlp_2056x1408x6144", "fused_mlp_257x1408x6144",
      "fused_mlp_8224x1408x6144",
      "fused_mlp_post_1025x1792x15360", "fused_mlp_post_2050x1792x15360"]),
    ("add_rmsnorm", "emu_tpu_torch/csrc/rmsnorm.cu",
     "emu_tpu/ops/fused_norm.py:100", "C.rmsnorm_fwd",
     ["rms_norm_640x5120", "add_rmsnorm_640x5120", "add_rmsnorm_8x5120",
      "rms_norm_8x5120", "add_rmsnorm_330x6656", "add_rmsnorm_5x6656",
      "add_rmsnorm_640x5120_w_fp32"]),
    ("decode_attention", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:166", "D.decode_attention:bf16",
     ["decode_attention_b8_40x256x128", "decode_attention_b5_40x256x128",
      "decode_attention_b5_52x384x128"]),
    ("decode_attention_int8", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:166", "D.decode_attention:int8",
     ["decode_int8_b8_52x1024x128_l59",
      "decode_int8_engine_b8_52x1024x128"]),
    ("decode_attention_chunk", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:166", "D.decode_attention:chunk_bf16",
     ["decode_chunk_bf16_b8_q32_52x1024x128",
      "decode_chunk_bf16_b1_q5_52x1024x128"]),
    ("decode_attention_chunk_int8", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:166", "D.decode_attention:chunk_int8",
     ["decode_chunk_int8_b8_q32_52x1024x128"]),
    ("paged_decode_attention", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:313", "D.paged_decode_attention:bf16",
     ["paged_bf16_b8_52x1024x128_p16"]),
    ("paged_decode_attention_int8", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:313", "D.paged_decode_attention:int8",
     ["paged_int8_b8_52x1024x128_p16"]),
    ("paged_decode_attention_chunk", "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:313",
     "D.paged_decode_attention:chunk_bf16",
     ["paged_chunk_bf16_b8_q32_52x1024x128_p16"]),
    ("paged_decode_attention_chunk_int8",
     "emu_tpu_torch/csrc/decode_attention.cu",
     "emu_tpu/ops/decode_attention.py:313",
     "D.paged_decode_attention:chunk_int8",
     ["paged_chunk_int8_b8_q32_52x1024x128_p16"]),
    ("fused_mlp_w8a8", "emu_tpu_torch/csrc/fused_mlp_w8a8.cu",
     "emu_tpu/ops/fused_mlp.py:194", "B.fused_mlp_w8a8",
     [f"fused_mlp_w8a8_{mode}_{m}x1792x15360" for mode in ("post", "pre")
      for m in (2050, 4100, 8200)]),
    ("matmul_q4", "emu_tpu_torch/csrc/q4_matmul.cu",
     "emu_tpu/ops/q4_matmul.py:91", "Q4.matmul_q4",
     ["matmul_q4_qkv_5x6656x19968", "matmul_q4_lm_head_5x6656x32274",
      "matmul_q4_gate_up_330x6656x35840", "matmul_q4_gate_up_17x6656x35840",
      "matmul_q4_gate_up_32x6656x35840",
      "matmul_q4_gate_up_1024x6656x35840"]),
    ("fused_swiglu_q4", "emu_tpu_torch/csrc/q4_matmul.cu",
     "emu_tpu/ops/q4_matmul.py:295", "Q4.fused_swiglu_q4",
     ["fused_swiglu_q4_5x6656x17920", "fused_swiglu_q4_1x6656x17920",
      "fused_swiglu_q4_8x6656x17920"]),
    ("fused_mlp_swiglu", "emu_tpu_torch/csrc/fused_mlp.cu",
     "emu_tpu/ops/fused_mlp.py:357", "B.fused_mlp:swiglu",
     [f"fused_mlp_swiglu_{mode}_{m}x1024x2730" for mode in ("pre", "post")
      for m in SWIGLU_ROWS]),
    ("fused_dense", "emu_tpu_torch/csrc/fused_dense.cu",
     "emu_tpu/ops/fused_mlp.py:296", "B.fused_dense:plain",
     [f"fused_dense_{m}x{k}x{n}" for m, k, n in DENSE_PLAIN]),
    ("fused_dense_pre", "emu_tpu_torch/csrc/fused_dense.cu",
     "emu_tpu/ops/fused_mlp.py:296", "B.fused_dense:pre",
     [f"fused_dense_pre_{m}x{k}x{n}" for m, k, n in DENSE_PRE]),
    ("fused_dense_post", "emu_tpu_torch/csrc/fused_dense.cu",
     "emu_tpu/ops/fused_mlp.py:296", "B.fused_dense:post",
     [f"fused_dense_post_{m}x{k}x{n}" for m, k, n in DENSE_POST]),
    ("fused_dense_mma", "emu_tpu_torch/csrc/fused_dense.cu",
     "emu_tpu/ops/fused_mlp.py:296", "B.fused_dense:plans/mma",
     [f"fused_dense_mma_{m}x{k}x{n}" for m, k, n in DENSE_MMA]),
    ("mha_packed_qkv", "emu_tpu_torch/csrc/batched_mha.cu",
     "emu_tpu/ops/flash_attention.py:362", "A.mha_packed_qkv",
     [f"mha_packed_qkv_{b}x{s}x{h}x{d}" for b, s, h, d in PACKED_SHAPES]),
]


class FormCount:
    """A launch count of one form of a wrapper (kernel D's `forms`; "plans/
    mma" reads kernel H's `plans`), read and reset like a wrapper's own
    `launches`."""

    def __init__(self, fn, form: str):
        table, _, self.form = form.rpartition("/")
        self.table = getattr(fn, table or "forms")

    @property
    def launches(self) -> int:
        return self.table[self.form]

    @launches.setter
    def launches(self, value: int) -> None:
        self.table[self.form] = value


# phase 20: the kernels each part of the parallel drive must launch on
# both ranks (a sharded MLP runs no kernel G; the tower's MLP is whole on
# each rank and runs B, or E on the two images' 2050 rows; the W8A8
# tower's single products run no kernel)
PARALLEL_NEEDED = {
    ("a", "bf16"): ["attention", "add_rmsnorm", "decode_attention",
                    "fused_dense", "fused_mlp"],
    ("a", "int4"): ["attention", "add_rmsnorm", "decode_attention",
                    "matmul_q4", "fused_mlp_w8a8"],
    ("b", "2x1"): ["attention", "attention_lse", "attention_bwd_dq",
                   "attention_bwd_dkv", "add_rmsnorm", "rmsnorm_bwd"],
    ("b", "1x2"): ["attention", "attention_lse", "attention_bwd_dq",
                   "attention_bwd_dkv", "add_rmsnorm", "rmsnorm_bwd"],
    ("c", None): ["attention_lse", "attention_bwd_dq", "attention_bwd_dkv"],
    ("d", None): ["attention_lse", "attention_bwd_dq", "attention_bwd_dkv",
                  "add_rmsnorm", "rmsnorm_bwd"],
}


def run_parallel(card: str) -> dict:
    """Phase 20: two ranks of `emu_tpu_torch.tools.parallel_smoke` on the
    one card (a gloo group through a file under the checkout's build/),
    their JSON read back and held to each part's limit (the tool's
    docstring states them) and to PARALLEL_NEEDED. Returns the launch
    counts summed over both ranks and every part."""
    import os
    import shutil
    out = ROOT / "build" / "chip_smoke_parallel"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    logs = [open(out / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "emu_tpu_torch.tools.parallel_smoke",
         "--rank", str(r), "--init", f"file://{out}/pg",
         "--out", str(out)], cwd=ROOT, env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        # a rank that fails leaves the other waiting in a collective: stop
        # both at the first failure (or after 600 s)
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.perf_counter() - t0 < 600):
            time.sleep(0.5)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            print((out / f"rank{r}.log").read_text()[-6000:])
            raise AssertionError(f"phase 20: rank {r} exited with "
                                 f"{p.returncode}")
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    print(f"  two ranks on one card in {time.perf_counter() - t0:.1f} s "
          f"({card})")
    total = {}
    failures = []
    for (part, sub), needed in PARALLEL_NEEDED.items():
        res = [rk["parts"][part] if sub is None else rk["parts"][part][sub]
               for rk in ranks]
        label = f"({part}{'' if sub is None else ' ' + sub})"
        for r, x in enumerate(res):
            for n, c in x["launches"].items():
                total[n] = total.get(n, 0) + c
            missing = [n for n in needed if x["launches"].get(n, 0) <= 0]
            if missing:
                failures.append(f"{label} rank {r}: no launch of {missing}")
        rest = {k: v for k, v in res[0].items() if k != "launches"}
        print(f"  {label} rank 0: {json.dumps(rest)}")
        print(f"  {label} rank 1: " + json.dumps(
            {k: v for k, v in res[1].items() if k != "launches"}))
        print(f"  {label} launches rank 0 {res[0]['launches']}, rank 1 "
              f"{res[1]['launches']}")
        if not res[0].get("ok"):
            failures.append(f"{label}: above its limit")
        if part == "a" and res[0]["tokens"] != res[1]["tokens"]:
            failures.append(f"{label}: the ranks decoded different tokens")
        if part == "a" and not all(x["load"]["load_equal"] for x in res):
            failures.append(f"{label}: a rank's sharded load differs")
    for r, rk in enumerate(ranks):
        loads = {m: rk["parts"]["a"][m]["load"] for m in ("bf16", "int4")}
        print(f"  (a) rank {r}: sharded load peak int4 "
              f"{loads['int4']['load_peak_gb']:.3f} GB (6.73 GB when each "
              "layer was quantized whole before its cut), bf16 "
              f"{loads['bf16']['load_peak_gb']:.3f} GB; the rank's int4 tree "
              f"{loads['int4']['rank_gb']:.3f} GB  [{card}]")
    for part in "abcd":
        print(f"  part {part}: {ranks[0]['parts'][part]['part_s']:.1f} s")
    if failures:
        raise AssertionError("phase 20: " + "; ".join(failures))
    return total


# --- phase 21: the data pipeline into the encode ---------------------------

DATA_IMAGES, DATA_SHARD, DATA_BATCH, DATA_SIZE = 64, 16, 8, 224
# the phase's time limit, seconds
DATA_LIMIT_S = 30.0


def tower_launches(layers: int, forwards: int) -> dict:
    """The launches `vit.forward_features` of a plain pre-norm bf16 tower
    (ViT-g) makes in `forwards` calls of 8 images: per block kernel A
    (`mha_bhsd`, the q/v biases inside), kernel B's GELU form (LN2, MLP and
    residual) and kernel H's plain form on proj (its TMA plan at 2056
    rows); the patch embedding is one more plain H launch, on its mma.sync
    plan (K = 14 * 14 * 3 = 588). The qkv product and LN1 run no kernel."""
    return {"attention": forwards * layers, "fused_mlp": forwards * layers,
            "fused_dense": forwards * (layers + 1),
            "fused_dense_mma": forwards}


def run_data_pipeline(card: str) -> int:
    """Phase 21: 64 seeded PNGs of 240x320 to 480x640 and one missing file
    as a file:// list through the port's `video2dataset` (center crop to
    224, webdataset shards of 16, two spawned processes), read back by
    `get_video_dataset` at batch 8, each batch moved to the card,
    `device_preprocess`ed and encoded by the full-depth Emu1 ViT-g (bf16,
    random weights from the seed). Checks every image URL read back once
    with status success and the missing one recorded as failed, each batch
    on the card bit for bit the PIL decode of its tar members, the encodes
    finite and one batch the same bits twice. Returns the launches the
    tower's structure gives for the forwards it ran (`tower_launches`)."""
    import tarfile
    import tempfile
    from collections import Counter

    import numpy as np
    import pandas as pd
    import torch
    from PIL import Image
    from emu_tpu_torch.config import Emu1Config
    from emu_tpu_torch.data import video2dataset
    from emu_tpu_torch.data.dataloader import get_video_dataset
    from emu_tpu_torch.models import vit
    from emu_tpu_torch.ops.layers import Init
    from emu_tpu_torch.pipelines.preprocess import device_preprocess

    t_phase = time.perf_counter()
    cfg = Emu1Config().vision
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = vit.init(cfg, Init(device="cuda", dtype=torch.bfloat16,
                                generator=gen))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        rng = np.random.RandomState(SEED)
        urls = []
        for i in range(DATA_IMAGES):
            h, w = rng.randint(240, 481), rng.randint(320, 641)
            # a smooth gradient under noise, so the PNG and WEBP encoders
            # see image-like content
            yy, xx = np.mgrid[0:h, 0:w]
            base = np.stack([xx * 255 // w, yy * 255 // h,
                             (xx + yy) * 127 // (h + w) + 64 * (i % 3)], -1)
            img = np.clip(base + rng.randint(-24, 25, (h, w, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(tmp / f"img_{i}.png")
            urls.append(f"file://{tmp}/img_{i}.png")
        absent = f"file://{tmp}/no_such_image.png"
        url_list = tmp / "urls.txt"
        url_list.write_text("\n".join(urls[:37] + [absent] + urls[37:]))
        shards = tmp / "shards"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = video2dataset(
                str(url_list), output_folder=str(shards),
                output_format="webdataset", resize_mode="center_crop",
                video_size=DATA_SIZE, number_sample_per_shard=DATA_SHARD,
                processes_count=2, tmp_dir=str(tmp / "feather"))
        write_s = time.perf_counter() - t0
        # each shard's samples over its worker's own duration (stats JSON),
        # in shard order
        shard_rates = [st["count"] / st["duration"] for st in (
            json.loads(p.read_text())
            for p in sorted(shards.glob("*_stats.json")))]
        n_urls = DATA_IMAGES + 1
        if (summary["count"], summary["successes"], summary["failed"]) != (
                n_urls, DATA_IMAGES, 1):
            raise AssertionError(f"phase 21: video2dataset summary {summary}")
        meta = pd.concat([pd.read_parquet(p) for p in sorted(
            shards.glob("[0-9]*[0-9].parquet"))])
        bad = meta[meta["status"] != "success"]
        if list(bad["url"]) != [absent] or not bad["error_message"].all():
            raise AssertionError("phase 21: the missing URL is not the one "
                                 f"failed row: {bad.to_dict()}")
        tars = sorted(str(p) for p in shards.glob("*.tar"))
        members = {}
        for t in tars:
            with tarfile.open(t) as tar:
                members.update((m.name, tar.extractfile(m).read())
                               for m in tar.getmembers())

        seen = Counter()
        forwards, first, first_x = 0, None, None
        # the path's time is load_s + card_s: the checks against PIL and the
        # metadata below run off the clock
        load_s = card_s = 0.0
        batches = iter(get_video_dataset(tars, batch_size=DATA_BATCH))
        while True:
            t1 = time.perf_counter()
            batch = next(batches, None)
            t2 = time.perf_counter()
            load_s += t2 - t1
            if batch is None:
                break
            raw = batch["webp"].to("cuda", non_blocking=True)
            with torch.inference_mode():
                emb = vit.forward_features(
                    params, cfg,
                    device_preprocess(raw, DATA_SIZE).to(torch.bfloat16))
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t2
            forwards += 1
            if raw.shape != (DATA_BATCH, DATA_SIZE, DATA_SIZE, 3) or (
                    emb.shape != (DATA_BATCH, cfg.seq_len, cfg.width)):
                raise AssertionError(f"phase 21: batch {tuple(raw.shape)}, "
                                     f"encode {tuple(emb.shape)}")
            if not bool(torch.isfinite(emb).all()):
                raise AssertionError("phase 21: a non-finite encode")
            pil = np.stack([np.asarray(Image.open(io.BytesIO(
                members[f"{k}.webp"])).convert("RGB"))
                for k in batch["__key__"]])
            if not np.array_equal(raw.cpu().numpy(), pil):
                raise AssertionError("phase 21: a batch on the card differs "
                                     "from the PIL decode of its members")
            for m in batch["json"]:
                if m["status"] != "success":
                    raise AssertionError(f"phase 21: sample {m}")
                seen[m["url"]] += 1
            if first is None:
                first, first_x = emb, raw
        path_s = load_s + card_s
        if seen != Counter(urls):
            raise AssertionError("phase 21: the URLs read back are not the "
                                 "images, once each")
        with torch.inference_mode():
            again = vit.forward_features(
                params, cfg,
                device_preprocess(first_x, DATA_SIZE).to(torch.bfloat16))
        forwards += 1
        if not torch.equal(again, first):
            raise AssertionError("phase 21: one batch encoded to two "
                                 "different results")
    n = sum(seen.values())
    E2E["data samples/s written"] = n_urls / write_s
    E2E["data images/s loaded, moved and encoded"] = n / path_s
    print(f"  {n_urls} URLs ({DATA_IMAGES} images of 240x320 to 480x640, one "
          f"missing) into {len(tars)} shards in {write_s:.2f} s: "
          f"{n_urls / write_s:.1f} samples/s written (2 processes, their "
          "start-up included); per shard in its worker "
          f"{', '.join(f'{r:.2f}' for r in shard_rates)} samples/s  [{card}]")
    print(f"  {n} images loaded, moved and encoded by the {cfg.layers}-layer "
          f"ViT-g in {forwards - 1} batches of {DATA_BATCH}: {path_s:.2f} s "
          f"without the checks, {n / path_s:.1f} images/s (host decode + "
          "collation "
          f"{load_s:.2f} s, move + preprocess + encode {card_s:.2f} s); "
          "every URL once, batches equal to PIL, encodes finite, one batch "
          f"the same bits twice  [{card}]")
    del params, first, again
    torch.cuda.empty_cache()
    print(f"  phase 21 took {time.perf_counter() - t_phase:.1f} s (limit "
          f"{DATA_LIMIT_S:.0f} s)")
    return tower_launches(cfg.layers, forwards)


def drive(label: str, wrappers: dict, needed, fn, *args):
    """Run one main path with every launch count set to 0 just before and
    read just after; fail if a kernel of the path was not launched.
    Returns (counts, what fn returned)."""
    for w in wrappers.values():
        w.launches = 0
    out = fn(*args)
    counts = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches in the {label} path: {counts}")
    for n in needed:
        if counts[n] <= 0:
            raise AssertionError(f"kernel {n} was not launched in the {label}"
                                 " path")
    return counts, out


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
        mod, _, attr = ref.partition(".")
        attr, _, form = attr.partition(":")
        fn = getattr(mods[mod], attr)
        wrappers[name] = FormCount(fn, form) if form else fn

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _cuda.build(verbose=True)
    print(log.getvalue(), end="")
    lib = _cuda.library()
    print(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
          f"({_cuda.library_path().relative_to(ROOT)})")
    print_resources(log.getvalue(), lib)

    print("[3] kernels vs plain twins (bf16, the paths' shapes)")
    res = check_kernels(card)

    rng = np.random.RandomState(SEED)
    images = [Image.fromarray(rng.randint(0, 256, (224 + 16 * i, 256, 3),
                                          dtype=np.uint8)) for i in range(8)]
    print("[4] 2-layer full-width Emu1: card bf16 vs CPU fp32")
    check_two_layer(card, images)

    launches = {n: 0 for n in wrappers}

    def count(counts):
        for n, c in counts.items():
            launches[n] += c

    print("[5] full-depth Emu1 through Emu1Runner")
    emu1_path = ["attention", "fused_mlp", "add_rmsnorm", "decode_attention",
                 "fused_dense", "fused_dense_mma"]
    counts, emu1_fingerprint = drive("Emu1 caption", wrappers, emu1_path,
                                     run_full, card, images, wrappers)
    count(counts)
    print("[6] 2-layer full-width Emu2-Chat: card (bf16, int4) vs CPU fp32")
    count(drive("Emu2 2-layer bf16 and int4", wrappers,
                ["attention", "fused_mlp", "add_rmsnorm", "matmul_q4"],
                check_emu2_two_layer, card, images[0])[0])
    print("[7] full-depth Emu2-Chat int4 through EmuChatGeneration")
    counts, emu2_chat = drive(
        "Emu2-Chat int4", wrappers,
        ["attention", "add_rmsnorm", "decode_attention", "fused_mlp_w8a8",
         "matmul_q4", "fused_swiglu_q4"], run_emu2_full, card, images)
    count(counts)
    # phase 19 runs this tree again: it waits on the host (the training
    # phase needs the card's memory)
    park_s = synced(lambda: emu2_chat.model.to("cpu"))[1]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  Emu2-Chat int4 tree moved to the host in {park_s:.1f} s")
    print("[8] 2-layer full-width Emu2-Chat int4, int8 KV: the continuous "
          "engine's decode forms, card vs CPU fp32")
    counts, logit_err = drive(
        "continuous engine 2-layer", wrappers,
        ["attention", "add_rmsnorm", "matmul_q4", "fused_swiglu_q4",
         "decode_attention_int8", "decode_attention_chunk_int8"],
        check_engine_two_layer, card)
    count(counts)
    print("[9] full-depth Emu2-Chat int4 served over HTTP by the continuous "
          "engine")
    counts, chat = drive(
        "continuous serving", wrappers,
        ["attention", "add_rmsnorm", "matmul_q4", "fused_swiglu_q4",
         "decode_attention", "decode_attention_int8",
         "decode_attention_chunk", "decode_attention_chunk_int8"],
        run_serving, card, images, logit_err)
    count(counts)
    print("[10] the paged KV lane at full width")
    count(drive("paged KV lane", wrappers,
                ["decode_attention", "decode_attention_int8",
                 "paged_decode_attention", "paged_decode_attention_int8"],
                check_paged, card, chat)[0])
    del chat
    gc.collect()
    torch.cuda.empty_cache()
    train = ["attention", "attention_lse", "attention_bwd_dq",
             "attention_bwd_dkv", "add_rmsnorm", "rmsnorm_bwd"]
    print("[11] 2-layer full-width Emu1 train step: card bf16 vs CPU fp32")
    count(drive("Emu1 2-layer train step", wrappers, train,
                check_train_two_layer, card)[0])
    print("[12] full-depth Emu1 training through Trainer")
    count(drive("Emu1 training", wrappers, train, run_train_full, card)[0])
    print("[13] full-width SDXL and SD1.5 UNets and both VAEs: card bf16 vs "
          "CPU fp32")
    count(drive("UNet/VAE card vs CPU", wrappers,
                ["batched_mha", "fused_dense", "fused_dense_pre"],
                check_diffusion_card_vs_cpu, card)[0])
    print("[14] full-width Emu2-Gen int4 at 1024² through EmuVisualGeneration"
          " and /v1/mmg")
    count(drive("Emu2-Gen", wrappers,
                ["attention", "batched_mha", "add_rmsnorm", "decode_attention",
                 "matmul_q4", "fused_swiglu_q4", "fused_dense",
                 "fused_dense_pre"], run_emu2_gen, card, images)[0])
    print("[15] full-width Emu1 generation at 512² through "
          "EmuGenerationPipeline")
    emu1_gen_path = ["attention", "batched_mha", "fused_mlp", "add_rmsnorm",
                     "decode_attention", "fused_dense", "fused_dense_pre"]
    counts, emu1_gen = drive("Emu1 generation", wrappers, emu1_gen_path,
                             run_emu1_gen, card, images)
    count(counts)
    print("[16] SwiGLU ViT at EVA02-CLIP-L widths (sub-LN off): 2 layers card "
          "bf16 vs CPU fp32, then 24 layers at batch 32")
    count(drive("SwiGLU ViT", wrappers,
                ["fused_mlp_swiglu", "fused_dense", "batched_mha"],
                run_swiglu_vit, card)[0])
    print("[17] the ViT-parts bench at ViT-g and EVA-4B shapes")
    count(drive("ViT parts", wrappers,
                ["fused_dense_pre", "fused_dense_post", "mha_packed_qkv",
                 "batched_mha", "attention", "fused_mlp", "fused_mlp_w8a8"],
                run_vit_parts, card)[0])
    print("[18] checkpoints at full width: synthesized, written and loaded "
          "onto the card")
    count(drive("checkpoint loading", wrappers,
                ["attention", "add_rmsnorm", "decode_attention"],
                run_checkpoints, card, images)[0])
    print("[19] CLIP, the safety checker, the attentional pooler, the eval "
          "harness and device preprocessing")
    t19 = time.perf_counter()
    print("  (a) CLIP ViT-L/14, 2 layers a tower: card bf16 vs CPU fp32")
    count(drive("CLIP 2-layer", wrappers, ["batched_mha", "attention",
                                           "fused_dense"],
                check_clip_two_layer, card)[0])
    print("  (b) CLIP ViT-L/14 at full depth on the card")
    count(drive("CLIP", wrappers, ["batched_mha", "attention",
                                   "fused_dense"], run_clip_full, card)[0])
    print("  (c) the safety checker at full width, then riding phase 15's "
          "pipeline")
    count(drive("safety checker + Emu1 generation", wrappers, emu1_gen_path,
                run_safety_checker, card, emu1_gen, images)[0])
    print("  (d) the attentional pooler at CoCa ViT-L/14 widths: card bf16 "
          "vs CPU fp32")
    count(drive("attentional pooler", wrappers, ["attention", "fused_dense"],
                check_pooler, card)[0])
    print("  (e) the eval harness on the full-depth Emu1")
    count(drive("eval harness", wrappers, emu1_path, run_eval_harness, card,
                emu1_gen, emu1_fingerprint, images)[0])
    del emu1_gen
    gc.collect()
    torch.cuda.empty_cache()
    print("  (f) device preprocessing and a device-mode Emu2-Chat request")
    unpark_s = synced(lambda: emu2_chat.model.to("cuda"))[1]
    print(f"  Emu2-Chat int4 tree back on the card in {unpark_s:.1f} s")
    count(drive("device preprocessing", wrappers,
                ["attention", "add_rmsnorm", "decode_attention", "matmul_q4",
                 "fused_swiglu_q4"], run_device_preprocess, card, emu2_chat,
                images)[0])
    del emu2_chat
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 19 took {time.perf_counter() - t19:.1f} s")
    print("[20] the parallel paths: two ranks of a gloo group on the card")
    t20 = time.perf_counter()
    count({n: c for n, c in run_parallel(card).items() if n in launches})
    print(f"  phase 20 took {time.perf_counter() - t20:.1f} s")
    print("[21] the data pipeline into the encode: video2dataset shards read "
          "back, moved to the card and encoded by the full-depth ViT-g")
    t21 = time.perf_counter()
    counts, structure = drive("data pipeline and ViT-g", wrappers,
                              ["attention", "fused_mlp", "fused_dense",
                               "fused_dense_mma"], run_data_pipeline, card)
    t21 = time.perf_counter() - t21
    want = {n: 0 for n in wrappers}
    want.update(structure)
    if counts != want:
        raise AssertionError(f"phase 21: launches {counts}, the tower's "
                             f"structure gives {want}")
    if t21 > DATA_LIMIT_S:
        raise AssertionError(f"phase 21 took {t21:.1f} s, over its "
                             f"{DATA_LIMIT_S:.0f} s")
    count(counts)
    print("  end-to-end figures, this run (the previous version's two runs,"
          " PERF.md section 5):")
    for key, value in E2E.items():
        was = EARLIER_E2E.get(key)
        print(f"    {key}: {value:.2f}"
              + (f" ({was[0]}-{was[1]})" if was else ""))
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, source, replaces, _, keys in KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(res[k]["max_abs_err"] for k in keys),
            **{f: res[keys[0]][f] for f in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
            "timed": keys[0]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
