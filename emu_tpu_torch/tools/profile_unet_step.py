"""Host and device time of one UNet denoise step on the card: whether a step
is held back by the host's launches or by its kernels.

Usage:
  python -m emu_tpu_torch.tools.profile_unet_step

For the full-width SD1.5-class UNet of Emu1 generation
(`UNetConfig.emu1_sd15()`, 64² latent, context [2, 32, 5120]) and the SDXL
UNet of Emu2-Gen (`UNetConfig.emu2_sdxl()`, 128² latent, context [2, 64,
1792], SDXL time ids), random bf16 weights drawn on the card from a seed,
one CFG batch of 2, it prints:

- `dense` at the UNet's most frequent biased shape (the attention output
  of its first level with attention, [2·4096, C] → C): host µs a call (no
  synchronisation between calls) and device ms, for `ops.layers.dense`
  (whatever route the tree takes) and for the fp32 composition
  `x.float() @ w.float() + b`; `ops.layers.dense` also at the innermost
  level's shortest grids, its to_out and GEGLU proj_out ([2·side², C] →
  C and [2·side², 4C] → C, C the widest channel count); the same for
  kernel A
  (`ops.flash_attention.attention`) on that level's self-attention and
  for `batched_mha` on the next level's (token-major views of one
  projection, as the UNet passes them), each kernel also with its card
  time alone from torch.profiler ("card ms"), since the events of a call
  that waits on the host time the host;
- the step: ms/step from CUDA events around back-to-back forwards; host
  ms/step, the time `unet.forward` takes to return on an idle card (all
  its launches queued); then one step under torch.profiler: kernel time
  and count, busy share, and the host's top operators by self time.

A step whose host ms/step is close to its ms/step waits on the host. The
script imports only entry points that every version of the port has, so
running it from two checkouts compares them on one card.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

SEED, STEPS, DENSE_CALLS = 1234, 10, 200
MODELS = {  # name: (config, latent side, context tokens)
    "sd15": ("emu1_sd15", 64, 32),    # Emu1's n_causal image embeddings
    "sdxl": ("emu2_sdxl", 128, 64),   # Emu2-Gen's n_query embeddings
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def host_and_device(fn, calls: int):
    """(host µs a call with no synchronisation between calls, device ms a
    call from CUDA events), after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / calls


def card_ms(fn, calls: int = 10, tries: int = 3):
    """The card's kernel time of one call of fn (torch.profiler), without
    the host's share; None when no try recorded a kernel (a lost trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / calls
    return None


def profile_model(name: str, out=print) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from emu_tpu_torch.config import UNetConfig
    from emu_tpu_torch.diffusion import unet
    from emu_tpu_torch.ops import flash_attention as A
    from emu_tpu_torch.ops import layers as L

    make, lat, ctx_len = MODELS[name]
    cfg = getattr(UNetConfig, make)()
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = unet.init(cfg, L.Init(device=dev, dtype=bf, generator=gen))
    x = torch.randn(2, lat, lat, cfg.in_channels, device=dev, generator=gen
                    ).to(bf)
    ctx = torch.randn(2, ctx_len, cfg.cross_attention_dim, device=dev,
                      generator=gen).to(bf)
    ts = torch.full((2,), 500.0, device=dev)
    kw = {}
    if cfg.addition_embed_type == "text_time":
        kw = {"added_text_embeds": ctx.mean(1), "added_time_ids":
              torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2,
                           device=dev)}
    # the first level with attention: its to_out runs most often
    i = list(cfg.down_block_types).index("CrossAttnDownBlock2D")
    c = cfg.block_out_channels[i]
    dx = torch.randn(2 * (lat >> i) ** 2, c, device=dev, generator=gen).to(bf)
    dp = {"kernel": (torch.randn(c, c, device=dev, generator=gen) * c ** -0.5
                     ).to(bf),
          "bias": torch.randn(c, device=dev, generator=gen).to(bf)}
    heads = cfg.attention_head_dim[i]
    qkv = torch.randn(3, 2, heads, (lat >> i) ** 2, c // heads, device=dev,
                      generator=gen).to(bf)
    # the next level's self-attention, [B, S, H, D] views of [B, S, 3, H, D]
    c2, h2 = cfg.block_out_channels[i + 1], cfg.attention_head_dim[i + 1]
    mqkv = torch.randn(2, (lat >> (i + 1)) ** 2, 3, h2, c2 // h2, device=dev,
                       generator=gen).to(bf).unbind(2)
    # the innermost level (the mid block): the shortest grids
    cm, rows = cfg.block_out_channels[-1], 2 * (lat >> (
        len(cfg.block_out_channels) - 1)) ** 2
    mid = {}
    for key, kin in (("mid_dense", cm), ("mid_geglu_out", 4 * cm)):
        mid[key] = (torch.randn(rows, kin, device=dev, generator=gen).to(bf),
                    {"kernel": (torch.randn(kin, cm, device=dev, generator=gen)
                                * kin ** -0.5).to(bf),
                     "bias": torch.randn(cm, device=dev, generator=gen
                                         ).to(bf)})
    res = {"model": name, "latent": lat, "context": [2, ctx_len,
                                                     cfg.cross_attention_dim],
           "dense_shape": [dx.shape[0], c, c],
           "mid_dense_shape": [rows, cm, cm],
           "mid_geglu_out_shape": [rows, 4 * cm, cm],
           "attention_shape": list(qkv.shape[1:]),
           "batched_mha_shape": list(mqkv[0].shape)}

    def fwd():
        return unet.forward(params, cfg, x, ts, ctx, **kw)

    with torch.inference_mode():
        shape = f"[{dx.shape[0]}, {c}] -> {c}"
        for key, label, fn in (
                ("dense", shape, lambda: L.dense(dp, dx)),
                ("fp32_composition", shape, lambda: (L._matmul_f32(
                    dx, dp["kernel"]) + dp["bias"].float()).to(bf)),
                *((key, f"[{rows}, {xm.shape[1]}] -> {cm}",
                   lambda xm=xm, pm=pm: L.dense(pm, xm))
                  for key, (xm, pm) in mid.items()),
                ("attention", "x".join(map(str, qkv.shape[1:])),
                 lambda: A.attention(*qkv, scale=(c // heads) ** -0.5)),
                ("batched_mha", "x".join(map(str, mqkv[0].shape)),
                 lambda: A.batched_mha(*mqkv, scale=(c2 // h2) ** -0.5))):
            host, ms = host_and_device(fn, DENSE_CALLS)
            res[f"{key}_host_us"], res[f"{key}_device_ms"] = host, ms
            card = ""
            if key in ("attention", "batched_mha"):
                cms = res[f"{key}_card_ms"] = card_ms(fn)
                card = (", card not measured" if cms is None
                        else f", card {cms:.4f} ms")
            out(f"  {key} {label}: host {host:.1f} us a call, device "
                f"{ms:.4f} ms a call{card}")
        _, ms = host_and_device(fwd, STEPS)
        issue = []
        for _ in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd()
            issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    res.update(ms_per_step=ms, host_ms_per_step=sum(issue) / STEPS,
               host_ms_min=min(issue), kernel_ms=busy, kernels=len(kernels),
               busy=busy / ms)
    out(f"  {name} UNet, {lat}² latent: {ms:.2f} ms/step (CUDA events, "
        f"{STEPS} steps back to back); host {res['host_ms_per_step']:.2f} "
        f"ms/step to queue a step (min {min(issue):.2f}); profiled step: "
        f"device time {busy:.2f} ms in {len(kernels)} operations, busy "
        f"{busy / ms:.2f}")
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:8]
    res["host_top"] = [[e.key, e.count, e.self_cpu_time_total / 1e3]
                       for e in top]
    for e in top:
        out(f"    host {e.self_cpu_time_total / 1e3:8.2f} ms self in "
            f"{e.count:5d} calls  {e.key[:70]}")
    del params
    torch.cuda.empty_cache()
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_unet_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}; {torch.cuda.get_device_name(0)}")
    results = [profile_model(name) for name in MODELS]
    print(json.dumps({"profile_unet_step": results}))


if __name__ == "__main__":
    main()
