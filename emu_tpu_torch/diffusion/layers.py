"""Conv / norm / attention building blocks of the diffusion models, as
`emu_tpu/diffusion/layers.py`.

Layouts are the JAX package's at every function: activations NHWC
[B, H, W, C], conv kernels HWIO [kh, kw, in, out] in the param tree (nothing
is converted at load). `conv2d` hands cuDNN the NCHW view of the NHWC
tensor, which is its channels_last memory (no copy), and an OIHW view of
the HWIO kernel, so the [B, H·W, C] token view the attention blocks take is
free.

Rounding: the JAX conv adds its bias to the fp32 product and rounds once.
fp32 tensors (the CPU tests) do the same here. bf16 tensors on the card run
cuDNN's bf16 convolution with the bias passed in the call, and PyTorch adds
that bias to the bf16 output: a second rounding, at most one bf16 step away
from the JAX package's result (PERF.md, Queue 3 of ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops.attention import dot_product_attention


def conv_init(init: L.Init, kh: int, kw: int, in_ch: int, out_ch: int
              ) -> dict:
    """A conv's params; the kernel's variance is that of the JAX package's
    uniform(±1/sqrt(fan_in)) draw, the bias zero."""
    std = (3 * kh * kw * in_ch) ** -0.5
    return {"kernel": init.normal(kh, kw, in_ch, out_ch, std=std),
            "bias": init.zeros(out_ch)}


def conv2d(p: dict, x: torch.Tensor, stride: int = 1, padding: int = 1
           ) -> torch.Tensor:
    """NHWC x, HWIO kernel → NHWC y = conv(x) + bias."""
    w = p["kernel"].to(x.dtype).permute(3, 2, 0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"].to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def group_norm(p: dict, x: torch.Tensor, groups: int, eps: float
               ) -> torch.Tensor:
    """GroupNorm over the channels (last axis), computed in fp32."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(b, -1, groups, c // groups)
    mean = xf.mean((1, 3), keepdim=True)
    var = (xf - mean).square().mean((1, 3), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (xf * p["scale"].float() + p["bias"].float()).to(x.dtype)


def group_norm_init(init: L.Init, ch: int) -> dict:
    return {"scale": init.ones(ch), "bias": init.zeros(ch)}


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] fp32, diffusers'
    get_timestep_embedding."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour ×2 (jax.image.resize "nearest" at exactly
    twice the size: output pixel i reads input pixel i // 2)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def attention(p: dict, x: torch.Tensor, ctx: Optional[torch.Tensor],
              n_heads: int) -> torch.Tensor:
    """Diffusers-style attention: to_q/k/v without bias, to_out with one.
    x [B, N, C]; ctx [B, M, C_ctx] (None → self-attention). The heads are
    [B, N, H, C/H] views of the projections, routed by
    `ops.attention.attention_route` (latent self-attention up to 4096
    tokens → batched_mha, the cross-attention → kernel A)."""
    b, n, c = x.shape
    kv = x if ctx is None else ctx
    hd = c // n_heads
    q = L.dense(p["to_q"], x).reshape(b, n, n_heads, hd)
    k = L.dense(p["to_k"], kv).reshape(b, kv.shape[1], n_heads, hd)
    v = L.dense(p["to_v"], kv).reshape(b, kv.shape[1], n_heads, hd)
    o = dot_product_attention(q, k, v, scale=hd ** -0.5)
    return L.dense(p["to_out"], o.reshape(b, n, c))


def attention_init(init: L.Init, ch: int, ctx_dim: Optional[int]) -> dict:
    kv_dim = ctx_dim if ctx_dim is not None else ch
    return {
        "to_q": init.dense(in_dim=ch, out_dim=ch, bias=False),
        "to_k": init.dense(in_dim=kv_dim, out_dim=ch, bias=False),
        "to_v": init.dense(in_dim=kv_dim, out_dim=ch, bias=False),
        "to_out": init.dense(in_dim=ch, out_dim=ch),
    }


def resnet_block_init(init: L.Init, in_ch: int, out_ch: int,
                      temb_dim: Optional[int]) -> dict:
    p = {
        "norm1": group_norm_init(init, in_ch),
        "conv1": conv_init(init, 3, 3, in_ch, out_ch),
        "norm2": group_norm_init(init, out_ch),
        "conv2": conv_init(init, 3, 3, out_ch, out_ch),
    }
    if temb_dim is not None:
        p["time_emb_proj"] = init.dense(in_dim=temb_dim, out_dim=out_ch)
    if in_ch != out_ch:
        p["conv_shortcut"] = conv_init(init, 1, 1, in_ch, out_ch)
    return p


def resnet_block(p: dict, x: torch.Tensor, temb: Optional[torch.Tensor],
                 groups: int, eps: float) -> torch.Tensor:
    """Diffusers ResnetBlock2D (time_scale_shift="default")."""
    h = F.silu(group_norm(p["norm1"], x, groups, eps))
    h = conv2d(p["conv1"], h)
    if temb is not None and "time_emb_proj" in p:
        t = L.dense(p["time_emb_proj"], F.silu(temb))
        h = h + t[:, None, None, :]
    h = F.silu(group_norm(p["norm2"], h, groups, eps))
    h = conv2d(p["conv2"], h)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, padding=0)
    return x + h
