"""Attention dispatch over the JAX package's layouts.

q [B, Sq, H, D], k/v [B, Skv, Hkv, D] (token-major), or head-major cache
planes [B, Hkv, S, D]. Masking vocabulary as in `emu_tpu/ops/attention.py`:
`causal` is aligned to the END of the keys, `kv_valid` [B, Skv] is a
padding mask (nonzero = attend), `mask`/`bias` are dense forms. Masked
logits are -1e30, not -inf, so fully-masked rows stay finite.

Routing (`attention_route`, the JAX package's `_auto_backend` contract,
`emu_tpu/ops/attention.py:277-311`, re-decided for the card): fp32
activations, dense bias/mask forms and head widths above 256 (the VAE's
one 512-wide head) take the plain chain, as they take XLA in the JAX
package; unmasked, non-causal self-attention of 64 to MHA_MAX_S tokens with
D <= 256 goes to `flash_attention.batched_mha` (the diffusion UNets'
latent self-attention at every level, the SwiGLU ViT's); the rest (causal,
`kv_valid`, longer non-causal self-attention, and the UNets' short-KV
cross-attention, where the JAX package takes XLA but kernel A beats the
plain chain on the H100: PERF.md) goes to kernel A
(`flash_attention.attention`, differentiable, D <= 128), and what kernel A
cannot take to the plain chain. Cache
attention follows the JAX package's rule (`emu_tpu/ops/attention.py:218-260`): Sq == 1, or k_new/v_new with
Sq <= 32, with a kv_valid mask and no dense mask or causal flag, goes to
kernel D (`decode_attention`, or `paged_decode_attention` for a page pool)
where its envelope admits the dtypes and widths (`decode_attention.
kernel_fits`: fp32 activations decline, as they decline kernels A-C);
each runs its plain twin on CPU tensors. Every other shape, and the dense
bias/mask forms, take the plain torch chain
(`attention_reference.grouped_attention`, int8 caches dequantized first), as
they take XLA in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops.attention_reference import grouped_attention
from emu_tpu_torch.ops.decode_attention import (MAX_CHUNK, decode_attention,
                                                kernel_fits,
                                                paged_decode_attention)


# batched_mha's sequence range, measured on the H100 (chip_smoke.py phase
# 3, ROUTE_SHAPES: both kernels at every self-attention shape they share):
# batched_mha beats kernel A at 257, 1024 and 4096 tokens (PERF.md), so it
# takes the UNets' 4096-token level too; from the JAX package's 64-token
# floor up to 4096, the longest self-attention on a path. Longer ones go to
# kernel A, which has the streaming form the JAX package keeps for them.
MHA_MIN_S, MHA_MAX_S = 64, 4096


def attention_route(q, k, v=None, *, bias=None, mask=None, kv_valid=None,
                    causal: bool = False) -> str:
    """"batched_mha", "flash" (kernel A) or "plain" for q [B, Sq, H, D],
    k [B, Skv, Hkv, D] (v, when given, is checked for autograd)."""
    sq, h, d = q.shape[1:]
    skv, hkv = k.shape[1:3]
    if bias is not None or mask is not None or not _cuda.kernel_dtype(q):
        return "plain"
    if d > fa.MHA_MAX_D or d % 8:
        return "plain"
    grad = _cuda.records(q, k, v)
    if (not causal and kv_valid is None and sq == skv and h == hkv
            and MHA_MIN_S <= sq <= MHA_MAX_S and not grad):
        return "batched_mha"        # inference only, as the TPU kernel
    return "flash" if d <= fa.A_MAX_D else "plain"


def dot_product_attention(q, k, v, *, bias=None, mask=None, kv_valid=None,
                          scale: Optional[float] = None,
                          causal: bool = False):
    """Scaled dot-product attention with fp32 softmax; k/v may carry fewer
    heads than q (GQA). Routed by `attention_route`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    route = attention_route(q, k, v, bias=bias, mask=mask, kv_valid=kv_valid,
                            causal=causal)
    if route == "batched_mha":
        return fa.batched_mha(q, k, v, scale=float(scale))
    if route == "flash":
        return fa.flash_attention(q, k, v, kv_valid=kv_valid,
                                  scale=float(scale), causal=causal)
    return grouped_attention(q, k, v, scale=scale, bias=bias, mask=mask,
                             kv_valid=kv_valid, causal=causal)


def cache_attention(q, kv: dict, *, kv_valid=None, mask=None,
                    scale: Optional[float] = None, causal: bool = False):
    """Attention against a cache-resident KV (`llama._cache_kv`): head-major
    planes, the full stacked [L, B, Hkv, S, D] cache when kv carries a
    "layer" index, int8 values with "k_scale"/"v_scale" [L, B, Hkv, S], a
    page pool [L, n_pages, Hkv, page, D] with a "page_table" [B, P], and
    optional "k_new"/"v_new" [B, Hkv, Sq, D] extra columns (deferred
    writes; kv_valid must exclude the in-flight slots)."""
    k, v = kv["k"], kv["v"]
    dt = kv.get("dtype", q.dtype)
    ks, vs = kv.get("k_scale"), kv.get("v_scale")
    layer = kv.get("layer")
    kn, vn = kv.get("k_new"), kv.get("v_new")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sq = q.shape[1]
    kernel = ((sq == 1 or (kn is not None and sq <= MAX_CHUNK))
              and mask is None and not causal and kv_valid is not None
              and kernel_fits(q, k, kn, quant=ks is not None))
    pt = kv.get("page_table")
    if pt is not None:
        # the pool's page axis, with or without its layer dim (the JAX
        # package reads k.shape[3], which is D for a 4-D pool)
        page = k.shape[-2]
        s_total = pt.shape[1] * page
        if kernel:
            return paged_decode_attention(q, k, v, pt, kv_valid,
                                          scale=float(scale), k_scale=ks,
                                          v_scale=vs, layer=layer, k_new=kn,
                                          v_new=vn)
        if layer is not None:
            k, v = k[layer], v[layer]
            if ks is not None:  # pre-gathered logical views [L, B, Hkv, S]
                ks, vs = ks[layer], vs[layer]
            layer = None
        idx = pt.long()
        k = k[idx].transpose(1, 2).reshape(pt.shape[0], k.shape[1], s_total,
                                           k.shape[3])
        v = v[idx].transpose(1, 2).reshape(pt.shape[0], v.shape[1], s_total,
                                           v.shape[3])
    if kernel:
        return decode_attention(q, k, v, kv_valid, ks, vs, scale=float(scale),
                                layer=layer, k_new=kn, v_new=vn)
    if layer is not None:
        k, v = k[layer], v[layer]
        if ks is not None:
            ks, vs = ks[layer], vs[layer]
    if ks is not None:
        k = k.to(dt) * ks.to(dt)[..., None]
        v = v.to(dt) * vs.to(dt)[..., None]
    return grouped_attention(q, k.to(dt), v.to(dt), scale=scale, mask=mask,
                             kv_valid=kv_valid, causal=causal,
                             kv_layout="bgkd", k_new=kn, v_new=vn)
