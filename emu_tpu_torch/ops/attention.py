"""Attention dispatch over the JAX package's layouts.

q [B, Sq, H, D], k/v [B, Skv, Hkv, D] (token-major), or head-major cache
planes [B, Hkv, S, D]. Masking vocabulary as in `emu_tpu/ops/attention.py`:
`causal` is aligned to the END of the keys, `kv_valid` [B, Skv] is a
padding mask (nonzero = attend), `mask`/`bias` are dense forms. Masked
logits are -1e30, not -inf, so fully-masked rows stay finite.

Routing: bf16 attention with no dense bias or mask goes to kernel A
(`flash_attention.attention`, differentiable); fp32 activations take the
plain chain, as the JAX package's fused kernels leave them to XLA. Cache
attention follows the JAX package's rule (`emu_tpu/ops/attention.py:218-260`): Sq == 1, or k_new/v_new with
Sq <= 32, with a kv_valid mask and no dense mask or causal flag, goes to
kernel D (`decode_attention`, or `paged_decode_attention` for a page pool);
each runs its plain twin on CPU tensors. Every other shape, and the dense
bias/mask forms, take the plain torch chain
(`attention_reference.grouped_attention`, int8 caches dequantized first), as
they take XLA in the JAX package.
"""

from __future__ import annotations

from typing import Optional

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops import flash_attention as fa
from emu_tpu_torch.ops.attention_reference import grouped_attention
from emu_tpu_torch.ops.decode_attention import (MAX_CHUNK, decode_attention,
                                                paged_decode_attention)


def dot_product_attention(q, k, v, *, bias=None, mask=None, kv_valid=None,
                          scale: Optional[float] = None,
                          causal: bool = False):
    """Scaled dot-product attention with fp32 softmax; k/v may carry fewer
    heads than q (GQA)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is None and mask is None and _cuda.kernel_dtype(q):
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
              and mask is None and not causal and kv_valid is not None)
    pt = kv.get("page_table")
    if pt is not None:
        # read before the layer strip, as the JAX package does
        # (emu_tpu/ops/attention.py:216)
        page = k.shape[3]
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
