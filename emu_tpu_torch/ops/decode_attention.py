"""Kernel D: single-query attention over the head-major KV cache
(`csrc/decode_attention.cu`).

Replaces `emu_tpu/ops/decode_attention.py:decode_attention` in the form
the decode step uses: bf16, one query per row, the FULL stacked cache
[L, B, Hkv, S, D] plus a layer index (a pointer offset in the kernel, no
per-layer copy), a [B, S] validity mask, GQA (query head h reads kv head
h // (H/Hkv)), and the current token's k/v [B, Hkv, 1, D] as one extra
always-valid column, so the cache write can be deferred past the layer
loop. int8 K/V and multi-query verify chunks are still to port.

`decode_attention` is the wrapper: on a CPU tensor it runs
`decode_attention_reference`, on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops.attention_reference import grouped_attention


def decode_attention_reference(q, k, v, kv_valid, *, scale: float,
                               layer: Optional[int] = None, k_new=None,
                               v_new=None):
    """Plain twin of `decode_attention`: the port's one plain attention
    (`attention_reference.grouped_attention`) at Sq == 1 on cache planes."""
    if layer is not None:
        k, v = k[layer], v[layer]
    return grouped_attention(q, k, v, scale=scale, kv_valid=kv_valid,
                             kv_layout="bgkd", k_new=k_new, v_new=v_new)


def decode_attention(q, k, v, kv_valid, *, scale: float,
                     layer: Optional[int] = None, k_new=None,
                     v_new=None) -> torch.Tensor:
    """q [B, 1, H, D] (roped); k/v the cache, [L, B, Hkv, S, D] with
    `layer`, or [B, Hkv, S, D] without; kv_valid [B, S] (nonzero =
    attend; must exclude the current slot when k_new is given); k_new/v_new
    [B, Hkv, 1, D] or None. → [B, 1, H, D]."""
    if _cuda.on_cpu(q, "decode_attention"):
        return decode_attention_reference(q, k, v, kv_valid, scale=scale,
                                          layer=layer, k_new=k_new,
                                          v_new=v_new)
    if layer is None:
        k, v, layer = k[None], v[None], 0
    n_layers, b, hkv, s, d = k.shape
    h = q.shape[2]
    bf = torch.bfloat16
    _cuda.require(q.shape == (b, 1, h, d) and v.shape == k.shape
                  and h % hkv == 0 and h // hkv <= 8,
                  f"decode_attention: bad shapes q{tuple(q.shape)} "
                  f"k{tuple(k.shape)} (Sq must be 1, H/Hkv <= 8)")
    _cuda.require(d <= 128 and s >= 1 and 0 <= int(layer) < n_layers,
                  "decode_attention: head dim must be <= 128")
    _cuda.require(q.dtype == k.dtype == v.dtype == bf,
                  "decode_attention: q and the cache must be bfloat16")
    _cuda.require(k.is_contiguous() and v.is_contiguous(),
                  "decode_attention: the cache must be contiguous")
    _cuda.require(kv_valid.shape == (b, s),
                  f"decode_attention: kv_valid must be [{b}, {s}]")
    _cuda.require((k_new is None) == (v_new is None),
                  "decode_attention: k_new and v_new come together")

    def rows(t, heads):  # [B, ..., heads, D] with per-row stride only
        _cuda.require(t.dtype == bf and t.shape[0] == b
                      and t.numel() == b * heads * d and t.stride(-1) == 1
                      and (heads == 1 or t.reshape(b, heads, d).stride(1) == d),
                      "decode_attention: q/k_new/v_new need contiguous heads")
        return t.reshape(b, heads, d)

    qr = rows(q, h)
    kn = None if k_new is None else rows(k_new, hkv)
    vn = None if v_new is None else rows(v_new, hkv)
    valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    out = torch.empty(b, 1, h, d, device=q.device, dtype=bf)
    with torch.cuda.device(q.device):
        status = _cuda.library().emu_decode_attention_fwd(
            qr.data_ptr(), qr.stride(0), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), _cuda.ptr(kn), 0 if kn is None else kn.stride(0),
            _cuda.ptr(vn), 0 if vn is None else vn.stride(0), out.data_ptr(),
            b, h, hkv, s, d, int(layer), float(scale), _cuda.stream(q))
    _cuda.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
