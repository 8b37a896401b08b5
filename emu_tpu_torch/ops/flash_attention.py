"""Kernel A: tiled attention over head-major [B, H, S, D] tensors.

One CUDA kernel (`csrc/attention.cu`) takes the place of two TPU kernels of
`emu_tpu/ops/flash_attention.py`:

- `mha_bhsd`: the ViT's unmasked self-attention with per-head q/v
  projection biases folded in; here the ragged sequence edge (ViT-g's 257
  tokens) is masked inside the kernel instead of being padded by the
  caller;
- `flash_attention` (its `_flash_short` tier): end-aligned causal mask plus
  a [B, Skv] `kv_valid` padding mask, the LLaMA prefill contract.

`attention` is the wrapper. On a CPU tensor it runs `attention_reference`,
its plain PyTorch twin (the port's one plain attention,
`attention_reference.grouped_attention`, on head-major K/V). On a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops.attention_reference import grouped_attention


def attention_reference(q, k, v, q_bias=None, v_bias=None, *, kv_valid=None,
                        scale: float, causal: bool = False):
    """Plain twin of `attention`. q [B, H, Sq, D]; k/v [B, Hkv, Skv, D]
    (H a multiple of Hkv: query head h reads kv head h // (H/Hkv));
    q_bias [H, D], v_bias [Hkv, D]; kv_valid [B, Skv] (nonzero = attend)."""
    if q_bias is not None:
        q = q + q_bias.to(q.dtype)[None, :, None, :]
    if v_bias is not None:
        v = v + v_bias.to(v.dtype)[None, :, None, :]
    out = grouped_attention(q.transpose(1, 2), k, v, scale=scale,
                            kv_valid=kv_valid, causal=causal,
                            kv_layout="bgkd")
    return out.transpose(1, 2)


def attention(q, k, v, q_bias=None, v_bias=None, *,
              kv_valid: Optional[torch.Tensor] = None, scale: float,
              causal: bool = False) -> torch.Tensor:
    """softmax(scale * (q + q_bias) kᵀ, masked) (v + v_bias) → [B, H, Sq, D].

    q [B, H, Sq, D], k/v [B, Hkv, Skv, D]: any strides with a contiguous
    last dim (views of a [B, S, 3, H, D] projection are read in place).
    The causal mask is aligned to the end of the keys (query i sees key j
    iff j <= i + Skv - Sq). On CUDA the output's memory is [B, Sq, H, D],
    returned as its [B, H, Sq, D] view."""
    if _cuda.on_cpu(q, "attention"):
        return attention_reference(q, k, v, q_bias, v_bias, kv_valid=kv_valid,
                                   scale=scale, causal=causal)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _cuda.require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
                  "attention: q/k/v must be bfloat16")
    _cuda.require(k.shape == v.shape == (b, hkv, skv, d) and h % hkv == 0,
                  f"attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)}"
                  f" v{tuple(v.shape)}")
    _cuda.require(d % 8 == 0 and d <= 128 and sq >= 1 and skv >= 1,
                  f"attention: head dim {d} must be a multiple of 8, <= 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _cuda.require(t.device == q.device and t.stride(-1) == 1
                      and all(s % 8 == 0 for s in t.stride()[:3])
                      and t.data_ptr() % 16 == 0,
                      f"attention: {name} needs a contiguous, 16-byte aligned"
                      " last dim")
    if q_bias is not None:
        q_bias = q_bias.to(torch.bfloat16).reshape(h, d).contiguous()
    if v_bias is not None:
        v_bias = v_bias.to(torch.bfloat16).reshape(hkv, d).contiguous()
    if kv_valid is not None:
        _cuda.require(kv_valid.shape == (b, skv),
                      f"attention: kv_valid must be [{b}, {skv}]")
        kv_valid = kv_valid.to(device=q.device, dtype=torch.bool).contiguous()
    out = torch.empty(b, sq, h, d, device=q.device, dtype=q.dtype
                      ).transpose(1, 2)
    with torch.cuda.device(q.device):
        status = _cuda.library().emu_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _cuda.ptr(q_bias),
            _cuda.ptr(v_bias), _cuda.ptr(kv_valid), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, hkv, sq, skv, d, float(scale),
            int(causal), _cuda.stream(q))
    _cuda.check(status, "attention")
    attention.launches += 1
    return out


attention.launches = 0


def mha_bhsd(q, k, v, q_bias=None, v_bias=None, *, scale: float = 1.0):
    """Unmasked self-attention on head-major [B, H, S, D] inputs with
    per-head [H, D] q/v biases (the ViT-g form). Unlike the TPU kernel, S
    is the real length: no padding, no `s_real`."""
    return attention(q, k, v, q_bias, v_bias, scale=scale)


def flash_attention(q, k, v, *, kv_valid=None, scale: float = 1.0,
                    causal: bool = False):
    """q [B, Sq, H, D], k/v [B, Skv, Hkv, D] (token-major, as
    `emu_tpu.ops.flash_attention.flash_attention`) → [B, Sq, H, D]."""
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    kv_valid=kv_valid, scale=scale, causal=causal)
    return out.transpose(1, 2)
