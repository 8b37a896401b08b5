"""Rotary position embeddings: 1-D LLaMA (half-split) and 2-D EVA vision
(interleaved pairs), as `emu_tpu/ops/rope.py`. Tables are float64 numpy,
stored as fp32; the rotation runs in fp32 and casts back."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def llama_rope_tables(head_dim: int, max_len: int, theta: float = 10000.0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape [max_len, head_dim]."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    freqs = np.outer(np.arange(max_len, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _rotate_half(x):
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def gather_rope_rows(cos, sin, positions):
    """Per-position rows → ([B, S, 1, D], [B, S, 1, D]) fp32, gathered once
    and shared by every layer."""
    return (cos[positions][:, :, None, :].float(),
            sin[positions][:, :, None, :].float())


def apply_rope_rows(q, k, c, s):
    """Rotate q/k [B, S, H, D] by pre-gathered rows, in fp32."""
    qf, kf = q.float(), k.float()
    return ((qf * c + _rotate_half(qf) * s).to(q.dtype),
            (kf * c + _rotate_half(kf) * s).to(k.dtype))


def apply_llama_rope(q, k, cos, sin, positions):
    """RoPE on q/k [B, S, H, D] at absolute positions [B, S]: the rows
    gathered, then applied."""
    return apply_rope_rows(q, k, *gather_rope_rows(cos, sin, positions))


def vision_rope_tables(half_head_dim: int, pt_seq_len: int,
                       ft_seq_len: int | None = None, theta: float = 10000.0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of shape [ft*ft, 2*half_head_dim] over the patch grid."""
    if ft_seq_len is None:
        ft_seq_len = pt_seq_len
    dim = half_head_dim
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2]
                             / dim))
    t = np.arange(ft_seq_len, dtype=np.float64) / ft_seq_len * pt_seq_len
    ang = np.repeat(np.outer(t, freqs), 2, axis=-1)
    h = np.broadcast_to(ang[:, None, :], (ft_seq_len, ft_seq_len, dim))
    w = np.broadcast_to(ang[None, :, :], (ft_seq_len, ft_seq_len, dim))
    full = np.concatenate([h, w], axis=-1).reshape(ft_seq_len * ft_seq_len,
                                                   2 * dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def _rotate_pairs(x):
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_vision_rope(x, cos, sin):
    """x [B, S, H, D] patch tokens (no cls); cos/sin [S, D]."""
    c = cos[None, :, None, :].float()
    s = sin[None, :, None, :].float()
    xf = x.float()
    return (xf * c + _rotate_pairs(xf) * s).to(x.dtype)
