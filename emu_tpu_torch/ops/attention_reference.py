"""The one plain attention of the port: the math of
`emu_tpu.ops.attention._grouped_attention` in PyTorch, with no kernel.

It is the plain twin behind kernel A (`flash_attention.attention_reference`)
and kernel D (`decode_attention.decode_attention_reference`), and the path
of the dense bias/mask forms in `attention.dot_product_attention`, so every
plain route masks and normalises by the same rules: fp32 logits, -1e30 for
masked columns (fully-masked rows stay finite), fp32 softmax, probabilities
cast to the query dtype before P·V.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def grouped_attention(q, k, v, *, scale: float, bias=None, mask=None,
                      kv_valid=None, causal: bool = False,
                      kv_layout: str = "bkgd", k_new=None, v_new=None,
                      return_lse: bool = False):
    """q [B, Sq, H, D]; k/v [B, Skv, Hkv, D] (kv_layout "bkgd", token-major)
    or [B, Hkv, Skv, D] ("bgkd", head-major cache planes); H a multiple of
    Hkv, query head h reading kv head h // (H/Hkv), with no repeated K/V.

    bias/mask: [B or 1, H or 1, Sq, Skv] dense forms; kv_valid [B, Skv]
    (nonzero = attend); causal aligned to the end of the keys (query i sees
    key j iff j <= i + Skv - Sq). k_new/v_new [B, Hkv, Sq_new, D]: the
    current chunk's k/v as extra always-valid columns (deferred cache
    writes); query i sees extra column j iff j <= i. → [B, Sq, H, D], and
    with return_lse also the rows' log-sum-exp of the masked logits (fp32,
    [B, H, Sq]), the residual of the attention backward."""
    b, sq, h, d = q.shape
    hkv, skv = (k.shape[2], k.shape[1]) if kv_layout == "bkgd" else k.shape[1:3]
    rep = h // hkv
    q5 = q.reshape(b, sq, hkv, rep, d).float()

    def per_head(t):  # [B', H or 1, Sq, Skv] → onto the [B, Hkv, rep, ..] grid
        return (t[:, :, None] if t.shape[1] == 1
                else t.reshape(t.shape[0], hkv, rep, *t.shape[2:]))

    logits = torch.einsum(f"bqgrd,{kv_layout}->bgrqk", q5, k.float()) * scale
    if bias is not None:
        logits = logits + per_head(bias).float()
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi + (skv - sq)), _NEG_INF)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid.bool()[:, None, None, None, :],
                                    _NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~per_head(mask).bool(), _NEG_INF)
    if k_new is not None:
        ln = torch.einsum("bqgrd,bgkd->bgrqk", q5, k_new.float()) * scale
        qn = k_new.shape[2]
        if qn > 1:
            qi = torch.arange(sq, device=q.device)[:, None]
            cj = torch.arange(qn, device=q.device)[None, :]
            ln = ln.masked_fill(~(cj <= qi), _NEG_INF)
        logits = torch.cat([logits, ln], dim=-1)
    probs = torch.softmax(logits, dim=-1).to(q.dtype).float()
    lse = (torch.logsumexp(logits, dim=-1).reshape(b, h, sq) if return_lse
           else None)
    out = torch.einsum(f"bgrqk,{kv_layout}->bqgrd", probs[..., :skv],
                       v.float())
    if k_new is not None:
        out = out + torch.einsum("bgrqk,bgkd->bqgrd", probs[..., skv:],
                                 v_new.float())
    out = out.reshape(b, sq, h, d).to(q.dtype)
    return (out, lse) if return_lse else out
