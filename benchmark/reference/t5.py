"""Plain PyTorch reference of Emu1's Causal Former: learned causal tokens
through a T5 decoder stack (HF T5Stack, is_decoder, eval) that
cross-attends the tower's features, then a linear projection to the
decoder's width. T5's conventions: RMS layer norm without bias or mean,
attention logits not scaled, a relative-position bias from the first
self-attention layer's bucket table shared by every self-attention layer
(causal buckets), ReLU feed-forward, bias-free linears. fp32, TF32 off;
`bits` rounds every product's weights per output channel and its inputs
per token (the control)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from benchmark.reference.llama import quant_rows


def buckets(q_len: int, k_len: int, n_buckets: int, max_distance: int,
            device) -> torch.Tensor:
    """HF T5's `_relative_position_bucket`, bidirectional=False."""
    rel = (torch.arange(k_len, device=device)[None, :]
           - torch.arange(q_len, device=device)[:, None])
    rel = -torch.clamp(rel, max=0)
    exact = n_buckets // 2
    large = exact + (torch.log(rel.clamp(min=1).float() / exact)
                     / math.log(max_distance / exact)
                     * (n_buckets - exact)).long()
    large = torch.clamp(large, max=n_buckets - 1)
    return torch.where(rel < exact, rel, large)


def causal_former(config: dict, weight, feats: torch.Tensor,
                  bits: Optional[int] = None) -> torch.Tensor:
    """feats [B, S, C] (the tower's output after ln_visual) → [B, n_causal,
    d_llm]."""
    t = config["t5"]
    c = "cformer.cformer."
    eps, h, dk = t["layer_norm_epsilon"], t["num_heads"], t["d_kv"]

    def lin(name, x):
        return quant_rows(x, bits) @ quant_rows(
            weight(name + ".weight").float(), bits).t()

    def rms(name, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * weight(name).float()

    def attend(prefix, xq, xkv, bias=None):
        b, lq, lk = xq.shape[0], xq.shape[1], xkv.shape[1]
        q = lin(prefix + ".q", xq).reshape(b, lq, h, dk).transpose(1, 2)
        k = lin(prefix + ".k", xkv).reshape(b, lk, h, dk).transpose(1, 2)
        v = lin(prefix + ".v", xkv).reshape(b, lk, h, dk).transpose(1, 2)
        s = q @ k.transpose(-1, -2)
        if bias is not None:
            s = s + bias
        o = (s.softmax(-1) @ v).transpose(1, 2).reshape(b, lq, h * dk)
        return lin(prefix + ".o", o)

    b = feats.shape[0]
    x = weight("cformer.causal_tokens").float().expand(b, -1, -1)
    n = x.shape[1]
    table = weight(c + "block.0.layer.0.SelfAttention."
                   "relative_attention_bias.weight").float()
    idx = buckets(n, n, t["relative_attention_num_buckets"],
                  t["relative_attention_max_distance"], feats.device)
    causal = torch.full((n, n), float("-inf"), device=feats.device).triu(1)
    self_bias = table[idx].permute(2, 0, 1)[None] + causal
    for i in range(t["num_layers"]):
        p = f"{c}block.{i}.layer."
        x = x + attend(p + "0.SelfAttention",
                       rms(p + "0.layer_norm.weight", x),
                       rms(p + "0.layer_norm.weight", x), self_bias)
        x = x + attend(p + "1.EncDecAttention",
                       rms(p + "1.layer_norm.weight", x), feats)
        hid = torch.relu(lin(p + "2.DenseReluDense.wi",
                             rms(p + "2.layer_norm.weight", x)))
        x = x + lin(p + "2.DenseReluDense.wo", hid)
    x = rms(c + "final_layer_norm.weight", x)
    return lin("cformer.projection", x) + \
        weight("cformer.projection.bias").float()
