"""Plain PyTorch reference of the LLaMA decoder as the served
configurations state it: RMSNorm (HF semantics), rotary attention with
LLaMA's half rotation, a SwiGLU MLP, no biases, an untied lm_head.

It runs in fp32 with TF32 off, one layer at a time over a few whole
sequences (no cache, no batching, no kernel), drawing each layer's weights
again from the run's seed through `weight(name)`. What the configuration
quantizes it quantizes again by the configuration's rule:

- int4 weights ("int4"): each output column in groups of `group` input
  rows, scale max|w| / 7, values round(w / scale) in [-7, 7];
- int8 KV cache (`kv_bits` 8): each position's key and value vector of a
  head rounded to max|x| / 127 steps once it is cached, so a position
  attends the earlier positions' rounded keys and values and its own
  exact ones, as a decode step that writes its own keys after attending;
- activations: exact (fp32) unless `act_bits` asks for the rows that enter
  an int4 product rounded per row to that many bits.

The control of a cell calls it with every int8 quantity at int4
(`act_bits=4`, `kv_bits=4`).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch


def quant_rows(x: torch.Tensor, bits) -> torch.Tensor:
    """x rounded per row (last dim) to symmetric `bits`-bit integer steps,
    or with bits "fp8" to float8 e4m3 after scaling each row's max to 448;
    None leaves it exact."""
    if bits is None:
        return x
    if bits == "fp8":
        s = (x.abs().amax(-1, keepdim=True) / 448.0).clamp_min(1e-12)
        return (x / s).to(torch.float8_e4m3fn).float() * s
    levels = 2 ** (bits - 1) - 1
    s = (x.abs().amax(-1, keepdim=True) / levels).clamp_min(1e-8)
    return torch.round(x / s).clamp(-levels, levels) * s


def int4_dequant(w_out_in: torch.Tensor, group: int = 128) -> torch.Tensor:
    """A Linear weight [out, in] → the int4 values of its kernel [in, out]
    (groups of `group` input rows per output column), in fp32."""
    k = w_out_in.float().t()
    n_in, n_out = k.shape
    g = group
    while g > 1 and ((n_in // 2) % g or n_in % g):
        g //= 2
    kg = k.reshape(n_in // g, g, n_out)
    s = (kg.abs().amax(1, keepdim=True) / 7.0).clamp_min(1e-8)
    return (torch.round(kg / s).clamp(-7, 7) * s).reshape(n_in, n_out)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x [T, H, D] at positions pos [T]: LLaMA's rotate-half form."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                        device=x.device) / d))
    ang = pos.double()[:, None] * inv[None]
    ang = torch.cat([ang, ang], -1)
    c, s = ang.cos().float()[:, None], ang.sin().float()[:, None]
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * c + half * s


def attend(q, k, v, kv_bits: Optional[int]):
    """Causal attention of [T, H, D] q/k/v, each position attending the
    earlier positions' keys and values as the cache holds them (rounded to
    `kv_bits`) and its own exactly."""
    t, h, d = q.shape
    kc, vc = quant_rows(k, kv_bits), quant_rows(v, kv_bits)
    qh, kh, vh = q.transpose(0, 1), kc.transpose(0, 1), vc.transpose(0, 1)
    s = qh @ kh.transpose(1, 2) * d ** -0.5                  # [H, T, T]
    own = (q * k).sum(-1).transpose(0, 1) * d ** -0.5          # [H, T]
    idx = torch.arange(t, device=q.device)
    s[:, idx, idx] = own
    s = s.masked_fill(idx[None, :] > idx[:, None], float("-inf"))
    p = s.softmax(-1)
    o = p @ vh                                                 # [H, T, D]
    diag = p[:, idx, idx][..., None]                           # [H, T, 1]
    o = o + diag * (v.transpose(0, 1) - vh)
    return o.transpose(0, 1).reshape(t, h * d)


def decoder_spec(s: dict, lm: dict, prefix: str) -> None:
    """The decoder's entries in a benchmark state-dict spec (HF LLaMA names
    under `prefix`): every matrix at std 1 / sqrt(fan-in), the residual
    branches' last products (o_proj, down_proj) a further 1 / sqrt(2 L),
    GPT-2's scaled init. With every matrix at std 0.02 instead, a 60 x 6656
    decoder's attention is so peaked that bf16 rounding alone moves its
    logits by whole units, and no comparison could tell a fault from
    rounding."""
    from benchmark import weights as W
    d, f, v_rows = (lm["hidden_size"], lm["intermediate_size"],
                    lm["extended_vocab_size"])
    kvd = d // lm["num_attention_heads"] * (
        lm.get("num_key_value_heads") or lm["num_attention_heads"])
    m = prefix + "model."
    s[m + "embed_tokens.weight"] = ((v_rows, d), "normal:0.02")
    n_layers = lm["num_hidden_layers"]
    out = (2 * n_layers) ** -0.5
    for i in range(n_layers):
        b = f"{m}layers.{i}."
        s[b + "input_layernorm.weight"] = ((d,), "ones:0.05")
        s[b + "post_attention_layernorm.weight"] = ((d,), "ones:0.05")
        for n, o in (("q", d), ("k", kvd), ("v", kvd)):
            W.linear(s, f"{b}self_attn.{n}_proj", d, o, bias=False)
        W.linear(s, b + "self_attn.o_proj", d, d, bias=False, gain=out)
        W.linear(s, b + "mlp.gate_proj", d, f, bias=False)
        W.linear(s, b + "mlp.up_proj", d, f, bias=False)
        W.linear(s, b + "mlp.down_proj", f, d, bias=False, gain=out)
    s[m + "norm.weight"] = ((d,), "ones:0.05")
    W.linear(s, prefix + "lm_head", d, v_rows, bias=False)


def logits(cfg: dict, weight: Callable[[str], torch.Tensor], prefix: str,
           seqs: Sequence[torch.Tensor], rows: Sequence[torch.Tensor],
           int4: bool, act_bits: Optional[int] = None,
           kv_bits: Optional[int] = None,
           embeds: Optional[Sequence] = None,
           w_bits: Optional[int] = None) -> List[torch.Tensor]:
    """fp32 logits [len(rows[i]), V] at positions rows[i] of each token
    sequence seqs[i] (1-D ids). `weight(name)` draws a state-dict tensor
    (HF names under `prefix`, e.g. "decoder.lm."); `embeds[i]`, when given,
    is (positions, fp32 [n, D]) that replace those positions' token
    embeddings (the visual tokens). Float weights (`int4` False) are taken
    as they are, or rounded per output channel to `w_bits`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h = cfg["num_attention_heads"]
    hkv = cfg.get("num_key_value_heads") or h
    m = prefix + "model."

    def kernel(name):
        w = weight(name)
        if int4:
            return int4_dequant(w)
        return quant_rows(w.float(), w_bits).t()

    def dense(w, x):
        return quant_rows(x, act_bits) @ w

    table = weight(m + "embed_tokens.weight")
    xs = []
    for i, ids in enumerate(seqs):
        x = table[ids].float()
        if embeds is not None and embeds[i] is not None:
            pos, e = embeds[i]
            x[pos] = e.float()
        xs.append(x)
    del table
    names = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
             "mlp.down_proj")
    for layer in range(cfg["num_hidden_layers"]):
        p = f"{m}layers.{layer}."
        w_in = weight(p + "input_layernorm.weight").float()
        w_post = weight(p + "post_attention_layernorm.weight").float()
        wq, wk, wv, wo, wg, wu, wd = (kernel(f"{p}{n}.weight")
                                      for n in names)
        for i, x in enumerate(xs):
            t = x.shape[0]
            a = rms_norm(x, w_in, eps)
            q = dense(wq, a).reshape(t, h, -1)
            k = dense(wk, a).reshape(t, hkv, -1)
            v = dense(wv, a).reshape(t, hkv, -1)
            pos = torch.arange(t, device=x.device)
            q, k = rope(q, pos, theta), rope(k, pos, theta)
            if hkv != h:
                k = k.repeat_interleave(h // hkv, 1)
                v = v.repeat_interleave(h // hkv, 1)
            x = x + dense(wo, attend(q, k, v, kv_bits))
            b = rms_norm(x, w_post, eps)
            xs[i] = x + dense(wd, torch.nn.functional.silu(dense(wg, b))
                              * dense(wu, b))
        del wq, wk, wv, wo, wg, wu, wd
    w_norm = weight(m + "norm.weight").float()
    head = kernel(prefix + "lm_head.weight")
    return [dense(head, rms_norm(x[r], w_norm, eps))
            for x, r in zip(xs, rows)]
