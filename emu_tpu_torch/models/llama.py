"""LLaMA decoder with an explicit KV cache, as `emu_tpu/models/llama.py`:
RMSNorm (eps 1e-6), rotary attention, SwiGLU MLP, no biases, untied
lm_head, left-padded batches with positions from the attention mask.

The cache is head-major `{"k", "v": [L, B, Hkv, max_len, D]}`. Unlike the
JAX package, whose arrays are immutable, the port UPDATES IT IN PLACE:
`prefill` writes each layer's rows as it goes, and `decode_step` defers its
writes — every layer attends its own new k/v as an extra column (kernel D)
and the step then commits all layers' rows with one copy per plane.

Both norms of every layer run through kernel C at every row count; the
final norm keeps HF semantics (`layers.rms_norm`), as in the JAX package.
Prefill attention runs kernel A in causal mode at every prompt length.
With int4 weights on the fused layout, decode-shaped batches (<= 32 rows)
run the whole MLP residual branch as kernel G (`q4_matmul.swiglu_q4_plan`),
and the int4 projections at <= 1024 rows run kernel F (`layers.dense`).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from emu_tpu.config import LlamaConfig
from emu_tpu_torch.bridge import layer
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops import rope as R
from emu_tpu_torch.ops.attention import cache_attention, dot_product_attention
from emu_tpu_torch.ops.fused_norm import add_rmsnorm, rms_norm_fused
from emu_tpu_torch.ops.q4_matmul import fused_swiglu_q4, swiglu_q4_plan


def init(cfg: LlamaConfig, init: L.Init, with_regress_head: bool = False,
         fused: bool = False, quant=None) -> dict:
    """Random params. fused=True draws the `fuse_projections` layout
    (qkv_proj, gate_up) directly; quant ("int8", "int4") builds every
    projection and the lm_head already quantized, one layer at a time."""
    d, n, f = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    kvd = cfg.kv_heads * cfg.head_dim

    def lin(i, o):
        return init.dense(n, in_dim=i, out_dim=o, bias=False, quant=quant)

    if fused:
        attn = {"qkv_proj": lin(d, d + 2 * kvd), "o_proj": lin(d, d)}
        mlp = {"gate_up": lin(d, 2 * f), "down": lin(f, d)}
    else:
        attn = {"q_proj": lin(d, d), "k_proj": lin(d, kvd),
                "v_proj": lin(d, kvd), "o_proj": lin(d, d)}
        mlp = {"gate": lin(d, f), "up": lin(d, f), "down": lin(f, d)}
    params = {
        "embed_tokens": init.normal(cfg.extended_vocab_size, d),
        "layers": {
            "input_layernorm": init.ones(n, d),
            "post_attention_layernorm": init.ones(n, d),
            "self_attn": attn,
            "mlp": mlp,
        },
        "norm": init.ones(d),
        "lm_head": init.dense(in_dim=d, out_dim=cfg.extended_vocab_size,
                              bias=False, quant=quant),
    }
    if with_regress_head:
        params["stu_regress_head"] = init.dense(in_dim=d, out_dim=d,
                                                bias=False)
    return params


@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim: int, max_len: int, theta: float, device: str):
    cos, sin = R.llama_rope_tables(head_dim, max_len, theta)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def rope_tables(cfg: LlamaConfig, max_len: int, device) -> Tuple:
    """(cos, sin) [max_len, D] fp32 on `device`; shared, read-only."""
    return _rope_tables(cfg.head_dim, max_len, cfg.rope_theta, str(device))


def fuse_projections(params: dict) -> dict:
    """q/k/v → one `qkv_proj` and gate/up → one `gate_up` matmul per layer
    (column concatenation, numerically exact; fewer launches per step).
    Every dense form concatenates on the output axis: float, int8
    weight-only, W8A8 and int4 (with a bias, if any)."""
    keysets = (("kernel",), ("kernel_q8", "scale"), ("kernel_w8a8", "scale"),
               ("kernel_q4", "scale4"))

    def cat(parts):
        for keys in keysets:
            if keys[0] in parts[0]:
                if "bias" in parts[0]:
                    keys = keys + ("bias",)
                extra = set(parts[0]) - set(keys)
                if extra:
                    raise ValueError(
                        f"fuse_projections: unfusable extra entries {extra}")
                return {k: torch.cat([p[k] for p in parts], dim=-1)
                        for k in keys}
        raise ValueError(f"unrecognized dense params: {list(parts[0])}")

    layers = dict(params["layers"])
    sa, mlp = dict(layers["self_attn"]), dict(layers["mlp"])
    sa["qkv_proj"] = cat([sa.pop("q_proj"), sa.pop("k_proj"), sa.pop("v_proj")])
    mlp["gate_up"] = cat([mlp.pop("gate"), mlp.pop("up")])
    layers["self_attn"], layers["mlp"] = sa, mlp
    return dict(params, layers=layers)


def _qkv(p, cfg: LlamaConfig, x, rope_rows):
    """x → roped q [B, S, H, D] and k, v [B, S, Hkv, D]."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    if "qkv_proj" in p:
        q, k, v = L.dense(p["qkv_proj"], x).split(
            [h * hd, hkv * hd, hkv * hd], dim=-1)
    else:
        q, k, v = (L.dense(p[n], x) for n in ("q_proj", "k_proj", "v_proj"))
    q, k = R.apply_rope_rows(q.reshape(b, s, h, hd), k.reshape(b, s, hkv, hd),
                             *rope_rows)
    return q, k, v.reshape(b, s, hkv, hd)


def _layer(p, cfg: LlamaConfig, x, rope_rows, attend):
    """One decoder layer; `attend(q, k_new, v_new)` is the attention of the
    mode (prefill's causal attention, or the cached decode attention)."""
    h = rms_norm_fused(p["input_layernorm"], x, cfg.rms_norm_eps)
    q, k, v = _qkv(p["self_attn"], cfg, h, rope_rows)
    b, s = x.shape[:2]
    o = attend(q, k, v).reshape(b, s, -1)
    attn_out = L.dense(p["self_attn"]["o_proj"], o)
    if swiglu_q4_plan(p["post_attention_layernorm"], p["mlp"], x):
        gu, dn = p["mlp"]["gate_up"], p["mlp"]["down"]
        return fused_swiglu_q4(x + attn_out, p["post_attention_layernorm"],
                               gu["kernel_q4"], gu["scale4"], dn["kernel_q4"],
                               dn["scale4"], eps=cfg.rms_norm_eps)
    x, h = add_rmsnorm(p["post_attention_layernorm"], x, attn_out,
                       cfg.rms_norm_eps)
    return x + L.llama_mlp(p["mlp"], h)


def _positions_from_mask(attention_mask):
    """HF-style position ids for left-padded batches: cumsum - 1, clipped."""
    return (attention_mask.long().cumsum(-1) - 1).clamp_min(0)


def embed(params: dict, token_ids):
    return params["embed_tokens"][token_ids]


def logits(params: dict, hidden):
    return L.dense(params["lm_head"], hidden)


def forward_hidden(params: dict, cfg: LlamaConfig, inputs_embeds,
                   attention_mask):
    """Causal forward over the whole sequence → final-norm hidden states."""
    s = inputs_embeds.shape[1]
    rows = R.gather_rope_rows(*rope_tables(cfg, s, inputs_embeds.device),
                              _positions_from_mask(attention_mask))
    x = inputs_embeds

    def attend(q, k, v):
        return dot_product_attention(q, k, v, kv_valid=attention_mask,
                                     causal=True, scale=cfg.head_dim ** -0.5)

    for i in range(cfg.num_hidden_layers):
        x = _layer(layer(params["layers"], i), cfg, x, rows, attend)
    return L.rms_norm(params["norm"], x, cfg.rms_norm_eps)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16) -> dict:
    """Head-major KV cache {"k", "v": [L, B, Hkv, max_len, D]}."""
    shape = (cfg.num_hidden_layers, batch, cfg.kv_heads, max_len,
             cfg.head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def prefill(params: dict, cfg: LlamaConfig, inputs_embeds, attention_mask,
            cache: dict):
    """Run the prompt, writing cache slots [0, S) in place. Returns
    (post-final-norm hidden [B, S, D], cache); left padding supported."""
    s = inputs_embeds.shape[1]
    max_len = cache["k"].shape[3]
    rows = R.gather_rope_rows(
        *rope_tables(cfg, max_len, inputs_embeds.device),
        _positions_from_mask(attention_mask))
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        def attend(q, k, v, i=i):
            cache["k"][i, :, :, :s] = k.transpose(1, 2)
            cache["v"][i, :, :, :s] = v.transpose(1, 2)
            return dot_product_attention(q, k, v, kv_valid=attention_mask,
                                         causal=True,
                                         scale=cfg.head_dim ** -0.5)

        x = _layer(layer(params["layers"], i), cfg, x, rows, attend)
    return L.rms_norm(params["norm"], x, cfg.rms_norm_eps), cache


def _cache_kv(cache: dict, i: int) -> dict:
    """Layer i's view for the attention dispatcher: the FULL stacked planes
    plus the index (the decode kernel offsets a pointer; nothing is sliced
    or copied)."""
    return {"k": cache["k"], "v": cache["v"], "layer": i}


def decode_step(params: dict, cfg: LlamaConfig, cache: dict, token_embeds,
                slot: int, slot_mask, positions):
    """One decode step.

    token_embeds [B, 1, D]; slot: the cache index this token takes;
    slot_mask [B, max_len] bool, valid slots up to and including `slot`;
    positions [B] rope positions. Returns (post-norm hidden [B, 1, D],
    cache) with the new rows committed in place after the layer loop."""
    max_len = cache["k"].shape[3]
    rows = R.gather_rope_rows(*rope_tables(cfg, max_len, token_embeds.device),
                              positions[:, None])
    # the current token's row is not in the cache while the layers run
    cache_mask = slot_mask.clone()
    cache_mask[:, slot] = False
    new_k, new_v = [], []
    x = token_embeds
    for i in range(cfg.num_hidden_layers):
        def attend(q, k, v, i=i):
            kv = _cache_kv(cache, i)
            kv["k_new"], kv["v_new"] = k.transpose(1, 2), v.transpose(1, 2)
            new_k.append(kv["k_new"])
            new_v.append(kv["v_new"])
            return cache_attention(q, kv, kv_valid=cache_mask,
                                   scale=cfg.head_dim ** -0.5)

        x = _layer(layer(params["layers"], i), cfg, x, rows, attend)
    cache["k"][:, :, :, slot:slot + 1] = torch.stack(new_k)
    cache["v"][:, :, :, slot:slot + 1] = torch.stack(new_v)
    return L.rms_norm(params["norm"], x, cfg.rms_norm_eps), cache
