"""LLaMA decoder with an explicit KV cache, as `emu_tpu/models/llama.py`:
RMSNorm (eps 1e-6), rotary attention, SwiGLU MLP, no biases, untied
lm_head, left-padded batches with positions from the attention mask.

The cache is head-major `{"k", "v": [L, B, Hkv, max_len, D]}`, or int8
values plus fp32 `"k_scale"`/`"v_scale"` [L, B, Hkv, max_len] per-(head,
token) scales (`init_cache(quant=True)`). Unlike the JAX package, whose
arrays are immutable, the port UPDATES IT IN PLACE: `prefill` writes each
layer's rows as it goes (quantized when the cache is int8), and the decode
forms (`decode_step`, `decode_step_rows`, `decode_mixed_rows`,
`decode_packed_rows`, `decode_chunk`) defer their writes — every layer
attends its own new k/v as extra columns (kernel D) and the step then
commits all layers' rows in one scatter per plane (`_cache_write_all`: one
slot, per-row slots, or per-row chunks).

Both norms of every bf16 layer run through kernel C at every row count;
the final norm keeps HF semantics (`layers.rms_norm`), as in the JAX
package. Prefill attention runs kernel A in causal mode at every prompt
length. fp32 activations take the plain compositions (`layers.rms_norm`,
the plain attention), as the JAX package leaves them to XLA. Training:
`forward_hidden(remat=...)` checkpoints each layer (`torch.utils.
checkpoint`) and `masked_ce_loss` streams the lm_head in checkpointed row
chunks; kernels A and C are differentiable (their backward kernels run in
the backward pass).
With int4 weights on the fused layout, decode-shaped batches (<= 32 rows)
run the whole MLP residual branch as kernel G (`q4_matmul.swiglu_q4_plan`),
and the int4 projections at <= 1024 rows run kernel F (`layers.dense`).

Tensor parallelism: every function takes the tree `parallel.shard_params`
returns for `sharding_rules` (`tensor_layout(cfg)` gives the fused parts
and head units). A rank holds H/n query heads and Hkv/n kv heads of the
fused or separate q/k/v planes (`_qkv` splits the local columns by the
local head counts), its gate/up columns, and its rows of `o_proj` and
`down`, whose products end in the sum over "model" before the residual add
(`layers.dense`). The int4 `o_proj`/`down` planes stay whole, as the JAX
rules keep them: the rank gathers its attention output or hidden slice and
runs kernel F on the whole plane. So kernel G, which fuses gate_up, SwiGLU,
down and the residual of one row, does not run on a sharded MLP
(`_layer`): it cannot take a rank's gate/up columns without a cut of
down's packed rows. `embed_tokens` (rows over "model") is a masked local
lookup summed over "model"; `lm_head` (columns) gathers the logits before
any warper, beam or trie sees them. The KV cache holds the local heads
(`init_cache(params=)`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from emu_tpu_torch.config import LlamaConfig
from emu_tpu_torch.bridge import layer
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops import rope as R
from emu_tpu_torch.ops.attention import cache_attention, dot_product_attention
from emu_tpu_torch.ops.fused_norm import add_rmsnorm, rms_norm_fused
from emu_tpu_torch.ops.q4_matmul import fused_swiglu_q4, swiglu_q4_plan
from emu_tpu_torch.parallel import mesh as M


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
    """x → roped q [B, S, H, D] and k, v [B, S, Hkv, D] (a rank's local
    heads on a sharded tree)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    if "qkv_proj" in p:
        qkv = L.dense(p["qkv_proj"], x, local=True)
        n = (h + 2 * hkv) * hd // qkv.shape[-1]   # ranks sharing the heads
        h, hkv = h // n, hkv // n
        q, k, v = qkv.split([h * hd, hkv * hd, hkv * hd], dim=-1)
    else:
        q, k, v = (L.dense(p[n], x, local=True)
                   for n in ("q_proj", "k_proj", "v_proj"))
        h, hkv = q.shape[-1] // hd, k.shape[-1] // hd
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
    gate_up = p["mlp"].get("gate_up")
    if (not (gate_up and L.cut_columns(gate_up))
            and swiglu_q4_plan(p["post_attention_layernorm"], p["mlp"], x)):
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
    """Token embeddings; on a tree whose `embed_tokens` rows are cut over
    "model", each rank looks up the ids in its rows (zeros elsewhere) and
    the lookups are summed over "model"."""
    table = params["embed_tokens"]
    rec = M.tp_of(params)
    if rec is None or not rec.cut("embed_tokens", 0):
        return table[token_ids]
    rows = table.shape[0]
    local = token_ids - rec.index * rows
    mine = (local >= 0) & (local < rows)
    e = table[local.clamp(0, rows - 1)] * mine[..., None].to(table.dtype)
    return M.reduce_from(e, rec.group)


def logits(params: dict, hidden):
    return L.dense(params["lm_head"], hidden)


def _remat_kwargs(remat) -> dict:
    """`torch.utils.checkpoint` arguments of a remat setting, the JAX
    package's policies mapped onto selective checkpointing: True recomputes
    the whole layer; "dots" keeps the outputs of the weight products
    (aten.mm / addmm, no batch dims: jax's dots_with_no_batch_dims_saveable)
    and recomputes the rest; "named" and "dots+attn" also keep kernel A's
    output (and lse), so the backward does not launch the attention forward
    again. In the JAX package "named" keeps the bf16 dense outputs where
    "dots" keeps fp32 dot results; torch's bf16 products are rounded
    already, so here the two named policies coincide."""
    if remat is True:
        return {}
    if remat == "dots+attn":      # an alias, kept for the JAX API's names
        remat = "named"
    saved = {"dots": ("mm",), "named": ("mm", "attn")}.get(remat)
    if saved is None:
        raise ValueError(f"unknown remat policy {remat!r}")
    ops = set()
    if "mm" in saved:
        ops |= {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    if "attn" in saved:
        ops.add(torch.ops.emu_tpu_torch.attention_fwd.default)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}


def forward_hidden(params: dict, cfg: LlamaConfig, inputs_embeds,
                   attention_mask, remat=False):
    """Causal forward over the whole sequence → final-norm hidden states.

    remat (under grad only): False keeps every layer's activations; True,
    "dots", "named" or "dots+attn" checkpoint each layer (`_remat_kwargs`).
    The JAX package's `scan_unroll` has no counterpart: the port's layer
    loop is an eager Python loop, unrolled already."""
    s = inputs_embeds.shape[1]
    rows = R.gather_rope_rows(*rope_tables(cfg, s, inputs_embeds.device),
                              _positions_from_mask(attention_mask))
    x = inputs_embeds

    def attend(q, k, v):
        return dot_product_attention(q, k, v, kv_valid=attention_mask,
                                     causal=True, scale=cfg.head_dim ** -0.5)

    def run(x, i):
        return _layer(layer(params["layers"], i), cfg, x, rows, attend)

    kw = _remat_kwargs(remat) if remat else None
    for i in range(cfg.num_hidden_layers):
        if kw is not None and torch.is_grad_enabled():
            x = checkpoint(run, x, i, use_reentrant=False, **kw)
        else:
            x = run(x, i)
    return L.rms_norm(params["norm"], x, cfg.rms_norm_eps)


def masked_ce_loss(params: dict, hidden, labels, valid, chunk: int = 1024):
    """Masked mean cross-entropy of the lm_head logits without [B, T, V]:
    hidden [B, T, D] (already shifted by the caller), labels/valid [B, T].
    Rows stream through the lm_head in `chunk`-row slabs, each under
    `torch.utils.checkpoint`, so the fp32 logits exist one chunk at a time
    and the backward recomputes them; the lm_head grad accumulates over the
    chunks. The same math as the full logsumexp CE (row chunking is exact),
    as `emu_tpu.models.llama.masked_ce_loss`."""
    d = hidden.shape[-1]
    hf = hidden.reshape(-1, d)
    tg = labels.reshape(-1)
    vl = valid.reshape(-1).float()

    def chunk_ll(h, tgt, v):
        lg = L.dense(params["lm_head"], h).float()
        picked = lg.gather(-1, tgt[:, None])[:, 0]
        return ((picked - torch.logsumexp(lg, -1)) * v).sum()

    total = hf.new_zeros((), dtype=torch.float32)
    for s0 in range(0, hf.shape[0], chunk):
        args = (hf[s0:s0 + chunk], tg[s0:s0 + chunk], vl[s0:s0 + chunk])
        total = total + (checkpoint(chunk_ll, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else chunk_ll(*args))
    count = vl.sum()
    rec = params["lm_head"].get(M.TP_KEY)
    if rec is not None and rec.mesh.group("data") is not None:
        # a data-sharded batch: this rank's share of the GLOBAL masked
        # mean (its sum over the count of every rank's valid tokens); the
        # ranks' losses and gradients sum to the global ones
        count = M.all_reduce(count.detach().clone(), rec.mesh.group("data"))
    return -total / count.clamp_min(1.0)


def local_kv_heads(params: Optional[dict], cfg: LlamaConfig) -> int:
    """The kv heads one rank's cache holds: Hkv, or Hkv/n on a tree whose
    k (or fused qkv) columns are cut over "model"."""
    if params is None:
        return cfg.kv_heads
    sa = params["layers"]["self_attn"]
    rec = L.cut_columns(sa.get("qkv_proj") or sa["k_proj"])
    return cfg.kv_heads // rec.size if rec is not None else cfg.kv_heads


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, *, device,
               dtype=torch.bfloat16, quant: bool = False,
               params: Optional[dict] = None) -> dict:
    """Head-major KV cache {"k", "v": [L, B, Hkv, max_len, D]}; quant=True
    stores int8 values with fp32 per-(head, token) scales
    {"k_scale", "v_scale": [L, B, Hkv, max_len]}. With the (sharded) param
    tree it will serve, the cache holds that rank's kv heads
    (`cache_sharding_rules`' head axis)."""
    shape = (cfg.num_hidden_layers, batch, local_kv_heads(params, cfg),
             max_len, cfg.head_dim)
    if quant:
        return {"k": torch.zeros(shape, device=device, dtype=torch.int8),
                "v": torch.zeros(shape, device=device, dtype=torch.int8),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


INV127 = float(np.float32(1.0 / 127.0))


def kv_quantize(x):
    """[..., D] → (int8 values, fp32 per-vector scale [...]). The scale is
    max|x| * fp32(1/127), what XLA compiles the JAX package's `/ 127.0` to
    inside its jitted programs."""
    xf = x.float()
    s = (xf.abs().amax(-1) * INV127).clamp_min(1e-8)
    q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def prefill(params: dict, cfg: LlamaConfig, inputs_embeds, attention_mask,
            cache: dict):
    """Run the prompt, writing cache slots [0, S) in place (quantized for
    an int8 cache; attention uses the exact k/v of the prompt). Returns
    (post-final-norm hidden [B, S, D], cache); left padding supported."""
    s = inputs_embeds.shape[1]
    max_len = cache["k"].shape[3]
    quant = "k_scale" in cache
    rows = R.gather_rope_rows(
        *rope_tables(cfg, max_len, inputs_embeds.device),
        _positions_from_mask(attention_mask))
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        def attend(q, k, v, i=i):
            kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])
            if quant:
                vals, sc = kv_quantize(kv)
                cache["k_scale"][i, :, :, :s] = sc[0]
                cache["v_scale"][i, :, :, :s] = sc[1]
            else:
                vals = kv
            cache["k"][i, :, :, :s] = vals[0]
            cache["v"][i, :, :, :s] = vals[1]
            return dot_product_attention(q, k, v, kv_valid=attention_mask,
                                         causal=True,
                                         scale=cfg.head_dim ** -0.5)

        x = _layer(layer(params["layers"], i), cfg, x, rows, attend)
    return L.rms_norm(params["norm"], x, cfg.rms_norm_eps), cache


def _cache_kv(cache: dict, i: int) -> dict:
    """Layer i's view for the attention dispatcher: the FULL stacked planes
    (and int8 scale planes) plus the index (the decode kernel offsets a
    pointer; nothing is sliced or copied)."""
    kv = {"k": cache["k"], "v": cache["v"], "layer": i}
    if "k_scale" in cache:
        kv["k_scale"], kv["v_scale"] = cache["k_scale"], cache["v_scale"]
    return kv


def _cache_write_all(cache: dict, new_rows, idx) -> dict:
    """Commit every layer's new rows in place, one scatter per plane.

    new_rows [L, 2, B, Hkv, q, D] (k then v on axis 1); int8 caches
    quantize them here, once over all layers. idx: a slot (rows land at
    [idx, idx + q)), or a (bidx, slots) pair: row b's q rows land at
    [slots[b], slots[b] + q). Chunk positions past the cache's end are
    dropped, as XLA drops out-of-range scatter rows in the JAX package
    (they are padding, never validated)."""
    kv = new_rows.transpose(0, 1)                   # [2, L, B, Hkv, q, D]
    q = kv.shape[4]
    if "k_scale" in cache:
        vals, scale = kv_quantize(kv)               # scale [2, L, B, Hkv, q]
    else:
        vals, scale = kv.to(cache["k"].dtype), None
    for t, key in enumerate(("k", "v")):
        planes = [(cache[key], vals[t])]
        if scale is not None:
            planes.append((cache[key + "_scale"], scale[t]))
        for plane, new in planes:
            if not isinstance(idx, tuple):
                plane[:, :, :, idx:idx + q] = new
            elif q == 1:
                bidx, slots = idx
                # advanced indices on dims 1 and 3 (split by a slice) go
                # first: the value is [B, L, Hkv(, D)]
                plane[:, bidx, :, slots] = new[:, :, :, 0].movedim(1, 0)
            else:
                bidx, slots = idx
                grid = slots[:, None] + torch.arange(q, device=slots.device)
                rows = new.movedim((1, 3), (0, 1))  # [B, q, L, Hkv(, D)]
                # past the end: rewrite column 0 at slots[b] instead (the
                # same value twice), so nothing lands out of range
                past = grid >= plane.shape[3]
                grid = torch.where(past, slots[:, None], grid)
                past = past.reshape(*past.shape, *([1] * (rows.dim() - 2)))
                rows = torch.where(past, rows[:, :1], rows)
                plane[:, bidx[:, None], :, grid] = rows
    return cache


def _cache_attend(cache: dict, cfg: LlamaConfig, cache_mask):
    """attend(i, q, k_new, v_new): layer i's attention over the cache
    (kernel D) with the layer's new k/v [B, Hkv, q, D] as extra columns.
    cache_mask must EXCLUDE the in-flight slots."""
    def attend(i, q, k_new, v_new):
        kv = _cache_kv(cache, i)
        kv["k_new"], kv["v_new"] = k_new, v_new
        return cache_attention(q, kv, kv_valid=cache_mask,
                               scale=cfg.head_dim ** -0.5)
    return attend


def _decode_layers(params: dict, cfg: LlamaConfig, token_embeds, rows,
                   attend):
    """Shared deferred-write decode body: every layer runs with
    attend(i, q, k_new, v_new) (`_cache_attend`); nothing is written while
    the layers run. Returns (post-norm hidden, every layer's new rows
    [L, 2, B, Hkv, q, D]) for the caller to commit (`_cache_write_all`)."""
    new_rows = []
    x = token_embeds
    for i in range(cfg.num_hidden_layers):
        def layer_attend(q, k, v, i=i):
            kn, vn = k.transpose(1, 2), v.transpose(1, 2)
            new_rows.append(torch.stack([kn, vn]))
            return attend(i, q, kn, vn)

        x = _layer(layer(params["layers"], i), cfg, x, rows, layer_attend)
    return (L.rms_norm(params["norm"], x, cfg.rms_norm_eps),
            torch.stack(new_rows))


def _deferred_decode(params: dict, cfg: LlamaConfig, cache: dict,
                     token_embeds, rows, cache_mask, commit_idx):
    """`_decode_layers` over the cache, then one commit of all layers'
    rows. cache_mask must EXCLUDE the in-flight slots; commit_idx is a slot
    or a (bidx, slots) pair."""
    hid, new_rows = _decode_layers(params, cfg, token_embeds, rows,
                                   _cache_attend(cache, cfg, cache_mask))
    _cache_write_all(cache, new_rows, commit_idx)
    return hid, cache


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
    return _deferred_decode(params, cfg, cache, token_embeds, rows,
                            cache_mask, slot)


def decode_chunk(params: dict, cfg: LlamaConfig, cache: dict, token_embeds,
                 slot: int, valid_len, positions):
    """Decode a CHUNK of q tokens against the cache in one forward (the
    speculative verify step): token_embeds [B, q, D] take cache slots
    [slot, slot + q); query i attends the cache positions j < valid_len[b]
    plus chunk columns <= i. positions [B, q]. Returns (post-norm hidden
    [B, q, D], cache)."""
    max_len = cache["k"].shape[3]
    rows = R.gather_rope_rows(*rope_tables(cfg, max_len, token_embeds.device),
                              positions)
    ar = torch.arange(max_len, device=token_embeds.device)
    cache_mask = ar[None] < valid_len[:, None]
    return _deferred_decode(params, cfg, cache, token_embeds, rows,
                            cache_mask, slot)


def decode_step_rows(params: dict, cfg: LlamaConfig, cache: dict,
                     token_embeds, slots, slot_mask, positions):
    """One decode step with PER-ROW cache write indices (continuous
    batching): slots [B]; slot_mask [B, max_len] already includes each
    row's own new slot. Returns (post-norm hidden [B, 1, D], cache)."""
    b = token_embeds.shape[0]
    max_len = cache["k"].shape[3]
    dev = token_embeds.device
    rows = R.gather_rope_rows(*rope_tables(cfg, max_len, dev),
                              positions[:, None])
    ar = torch.arange(max_len, device=dev)
    cache_mask = slot_mask & (ar[None] != slots[:, None])
    return _deferred_decode(params, cfg, cache, token_embeds, rows,
                            cache_mask, (torch.arange(b, device=dev), slots))


def decode_mixed_rows(params: dict, cfg: LlamaConfig, cache: dict,
                      token_embeds, slots, slot_mask, positions):
    """Mixed decode + prefill step (chunked prefill): token_embeds
    [B, q, D], row b's tokens take slots [slots[b], slots[b] + q); every
    query sees the committed cache (slot_mask must NOT include any
    in-flight slot) plus its own chunk prefix (column j iff j <= i).
    positions [B]: rope position of each row's FIRST token. Returns
    (post-norm hidden [B, q, D], cache)."""
    b, qn, _ = token_embeds.shape
    max_len = cache["k"].shape[3]
    dev = token_embeds.device
    # clamp to the table (overhang rows are padding, never validated)
    pos_grid = (positions[:, None]
                + torch.arange(qn, device=dev)[None]).clamp(max=max_len - 1)
    rows = R.gather_rope_rows(*rope_tables(cfg, max_len, dev), pos_grid)
    return _deferred_decode(params, cfg, cache, token_embeds, rows,
                            slot_mask, (torch.arange(b, device=dev), slots))


def decode_packed_rows(params: dict, cfg: LlamaConfig, cache: dict,
                       token_embeds, admit: int, slots, slot_mask, positions):
    """PACKED mixed decode + prefill step (chunked prefill of one slot):
    token_embeds [B + q, D], B the cache's rows. Row b < B is slot b's
    decode token, taking slot slots[b]; the last q rows are slot `admit`'s
    chunk, taking slots [slots[admit], slots[admit] + q). Row `admit` is
    padding: the chunk's commit overwrites its write. Every query sees the
    committed cache (slot_mask must NOT include any in-flight slot) plus
    its own new columns: a decode row its own token (kernel D's Sq = 1
    form), chunk row i chunk columns j <= i (D's chunk form on the
    admitting slot alone). positions [B]: each slot's next rope position.
    The layers run once over the B + q rows (`_layer`), where
    `decode_mixed_rows` runs B x q. Returns (post-norm hidden [B + q, D],
    cache)."""
    b = slots.shape[0]
    qn = token_embeds.shape[0] - b
    max_len = cache["k"].shape[3]
    dev = token_embeds.device
    # clamp to the table (overhang rows are padding, never validated)
    pos = torch.cat([positions, positions[admit]
                     + torch.arange(qn, device=dev)]).clamp(max=max_len - 1)
    rows = R.gather_rope_rows(*rope_tables(cfg, max_len, dev), pos[:, None])
    decode = _cache_attend(cache, cfg, slot_mask)
    # the admitting slot as a cache of one row: the slots folded into the
    # layer axis (a view), so kernel D reads layer i's row at i * B + admit
    own = _cache_attend({n: c.flatten(0, 1).unsqueeze(1)
                         for n, c in cache.items()},
                        cfg, slot_mask[admit:admit + 1])

    def attend(i, q, kn, vn):                        # kn, vn [B+q, Hkv, 1, D]
        chunk = own(i * b + admit, q[b:].transpose(0, 1),
                    *(t[b:].transpose(0, 2) for t in (kn, vn)))
        return torch.cat([decode(i, q[:b], kn[:b], vn[:b]),
                          chunk.transpose(0, 1)])

    hid, new_rows = _decode_layers(params, cfg, token_embeds[:, None], rows,
                                   attend)
    _cache_write_all(cache, new_rows[:, :, :b],
                     (torch.arange(b, device=dev), slots))
    _cache_write_all(cache, new_rows[:, :, b:].transpose(2, 4),
                     (torch.tensor([admit], device=dev),
                      slots[admit:admit + 1]))
    return hid[:, 0], cache


def regress_embeds(params: dict, cfg: LlamaConfig, n: int, embeds,
                   attention_mask, head, feed):
    """The visual regression loop of both Emu generations: prefill the
    prompt embeds [B, S, D] (left-padded by attention_mask), e_1 =
    head(last post-norm hidden), then n - 1 KV-cached decode steps, step i
    fed feed(e_i) → [B, n, d_out]."""
    b, s = attention_mask.shape
    total = -(-(s + n - 1) // 8) * 8
    cache = init_cache(cfg, b, total, device=embeds.device,
                       dtype=embeds.dtype, params=params)
    hidden, cache = prefill(params, cfg, embeds, attention_mask, cache)
    out = [head(hidden[:, -1])]
    slot_mask = torch.zeros(b, total, dtype=torch.bool, device=embeds.device)
    slot_mask[:, :s] = attention_mask.bool()
    positions = attention_mask.long().sum(-1)
    for i in range(n - 1):
        slot_mask[:, s + i] = True
        h, cache = decode_step(params, cfg, cache, feed(out[-1])[:, None, :],
                               s + i, slot_mask, positions)
        out.append(head(h[:, 0]))
        positions = positions + 1
    return torch.stack(out, dim=1)


def reorder_cache(cache: dict, beam_indices) -> dict:
    """Gather cache rows (and int8 scale planes) on beam-search reorder."""
    return {n: c[:, beam_indices] for n, c in cache.items()}


# ---------------------------------------------------------------------------
# Tensor-parallel sharding rules (stacked tensors: leading layer dim), the
# JAX package's table with its PartitionSpecs as tuples
# ---------------------------------------------------------------------------

sharding_rules = [
    (r"layers/self_attn/(q|k|v|qkv)_proj/kernel$", (None, None, "model")),
    (r"layers/self_attn/o_proj/kernel$", (None, "model", None)),
    (r"layers/mlp/(gate|up|gate_up)/kernel$", (None, None, "model")),
    (r"layers/mlp/down/kernel$", (None, "model", None)),
    (r"embed_tokens", ("model", None)),
    (r"lm_head/kernel$", (None, "model")),
    # quantized leaves (ops/quant.py), anchored so a float-kernel spec never
    # lands on a quantized leaf's packing dims; the int4 contraction planes
    # (o_proj, down) stay whole
    (r"layers/self_attn/(q|k|v|qkv)_proj/kernel_(q8|w8a8|q4)$",
     (None, None, "model")),
    (r"layers/self_attn/(q|k|v|qkv)_proj/kernel_s4$",
     (None, None, None, None, "model")),
    (r"layers/self_attn/(q|k|v|qkv)_proj/scale$", (None, "model")),
    (r"layers/self_attn/(q|k|v|qkv)_proj/scale4$", (None, None, "model")),
    (r"layers/self_attn/o_proj/kernel_(q8|w8a8)$", (None, "model", None)),
    (r"layers/mlp/(gate|up|gate_up)/kernel_(q8|w8a8|q4)$",
     (None, None, "model")),
    (r"layers/mlp/(gate|up|gate_up)/kernel_s4$",
     (None, None, None, None, "model")),
    (r"layers/mlp/(gate|up|gate_up)/scale$", (None, "model")),
    (r"layers/mlp/(gate|up|gate_up)/scale4$", (None, None, "model")),
    (r"layers/mlp/down/kernel_(q8|w8a8)$", (None, "model", None)),
    (r"lm_head/kernel_(q8|w8a8|q4)$", (None, "model")),
    (r"lm_head/kernel_s4$", (None, None, None, "model")),
    (r"lm_head/scale$", ("model",)),
    (r"lm_head/scale4$", (None, "model")),
]

cache_sharding_rules = [
    (r"[kv]$", (None, "data", None, "model", None)),
    (r"[kv]_scale$", (None, "data", None, "model")),
]


def tensor_layout(cfg: LlamaConfig) -> list:
    """`shard_params`' layout of the decoder: the parts of the fused planes
    (q | k | v with GQA's widths, gate | up) and the head unit of every
    plane cut by heads, so no rank gets part of a head."""
    hd, h, hkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    f = cfg.intermediate_size
    return [
        (r"layers/self_attn/qkv_proj/[^/]+$", (h * hd, hkv * hd, hkv * hd),
         hd),
        (r"layers/self_attn/(q|k|v|o)_proj/[^/]+$", None, hd),
        (r"layers/mlp/gate_up/[^/]+$", (f, f), 1),
    ]
