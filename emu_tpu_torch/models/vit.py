"""EVA-CLIP Vision Transformer (Emu1's ViT-g, Emu2's EVA-4B), as
`emu_tpu/models/vit.py`: patchify matmul, cls token, absolute position
embeddings, pre- or post-norm blocks with a fused qkv projection (q/v
biases only), GELU or SwiGLU MLP, and the sub-LN, layerscale, 2-D RoPE and
shared relative-position-bias variants. `forward_features` returns the raw
block output [B, n_patch + 1, width].

Plain blocks (no RoPE, no rel-pos bias, no sub-LN) in bf16 run their
attention through kernel A on head-major views of the qkv projection, q/v
biases inside the kernel (`_fused_attn_branch`), and their MLP residual
branch through kernel B, or kernel E for W8A8 weights at >= 2048 rows
(`layers.fused_block_mlp`). fp32 images (the trainer's) and the other
variants take plain torch, as they take XLA in the JAX package
(`vit.py:155`). `forward_features(remat=True)` checkpoints each block.
W8A8 towers (`quant.quantize_model_params`) quantize the qkv and proj
activations per token, as the JAX branch's `einsum_w8a8` does.

Tensor parallelism (a tree from `parallel.shard_params` with
`sharding_rules` and `tensor_layout(cfg)`): a rank holds its heads of the
fused qkv plane (per part, with its slices of q_bias and v_bias) and runs
kernel A on them; proj is row-parallel (`layers.dense` sums the partial
products over "model" before the bias). The MLP stays whole on every rank
(`tensor_layout` keeps its leaves whole, see `parallel.mesh`): kernel B's
post-norm form normalises the whole sum and kernel E takes each row's
maximum over the whole hidden, so each rank runs B or E on the whole MLP
as an unsharded tower does. `patch_embed` (columns over "model") is
gathered. A sub-LN over the attention output gathers it first; the shared
relative-position bias is sliced to the rank's heads.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from emu_tpu_torch.config import VisionConfig
from emu_tpu_torch.bridge import layer
from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops import quant as Q
from emu_tpu_torch.ops import rope as R
from emu_tpu_torch.ops.attention import dot_product_attention
from emu_tpu_torch.ops.flash_attention import mha_bhsd
from emu_tpu_torch.parallel import mesh as M


def relative_position_index(grid: int) -> np.ndarray:
    """2-D relative-position bucket index over (cls + grid²) tokens."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += grid - 1
    rel[:, :, 1] += grid - 1
    rel[:, :, 0] *= 2 * grid - 1
    num_rel = (2 * grid - 1) ** 2 + 3
    n = grid * grid
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel - 3
    idx[0:, 0] = num_rel - 2
    idx[0, 0] = num_rel - 1
    return idx


def init(cfg: VisionConfig, init: L.Init, quant=None) -> dict:
    """Random params; quant="w8a8" builds the blocks' matmul kernels (the
    JAX package's VIT_PATTERNS) already quantized, one layer at a time."""
    w, n = cfg.width, cfg.layers
    ahd = cfg.num_heads * cfg.head_width
    hidden = cfg.mlp_hidden
    blocks = {
        "norm1": init.layer_norm(n, dim=w),
        "norm2": init.layer_norm(n, dim=w),
        "attn": {
            "qkv": init.dense(n, in_dim=w, out_dim=3 * ahd, bias=False,
                              quant=quant),
            "q_bias": init.zeros(n, ahd),
            "v_bias": init.zeros(n, ahd),
            "proj": init.dense(n, in_dim=ahd, out_dim=w, quant=quant),
        },
    }
    if cfg.subln:
        blocks["attn"]["inner_ln"] = init.layer_norm(n, dim=ahd)
    if cfg.naiveswiglu:
        blocks["mlp"] = {
            "w1": init.dense(n, in_dim=w, out_dim=hidden, quant=quant),
            "w2": init.dense(n, in_dim=w, out_dim=hidden, quant=quant),
            "w3": init.dense(n, in_dim=hidden, out_dim=w, quant=quant)}
        if cfg.subln:
            blocks["mlp"]["ffn_ln"] = init.layer_norm(n, dim=hidden)
    else:
        blocks["mlp"] = {
            "fc1": init.dense(n, in_dim=w, out_dim=hidden, quant=quant),
            "fc2": init.dense(n, in_dim=hidden, out_dim=w, quant=quant)}
    if cfg.ls_init_value is not None:
        blocks["gamma_1"] = init.ones(n, w) * cfg.ls_init_value
        blocks["gamma_2"] = init.ones(n, w) * cfg.ls_init_value
    params = {
        "patch_embed": init.dense(in_dim=cfg.patch_size ** 2 * 3, out_dim=w),
        "cls_token": init.zeros(1, 1, w),
        "blocks": blocks,
    }
    if cfg.use_abs_pos_emb:
        params["pos_embed"] = init.normal(1, cfg.seq_len, w)
    if cfg.use_shared_rel_pos_bias:
        params["rel_pos_bias"] = init.zeros((2 * cfg.grid_size - 1) ** 2 + 3,
                                            cfg.num_heads)
    if cfg.num_classes > 0:
        params["norm"] = init.layer_norm(dim=w)
        params["head"] = init.dense(in_dim=w, out_dim=cfg.num_classes)
    return params


def _fused_attn_branch(cfg: VisionConfig, p: dict, x, g1):
    """Attention residual branch with head-major q/k/v straight from the
    qkv projection's [B, S, 3, H, D] output (strided views, no copies) and
    the q/v biases inside kernel A.

    pre-norm:  x + [g1 *] proj(MHA(qkv(LN(x))));
    post-norm: x + [g1 *] LN(proj(MHA(qkv(x))))."""
    pa = p["attn"]
    b, s, _ = x.shape
    d = cfg.head_width

    def project(src, params):
        """x @ W without bias, rounded once; W8A8 per token."""
        if "kernel_w8a8" in params:
            return Q.matmul_w8a8(src, params["kernel_w8a8"], params["scale"])
        return torch.matmul(src, params["kernel"].to(src.dtype))

    def attn_out(src):
        qkv = project(src, pa["qkv"])
        h = qkv.shape[-1] // (3 * d)          # this rank's heads
        q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
        o = mha_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     pa["q_bias"].view(h, d), pa["v_bias"].view(h, d),
                     scale=d ** -0.5)
        o = o.transpose(1, 2).reshape(b, s, h * d)
        if "kernel_w8a8" not in pa["proj"]:
            return L.dense(pa["proj"], o)
        # the W8A8 product rounds to the activation dtype before the fp32
        # bias add, as the JAX branch's einsum_w8a8 does
        y = L.dense({n: t for n, t in pa["proj"].items() if n != "bias"}, o)
        if "bias" in pa["proj"]:
            y = (y.float() + pa["proj"]["bias"].float()).to(y.dtype)
        return y

    if cfg.postnorm:
        y = L.layer_norm(p["norm1"], attn_out(x), cfg.ln_eps)
    else:
        y = attn_out(L.layer_norm(p["norm1"], x, cfg.ln_eps))
    if g1 is not None:
        y = y * g1.to(y.dtype)
    return x + y


def _block(cfg: VisionConfig, p: dict, x, rope_tables=None,
           rel_pos_bias=None):
    def attn(hs):
        b, s, _ = hs.shape
        qkv_bias = torch.cat([p["attn"]["q_bias"],
                              torch.zeros_like(p["attn"]["q_bias"]),
                              p["attn"]["v_bias"]])
        qkv = L.dense(dict(p["attn"]["qkv"], bias=qkv_bias), hs, local=True)
        hl = qkv.shape[-1] // (3 * cfg.head_width)   # this rank's heads
        q, k, v = (t.reshape(b, s, hl, cfg.head_width)
                   for t in qkv.chunk(3, dim=-1))
        bias = rel_pos_bias
        rec = L.cut_columns(p["attn"]["qkv"])
        if bias is not None and rec is not None:
            bias = M.copy_to(bias, rec.group)[
                :, rec.index * hl:(rec.index + 1) * hl]
        if rope_tables is not None:
            cos, sin = rope_tables
            # rotate patch tokens only; cls passes through
            q = torch.cat([q[:, :1], R.apply_vision_rope(q[:, 1:], cos, sin)],
                          dim=1)
            k = torch.cat([k[:, :1], R.apply_vision_rope(k[:, 1:], cos, sin)],
                          dim=1)
        o = dot_product_attention(q, k, v, scale=cfg.head_width ** -0.5,
                                  bias=bias).reshape(b, s, hl * cfg.head_width)
        if "inner_ln" in p["attn"]:
            if rec is not None:
                o = M.gather_last(o, rec.group)
            o = L.layer_norm(p["attn"]["inner_ln"], o, cfg.ln_eps)
        return L.dense(p["attn"]["proj"], o)

    def mlp(hs):
        if cfg.naiveswiglu:
            return L.swiglu_mlp(p["mlp"], hs, cfg.ln_eps)
        return L.gelu_mlp(p["mlp"], hs, cfg.ln_eps)

    def scaled(y, g):
        return y if g is None else y * g.to(y.dtype)

    g1, g2 = p.get("gamma_1"), p.get("gamma_2")
    plain_forms = all(("kernel" in p["attn"][n] or "kernel_w8a8" in p["attn"][n])
                      for n in ("qkv", "proj"))
    if (rope_tables is None and rel_pos_bias is None
            and "inner_ln" not in p["attn"] and plain_forms
            and _cuda.kernel_dtype(x)):
        x = _fused_attn_branch(cfg, p, x, g1)
    elif cfg.postnorm:
        x = x + scaled(L.layer_norm(p["norm1"], attn(x), cfg.ln_eps), g1)
    else:
        x = x + scaled(attn(L.layer_norm(p["norm1"], x, cfg.ln_eps)), g1)

    if g2 is None and "ffn_ln" not in p["mlp"]:
        y = L.fused_block_mlp(p["norm2"], p["mlp"], x, cfg.ln_eps,
                              cfg.postnorm)
        if y is not None:
            return y
    if cfg.postnorm:
        return x + scaled(L.layer_norm(p["norm2"], mlp(x), cfg.ln_eps), g2)
    return x + scaled(mlp(L.layer_norm(p["norm2"], x, cfg.ln_eps)), g2)


def forward_features(params: dict, cfg: VisionConfig, images,
                     compute_dtype=None, remat: bool = False):
    """[B, H, W, 3] normalized images → [B, n_patch + 1, width], computed
    in the images' dtype (the weights are cast to it), as the JAX ViT does;
    compute_dtype, when given, casts the images to it first. remat=True
    recomputes each block in the backward (torch.utils.checkpoint), the
    JAX package's per-block jax.checkpoint."""
    if compute_dtype is not None:
        images = images.to(compute_dtype)
    x = L.patch_embed(params["patch_embed"], images, cfg.patch_size)
    cls = params["cls_token"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    if "pos_embed" in params:
        x = x + params["pos_embed"].to(x.dtype)
    rope_tables = None
    if cfg.rope:
        cos, sin = R.vision_rope_tables(
            cfg.head_width // 2, cfg.pt_hw_seq_len,
            cfg.grid_size if cfg.intp_freq else None)
        rope_tables = (torch.from_numpy(cos).to(x.device),
                       torch.from_numpy(sin).to(x.device))
    rel_bias = None
    if "rel_pos_bias" in params:
        idx = torch.from_numpy(relative_position_index(cfg.grid_size)
                               ).to(x.device)
        # [S, S, H] → [1, H, S, S], shared by every block
        rel_bias = params["rel_pos_bias"][idx].permute(2, 0, 1)[None]
    for i in range(cfg.layers):
        p = layer(params["blocks"], i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block, cfg, p, x, rope_tables, rel_bias,
                           use_reentrant=False)
        else:
            x = _block(cfg, p, x, rope_tables, rel_bias)
    return x


def forward_head(params: dict, cfg: VisionConfig, features):
    """The classifier path (cls token → norm → head) of a tower built with
    `num_classes > 0`; the Emu composites do not use it."""
    x = L.layer_norm(params["norm"], features, cfg.ln_eps)
    return L.dense(params["head"], x[:, 0])


# ---------------------------------------------------------------------------
# Tensor-parallel sharding rules (over the "model" mesh axis), the JAX
# package's table with its PartitionSpecs as tuples; stacked block tensors
# carry a leading layer dim
# ---------------------------------------------------------------------------

sharding_rules = [
    (r"blocks/attn/qkv/kernel$", (None, None, "model")),
    (r"blocks/attn/(q|v)_bias", (None, "model")),
    (r"blocks/attn/proj/kernel$", (None, "model", None)),
    (r"blocks/mlp/(fc1|w1|w2)/kernel$", (None, None, "model")),
    (r"blocks/mlp/(fc1|w1|w2)/bias", (None, "model")),
    (r"blocks/mlp/(fc2|w3)/kernel$", (None, "model", None)),
    (r"patch_embed/kernel", (None, "model")),
    # W8A8 tower: int8 kernels keep the float rank; per-out-channel scales
    # shard where the kernel's out dim does
    (r"blocks/attn/qkv/kernel_w8a8$", (None, None, "model")),
    (r"blocks/attn/qkv/scale$", (None, "model")),
    (r"blocks/attn/proj/kernel_w8a8$", (None, "model", None)),
    (r"blocks/mlp/(fc1|w1|w2)/kernel_w8a8$", (None, None, "model")),
    (r"blocks/mlp/(fc1|w1|w2)/scale$", (None, "model")),
    (r"blocks/mlp/(fc2|w3)/kernel_w8a8$", (None, "model", None)),
]


def tensor_layout(cfg: VisionConfig) -> list:
    """`shard_params`' layout of the tower: the fused qkv plane's three
    parts, the head unit of every plane cut by heads, and the MLP kept
    whole (the rules' MLP cuts are dropped: kernels B and E read it)."""
    ahd, hd = cfg.num_heads * cfg.head_width, cfg.head_width
    return [
        (r"blocks/attn/qkv/[^/]+$", (ahd, ahd, ahd), hd),
        (r"blocks/attn/(q_bias|v_bias|proj/[^/]+)$", None, hd),
        (r"blocks/mlp/", None, M.WHOLE),
    ]
