"""Checkpoint loading: the reference's torch / safetensors state dicts →
the port's param tree, as `emu_tpu/checkpoint.py`, and the port's own
format for saving and restoring a tree.

`load_state_dict` reads `.bin`/`.pt` (the `"module"` wrapper unwrapped,
`weights_only=True`, memory-mapped when the file is a zip archive),
`.safetensors` through the port's own reader (`read_safetensors`: the
file memory-mapped, every tensor in the file's dtype, bf16 included), HF
sharded directories (`*.index.json`, the safetensors index first) and
diffusers component directories holding one weights blob. Tensors stay in
the file's dtype on the host until a converter moves them.

The converters (`convert_vit`, `convert_llama`, `convert_t5_decoder`,
`convert_emu1`, `convert_emu2`, `convert_unet`, `convert_vae`) build the
JAX package's tree: torch Linear [out, in] → kernel [in, out], Conv2d OIHW
→ HWIO, the patch-embed conv → the patchify matmul's [(p p 3), w], and
per-layer modules → stacked [L, ...] tensors. Each leaf is moved to the
target device in the file's layout, transposed there and written once,
contiguous, in the target dtype. Stacked layers land one layer at a time in
a tensor allocated once on the device; `convert_emu2(quantize=)` fuses and
quantizes each layer as it lands (`ops.quant`'s serving recipe), so the
33B decoder is never whole in bf16 on the card.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
import zipfile
from typing import Callable, Dict, Optional

import torch

from emu_tpu_torch.config import (Emu1Config, Emu2Config, LlamaConfig,
                                  T5Config, UNetConfig, VAEConfig,
                                  VisionConfig)

# safetensors dtype names ↔ torch dtypes
SAFETENSORS_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file → {name: tensor in the file's dtype}: an
    8-byte little-endian header length, the JSON header (`dtype`, `shape`,
    `data_offsets` relative to the data after it), then the raw bytes. The
    tensors are views of a private memory map of the file (pages are read
    when touched)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = info["shape"]
        start, end = info["data_offsets"]
        count = 1
        for s in shape:
            count *= s
        if end - start != count * dtype.itemsize or base + end > len(mm):
            raise ValueError(f"{path}: {name}'s data_offsets {start}, {end} "
                             f"do not hold {shape} {info['dtype']}")
        out[name] = (torch.frombuffer(mm, dtype=dtype, count=count,
                                      offset=base + start).reshape(shape)
                     if count else torch.empty(shape, dtype=dtype))
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch `.bin`/`.pt` (with an optional `"module"` wrapper), a
    `.safetensors` file, an HF sharded directory (`*.index.json`; a
    dual-format directory's safetensors index wins) or a diffusers
    component directory with one weights blob, into host tensors in the
    files' dtypes."""
    if os.path.isdir(path):
        indexes = sorted(glob.glob(os.path.join(path, "*.index.json")),
                         key=lambda p: (".safetensors" not in p, p))
        if indexes:
            with open(indexes[0]) as f:
                weight_map = json.load(f)["weight_map"]
            out: Dict[str, torch.Tensor] = {}
            for shard in sorted(set(weight_map.values())):
                out.update(load_state_dict(os.path.join(path, shard)))
            return out
        for pattern in ("*.safetensors", "*.bin"):
            blobs = sorted(glob.glob(os.path.join(path, pattern)))
            if len(blobs) == 1:
                return load_state_dict(blobs[0])
            if len(blobs) > 1:
                names = [os.path.basename(b) for b in blobs]
                raise ValueError(f"{path}: ambiguous weights blobs {names}; "
                                 "pass the file path explicitly")
        raise FileNotFoundError(
            f"{path}: no *.index.json or weights blob found")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=zipfile.is_zipfile(path))
    if isinstance(ckpt.get("module"), dict):
        ckpt = ckpt["module"]
    return dict(ckpt)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn: Callable, dst, src) -> None:
    if isinstance(dst, dict):
        for k, v in dst.items():
            _tree_zip(fn, v, src[k])
    else:
        fn(dst, src)


class _SD:
    """A prefixed view over a flat state dict, with the conversions. Every
    leaf is moved to `device` in the file's layout, then permuted and
    written once, contiguous, in `dtype`."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str = "",
                 dtype: torch.dtype = torch.float32, device="cpu"):
        self.sd, self.prefix = sd, prefix
        self.dtype, self.device = dtype, torch.device(device)

    def sub(self, p: str) -> "_SD":
        return _SD(self.sd, self.prefix + p + ".", self.dtype, self.device)

    def has(self, name: str) -> bool:
        return self.prefix + name in self.sd

    def leaf(self, name: str, *perm: int) -> torch.Tensor:
        t = self.sd[self.prefix + name].to(self.device)
        if perm:
            t = t.permute(*perm)
        return torch.empty(t.shape, dtype=self.dtype,
                           device=self.device).copy_(t)

    def raw(self, name: str) -> torch.Tensor:
        return self.leaf(name)

    def linear(self, name: str, bias: bool = True) -> dict:
        p = {"kernel": self.leaf(name + ".weight", 1, 0)}
        if bias and self.has(name + ".bias"):
            p["bias"] = self.raw(name + ".bias")
        return p

    def conv(self, name: str) -> dict:
        return {"kernel": self.leaf(name + ".weight", 2, 3, 1, 0),
                "bias": self.raw(name + ".bias")}

    def ln(self, name: str) -> dict:
        return {"scale": self.raw(name + ".weight"),
                "bias": self.raw(name + ".bias")}

    def stack(self, n: int, fn: Callable[["_SD"], dict], fmt: str,
              land: Optional[Callable[[dict], dict]] = None) -> dict:
        """Layers 0..n-1 (`fmt` names layer i's prefix) stacked on a
        leading dim, one layer at a time into tensors allocated once;
        `land` transforms each layer's tree before it lands (e.g. fuses and
        quantizes it)."""
        out = None
        for i in range(n):
            tree = fn(self.sub(fmt.format(i)))
            if land is not None:
                tree = land(tree)
            if out is None:
                out = _tree_map(lambda x: x.new_empty((n, *x.shape)), tree)
            _tree_zip(lambda dst, src: dst[i].copy_(src), out, tree)
        return out


# ---------------------------------------------------------------------------
# Model-family converters
# ---------------------------------------------------------------------------


def convert_vit(sd: _SD, cfg: VisionConfig, land=None) -> dict:
    p_sz = cfg.patch_size
    params = {
        "patch_embed": {
            "kernel": sd.leaf("patch_embed.proj.weight", 2, 3, 1, 0
                              ).reshape(p_sz * p_sz * 3, -1),
            "bias": sd.raw("patch_embed.proj.bias"),
        },
        "cls_token": sd.raw("cls_token"),
    }
    if sd.has("pos_embed"):
        params["pos_embed"] = sd.raw("pos_embed")
    if sd.has("rel_pos_bias.relative_position_bias_table"):
        params["rel_pos_bias"] = sd.raw(
            "rel_pos_bias.relative_position_bias_table")

    def block(b: _SD) -> dict:
        p = {
            "norm1": b.ln("norm1"),
            "norm2": b.ln("norm2"),
            "attn": {
                "qkv": b.linear("attn.qkv", bias=False),
                "q_bias": b.raw("attn.q_bias"),
                "v_bias": b.raw("attn.v_bias"),
                "proj": b.linear("attn.proj"),
            },
        }
        if b.has("attn.inner_attn_ln.weight"):
            p["attn"]["inner_ln"] = b.ln("attn.inner_attn_ln")
        if b.has("mlp.w1.weight"):
            p["mlp"] = {"w1": b.linear("mlp.w1"), "w2": b.linear("mlp.w2"),
                        "w3": b.linear("mlp.w3")}
            if b.has("mlp.ffn_ln.weight"):
                p["mlp"]["ffn_ln"] = b.ln("mlp.ffn_ln")
        else:
            p["mlp"] = {"fc1": b.linear("mlp.fc1"),
                        "fc2": b.linear("mlp.fc2")}
        if b.has("gamma_1"):
            p["gamma_1"] = b.raw("gamma_1")
            p["gamma_2"] = b.raw("gamma_2")
        return p

    params["blocks"] = sd.stack(cfg.layers, block, "blocks.{}", land)
    if sd.has("norm.weight"):
        params["norm"] = sd.ln("norm")
        params["head"] = sd.linear("head")
    return params


def convert_llama(sd: _SD, cfg: LlamaConfig, regress_head: bool = False,
                  land=None) -> dict:
    """`sd` prefixed at the HF LlamaForCausalLM root (e.g. `decoder.lm.`)."""

    def layer(l: _SD) -> dict:
        return {
            "input_layernorm": l.raw("input_layernorm.weight"),
            "post_attention_layernorm": l.raw(
                "post_attention_layernorm.weight"),
            "self_attn": {f"{n}_proj": l.linear(f"self_attn.{n}_proj",
                                                bias=False)
                          for n in ("q", "k", "v", "o")},
            "mlp": {"gate": l.linear("mlp.gate_proj", bias=False),
                    "up": l.linear("mlp.up_proj", bias=False),
                    "down": l.linear("mlp.down_proj", bias=False)},
        }

    params = {
        "embed_tokens": sd.raw("model.embed_tokens.weight"),
        "layers": sd.sub("model").stack(cfg.num_hidden_layers, layer,
                                        "layers.{}", land),
        "norm": sd.raw("model.norm.weight"),
        "lm_head": sd.linear("lm_head", bias=False),
    }
    if regress_head and sd.has("stu_regress_head.weight"):
        params["stu_regress_head"] = sd.linear("stu_regress_head",
                                               bias=False)
    return params


def convert_t5_decoder(sd: _SD, cfg: T5Config, land=None) -> dict:
    """`sd` prefixed at the T5 decoder stack root (`cformer.cformer.`)."""

    def block(b: _SD) -> dict:
        def attn(idx, name):
            a = b.sub(f"layer.{idx}")
            return {"ln": a.raw("layer_norm.weight"),
                    **{n: a.linear(f"{name}.{n}", bias=False)
                       for n in ("q", "k", "v", "o")}}
        ff = b.sub("layer.2")
        return {
            "self_attn": attn(0, "SelfAttention"),
            "cross_attn": attn(1, "EncDecAttention"),
            "ff": {"ln": ff.raw("layer_norm.weight"),
                   "wi": ff.linear("DenseReluDense.wi", bias=False),
                   "wo": ff.linear("DenseReluDense.wo", bias=False)},
        }

    return {
        "layers": sd.stack(cfg.num_layers, block, "block.{}", land),
        "rel_bias": sd.raw(
            "block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "final_ln": sd.raw("final_layer_norm.weight"),
    }


def convert_emu1(sd_flat: Dict[str, torch.Tensor], cfg: Emu1Config,
                 dtype=torch.float32, device="cpu", mesh=None) -> dict:
    """With `mesh`, this rank's slice by `emu1.sharding_rules` (see
    `_Cutter`)."""
    sd = _SD(sd_flat, dtype=dtype, device=device)
    cut = _Cutter(mesh, "emu1", cfg)
    tree = {
        "visual": convert_vit(sd.sub("visual"), cfg.vision,
                              cut.stack("visual/blocks", cfg.vision.layers)),
        "ln_visual": sd.ln("ln_visual"),
        "cformer": {
            "cformer": convert_t5_decoder(
                sd.sub("cformer.cformer"), cfg.t5,
                cut.stack("cformer/cformer/layers", cfg.t5.num_layers)),
            "causal_tokens": sd.raw("cformer.causal_tokens"),
            "projection": sd.linear("cformer.projection"),
        },
        "decoder": convert_llama(
            sd.sub("decoder.lm"), cfg.llama, regress_head=True,
            land=cut.stack("decoder/layers", cfg.llama.num_hidden_layers)),
    }
    return cut.record(tree)


class _Cutter:
    """A converter's sharding (none without a mesh): each stacked layer is
    cut to this rank's slice as it lands (`parallel.mesh.cut_layer`, on the
    device), and `record` cuts the remaining leaves and writes the tree's
    `Shards` records, so a rank holds its share of the tree and one whole
    layer at a time.

    A quantizing landing (`Landing`) is planned on the meta device first:
    a float kernel whose quantized leaves are all cut over their output
    columns, as the kernel itself is (fused planes per part), is cut before
    it is quantized. Quantization is per output column, so this gives the
    bits of quantizing the whole layer and then cutting it, with a rank's
    columns of fp32 work in place of the whole plane's. Every other leaf
    (the row-cut planes, which int8's per-column scales and int4's groups
    span) is quantized whole and then cut."""

    def __init__(self, mesh, model: str, cfg):
        self.mesh, self.planned = mesh, {}
        if mesh is not None:
            from emu_tpu_torch.models import emu1, emu2
            mod = {"emu1": emu1, "emu2": emu2}[model]
            self.rules, self.layout = mod.sharding_rules, \
                mod.tensor_layout(cfg)

    def stack(self, path: str, n: int, land=None):
        """The landing of the stack under `path`: `land`, then the cut."""
        if self.mesh is None:
            return land
        from emu_tpu_torch.parallel.mesh import cut_layer

        def landing(tree):
            if isinstance(land, Landing):
                return self._quantize_cut(tree, path, n, land)
            tree = land(tree) if land is not None else tree
            return cut_layer(tree, path, n, self.mesh, self.rules,
                             self.layout, self.planned)
        return landing

    def _quantize_cut(self, tree: dict, path: str, n: int, land: "Landing"):
        from emu_tpu_torch.parallel.mesh import cut_layer, local_slice
        mesh = self.mesh
        floats = land.prepare(tree)
        # the plans of the float leaves, and every landed leaf's plan (into
        # `planned`) and local shape, from the shapes alone
        float_plans = {}
        cut_layer(_on_meta(floats), path, n, mesh, self.rules, self.layout,
                  float_plans)
        whole = land.quantize(_on_meta(floats))
        local = cut_layer(whole, path, n, mesh, self.rules, self.layout,
                          self.planned)
        first = set()

        def column_cut(plan):
            """(axis, parts) of a plan that cuts the last dim alone."""
            spec, parts = plan
            return (None if spec[-1] is None or any(spec[:-1])
                    else (spec[-1], parts))

        def precut(f: dict, w: dict, sub: str) -> dict:
            out = dict(f)
            for k, v in f.items():
                if isinstance(v, dict):
                    out[k] = precut(v, w[k], f"{sub}/{k}")
            if "kernel" not in f or "kernel" in w:
                return out
            spec, parts = float_plans[f"{sub}/kernel"]
            landed = [q for q in w if q not in f]
            by = column_cut((spec, parts))
            if by is None or any(column_cut(self.planned[f"{sub}/{q}"]) != by
                                 for q in landed):
                return out
            out["kernel"] = local_slice(f["kernel"], spec[1:], parts,
                                        mesh).contiguous()
            first.update(f"{sub}/{q}" for q in landed)
            return out

        cut_floats = precut(floats, whole, path)
        del floats           # the whole fused planes, before any fp32 work
        landed = land.quantize(cut_floats)
        del cut_floats

        def cut(t: dict, m: dict, sub: str) -> dict:
            out = {}
            for k, v in t.items():
                p = f"{sub}/{k}"
                if isinstance(v, dict):
                    out[k] = cut(v, m[k], p)
                    continue
                spec, parts = self.planned[p]
                if p not in first and any(a is not None for a in spec):
                    v = local_slice(v, spec[1:], parts, mesh).contiguous()
                if v.shape != m[k].shape:
                    raise AssertionError(f"{p}: landed {tuple(v.shape)}, "
                                         f"planned {tuple(m[k].shape)}")
                out[k] = v
            return out
        return cut(landed, local, path)

    def record(self, tree: dict) -> dict:
        if self.mesh is None:
            return tree
        from emu_tpu_torch.parallel.mesh import shard_params
        return shard_params(tree, self.mesh, self.rules, self.layout,
                            planned=self.planned)


def _on_meta(tree: dict) -> dict:
    return {k: _on_meta(v) if isinstance(v, dict)
            else torch.empty_like(v, device="meta") for k, v in tree.items()}


class Landing:
    """A layer transform of `quantized_landing`: `prepare` (float to float,
    the decoder's q/k/v and gate/up fusion) then `quantize`; calling it
    runs both."""

    def __init__(self, prepare, quantize):
        self.prepare, self.quantize = prepare, quantize

    def __call__(self, tree: dict) -> dict:
        return self.quantize(self.prepare(tree))


def quantized_landing(quantize: Optional[str]):
    """(decoder layer, ViT block) `Landing`s that give one layer the
    serving recipe of `ops.quant.quantize_model_params` as it lands: the
    decoder fused (qkv_proj, gate_up) and weight-only int8/int4, the tower
    W8A8; (None, None) without quantize."""
    if not quantize:
        return None, None
    from emu_tpu_torch.models import llama
    from emu_tpu_torch.ops import quant as Q
    if quantize not in Q.QUANTIZE_MODES:
        raise ValueError(f"quantize mode {quantize!r}: pick from "
                         f"{Q.QUANTIZE_MODES}")
    bits = 4 if quantize == "int4" else 8

    def fuse(t):
        return llama.fuse_projections({"layers": t})["layers"]

    def decoder_layer(t):
        return Q.quantize_tree({"layers": t}, bits=bits)["layers"]

    def vit_block(t):
        return Q.quantize_tree({"blocks": t}, Q.VIT_PATTERNS,
                               act_quant=True)["blocks"]

    return Landing(fuse, decoder_layer), Landing(lambda t: t, vit_block)


def convert_emu2(sd_flat: Dict[str, torch.Tensor], cfg: Emu2Config,
                 dtype=torch.float32, device="cpu",
                 quantize: Optional[str] = None, mesh=None) -> dict:
    """quantize: None, or "int8"/"int4": each decoder layer fused and
    quantized and each tower block W8A8 as it lands (the lm_head is left
    to `quantize_model_params`, which the pipelines apply). With `mesh`,
    this rank's slice by `emu2.sharding_rules`, each layer cut after its
    quantization (see `_Cutter`)."""
    sd = _SD(sd_flat, dtype=dtype, device=device)
    decoder_land, vit_land = quantized_landing(quantize)
    cut = _Cutter(mesh, "emu2", cfg)
    return cut.record({
        "visual": convert_vit(
            sd.sub("visual"), cfg.vision,
            cut.stack("visual/blocks", cfg.vision.layers, vit_land)),
        "decoder": convert_llama(
            sd.sub("decoder.lm"), cfg.llama,
            land=cut.stack("decoder/layers", cfg.llama.num_hidden_layers,
                           decoder_land)),
        "project_up": sd.linear("project_up", bias=False),
        "project_down": sd.linear("project_down", bias=False),
    })


# ---------------------------------------------------------------------------
# Diffusers UNet / VAE
# ---------------------------------------------------------------------------


def _tf2d(a: _SD, n_layers: int, use_linear: bool) -> dict:
    def attn(t: _SD, n: str) -> dict:
        return {"to_q": t.linear(f"{n}.to_q", bias=False),
                "to_k": t.linear(f"{n}.to_k", bias=False),
                "to_v": t.linear(f"{n}.to_v", bias=False),
                "to_out": t.linear(f"{n}.to_out.0")}

    def tfb(t: _SD) -> dict:
        return {
            "norm1": t.ln("norm1"), "norm2": t.ln("norm2"),
            "norm3": t.ln("norm3"),
            "attn1": attn(t, "attn1"), "attn2": attn(t, "attn2"),
            "ff": {"proj_in": t.linear("ff.net.0.proj"),
                   "proj_out": t.linear("ff.net.2")},
        }

    proj = a.linear if use_linear else a.conv
    return {"norm": a.ln("norm"),
            "blocks": [tfb(a.sub(f"transformer_blocks.{j}"))
                       for j in range(n_layers)],
            "proj_in": proj("proj_in"), "proj_out": proj("proj_out")}


def _resnet(r: _SD) -> dict:
    p = {"norm1": r.ln("norm1"), "conv1": r.conv("conv1"),
         "norm2": r.ln("norm2"), "conv2": r.conv("conv2")}
    if r.has("time_emb_proj.weight"):
        p["time_emb_proj"] = r.linear("time_emb_proj")
    if r.has("conv_shortcut.weight"):
        p["conv_shortcut"] = r.conv("conv_shortcut")
    return p


def convert_unet(sd_flat: Dict[str, torch.Tensor], cfg: UNetConfig,
                 dtype=torch.float32, device="cpu") -> dict:
    sd = _SD(sd_flat, dtype=dtype, device=device)
    params = {
        "conv_in": sd.conv("conv_in"),
        "time_embedding": {
            "linear_1": sd.linear("time_embedding.linear_1"),
            "linear_2": sd.linear("time_embedding.linear_2")},
        "conv_norm_out": sd.ln("conv_norm_out"),
        "conv_out": sd.conv("conv_out"),
    }
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": sd.linear("add_embedding.linear_1"),
            "linear_2": sd.linear("add_embedding.linear_2")}

    def block(b: _SD, n_res: int, tf_layers: int, cross: bool,
              sampler: str) -> dict:
        p = {"resnets": [_resnet(b.sub(f"resnets.{j}"))
                         for j in range(n_res)],
             "attentions": [_tf2d(b.sub(f"attentions.{j}"), tf_layers,
                                  cfg.use_linear_projection)
                            for j in range(n_res)] if cross else []}
        if b.has(f"{sampler}.0.conv.weight"):
            p[sampler] = b.conv(f"{sampler}.0.conv")
        return p

    n = cfg.layers_per_block
    params["down_blocks"] = [
        block(sd.sub(f"down_blocks.{i}"), n,
              cfg.transformer_layers_per_block[i],
              t == "CrossAttnDownBlock2D", "downsamplers")
        for i, t in enumerate(cfg.down_block_types)]
    params["mid_block"] = {
        "resnets": [_resnet(sd.sub("mid_block.resnets.0")),
                    _resnet(sd.sub("mid_block.resnets.1"))],
        "attentions": [_tf2d(sd.sub("mid_block.attentions.0"),
                             cfg.transformer_layers_per_block[-1],
                             cfg.use_linear_projection)],
    }
    rev_tf = list(reversed(cfg.transformer_layers_per_block))
    params["up_blocks"] = [
        block(sd.sub(f"up_blocks.{i}"), n + 1, rev_tf[i],
              t == "CrossAttnUpBlock2D", "upsamplers")
        for i, t in enumerate(cfg.up_block_types)]
    return params


def convert_vae(sd_flat: Dict[str, torch.Tensor], cfg: VAEConfig,
                dtype=torch.float32, device="cpu") -> dict:
    sd = _SD(sd_flat, dtype=dtype, device=device)

    def attn(a: _SD) -> dict:
        return {"group_norm": a.ln("group_norm"),
                "to_q": a.linear("to_q"), "to_k": a.linear("to_k"),
                "to_v": a.linear("to_v"), "to_out": a.linear("to_out.0")}

    def mid(m: _SD) -> dict:
        return {"resnets": [_resnet(m.sub("resnets.0")),
                            _resnet(m.sub("resnets.1"))],
                "attention": attn(m.sub("attentions.0"))}

    def side(s: _SD, blocks: str, n_res: int, sampler: str) -> dict:
        out = {"conv_in": s.conv("conv_in"), blocks: [],
               "mid_block": mid(s.sub("mid_block")),
               "conv_norm_out": s.ln("conv_norm_out"),
               "conv_out": s.conv("conv_out")}
        for i in range(len(cfg.block_out_channels)):
            b = s.sub(f"{blocks}.{i}")
            blk = {"resnets": [_resnet(b.sub(f"resnets.{j}"))
                               for j in range(n_res)]}
            if b.has(f"{sampler}.0.conv.weight"):
                blk[sampler] = b.conv(f"{sampler}.0.conv")
            out[blocks].append(blk)
        return out

    return {"encoder": side(sd.sub("encoder"), "down_blocks",
                            cfg.layers_per_block, "downsamplers"),
            "decoder": side(sd.sub("decoder"), "up_blocks",
                            cfg.layers_per_block + 1, "upsamplers"),
            "quant_conv": sd.conv("quant_conv"),
            "post_quant_conv": sd.conv("post_quant_conv")}


# ---------------------------------------------------------------------------
# High-level entry points
# ---------------------------------------------------------------------------


def load_emu1_checkpoint(path: str, cfg: Emu1Config, dtype=torch.bfloat16,
                         device="cuda", mesh=None) -> dict:
    """An Emu1 state dict (file or directory) → the param tree on
    `device`; peft LoRA adapters (Emu-I: r=16, α=16 on q/k/v/o_proj) are
    merged into the base weights first. With `mesh` (a `parallel.
    make_mesh`), the tree is this rank's slice by `emu1.sharding_rules`,
    each layer cut as it lands on `device` (`convert_emu1`)."""
    sd = load_state_dict(path)
    if any(".lora_A." in k for k in sd):
        from emu_tpu_torch.ops.lora import merge_lora_state_dict
        sd = merge_lora_state_dict(sd)
    return convert_emu1(sd, cfg, dtype, device, mesh)


def load_emu2_checkpoint(path: str, cfg: Emu2Config, dtype=torch.bfloat16,
                         device="cuda", quantize: Optional[str] = None,
                         mesh=None) -> dict:
    """An Emu2 state dict (file or directory) → the param tree on
    `device`, each decoder layer and tower block quantized as it lands
    when `quantize` is given (see `convert_emu2`). With `mesh`, this
    rank's slice by `emu2.sharding_rules`, each layer quantized on
    `device` and then cut."""
    return convert_emu2(load_state_dict(path), cfg, dtype, device, quantize,
                        mesh)


# ---------------------------------------------------------------------------
# The port's own format: a param tree saved once, restored without the
# conversion (the JAX package uses orbax here)
# ---------------------------------------------------------------------------


def _plain(tree):
    """The tree as plain dicts and lists of detached tensors that own
    their storage (a view would save the whole storage it lives in); a
    sharded tree's records are left out."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()
                if isinstance(v, (dict, list, torch.Tensor))}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    t = tree.detach()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def save_params(path: str, params) -> str:
    """Write a param tree (quantized leaves as they are; a
    `bridge.trainable` tree too) to one file at `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_plain(params), path)
    return path


def restore_params(path: str, like=None, device="cuda", mesh=None,
                   rules=None, layout=None):
    """A tree written by `save_params`, loaded with `weights_only=True` onto
    `device`. With `like` (a tree of the expected structure, whole) every
    leaf's path, shape and dtype must match it. With `mesh`, `rules` and
    the model's `tensor_layout(cfg)` as `layout`, the file is mapped on
    the host and only this rank's slice of each leaf goes to `device`
    (`parallel.shard_params`)."""
    from emu_tpu_torch.bridge import flatten
    sharded = mesh is not None
    if sharded and (rules is None or layout is None):
        raise ValueError("restore_params(mesh=) needs the model's rules "
                         "and its tensor_layout(cfg) as layout")
    tree = torch.load(path, map_location="cpu" if sharded else device,
                      weights_only=True, mmap=sharded)
    if like is not None:
        got, want = flatten(tree), flatten(like)
        bad = sorted(set(got) ^ set(want))
        bad += [f"{k}: {tuple(got[k].shape)} {got[k].dtype} != "
                f"{tuple(v.shape)} {v.dtype}" for k, v in want.items()
                if k in got and (got[k].shape != v.shape
                                 or got[k].dtype != v.dtype)]
        if bad:
            raise ValueError(f"{path} does not match `like`: {bad[:8]}")
    if sharded:
        from emu_tpu_torch.parallel.mesh import shard_params
        return shard_params(tree, mesh, rules, layout,
                            device=torch.device(device))
    return tree
