"""Emu2 composite: EVA-4B ViT → avg-pool + linear → LLaMA-33B, as
`emu_tpu/models/emu2.py` (the text path: `encode_image`, `encode_image_lm`,
`scatter_embeds`, `generate`). `Emu2` is the nn.Module that holds the param
tree under the JAX package's names."""

from __future__ import annotations

from typing import Optional

import torch

from emu_tpu.config import Emu2Config
from emu_tpu_torch.bridge import ParamTree
from emu_tpu_torch.generation.engine import GenerationConfig, llama_generate
from emu_tpu_torch.models import llama, vit
from emu_tpu_torch.ops import layers as L


def init(cfg: Emu2Config, init: L.Init, quantize: Optional[str] = None
         ) -> dict:
    """Random params. quantize=None gives the JAX package's float tree;
    "int8"/"int4" gives what `EmuChatGeneration(quantize=...)` serves (the
    decoder on the fused qkv/gate_up layout, weight-only; the tower W8A8),
    drawn and quantized one layer at a time, so the full Emu2 is built on
    one card without its bf16 tree ever existing."""
    w, d = cfg.vision.width, cfg.llama.hidden_size
    return {
        "visual": vit.init(cfg.vision, init,
                           quant="w8a8" if quantize else None),
        "decoder": llama.init(cfg.llama, init, fused=bool(quantize),
                              quant=quantize),
        "project_up": init.dense(in_dim=w, out_dim=d, bias=False),
        "project_down": init.dense(in_dim=d, out_dim=w, bias=False),
    }


def encode_image(params: dict, cfg: Emu2Config, images,
                 n_query: Optional[int] = None):
    """[B, H, W, 3] → [B, n_query, 1792] pooled visual tokens."""
    feats = vit.forward_features(params["visual"], cfg.vision, images)
    return L.avg_pool_tokens(feats[:, 1:, :], n_query or cfg.n_query)


def encode_image_lm(params: dict, cfg: Emu2Config, images,
                    n_query: Optional[int] = None):
    """encode_image projected to LM width: [B, n_query, 6656]."""
    return L.dense(params["project_up"],
                   encode_image(params, cfg, images, n_query))


def scatter_embeds(params: dict, token_ids, visual_embeds, placeholder_id: int,
                   base_embeds=None):
    """Embed tokens and overwrite the placeholder positions, in reading
    order, with visual_embeds [n_placeholders, d]; pass the previous result
    as base_embeds to scatter a second modality."""
    embeds = (llama.embed(params["decoder"], token_ids)
              if base_embeds is None else base_embeds)
    if visual_embeds is None:
        return embeds
    is_ph = token_ids == placeholder_id
    b, s = token_ids.shape
    order = is_ph.reshape(-1).long().cumsum(0) - 1
    gathered = visual_embeds[order.clamp(0, visual_embeds.shape[0] - 1)]
    gathered = gathered.reshape(b, s, -1).to(embeds.dtype)
    return torch.where(is_ph[:, :, None], gathered, embeds)


def generate(params: dict, cfg: Emu2Config, token_ids, attention_mask,
             gcfg: GenerationConfig, image_token_id: int, image_embeds=None,
             video_token_id: Optional[int] = None, video_embeds=None,
             stats: Optional[dict] = None):
    """Multimodal text generation → new token ids (see llama_generate)."""
    embeds = scatter_embeds(params, token_ids, image_embeds, image_token_id)
    if video_embeds is not None:
        embeds = scatter_embeds(params, token_ids, video_embeds,
                                video_token_id, base_embeds=embeds)
    return llama_generate(params["decoder"], cfg.llama, embeds,
                          attention_mask, gcfg, stats=stats)


class Emu2(ParamTree):
    """The Emu2 parameters as an nn.Module; `state_dict()` keys are the
    JAX param paths (`visual.blocks.attn.qkv.kernel`, ...)."""

    def __init__(self, cfg: Emu2Config, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def encode_image_lm(self, images, n_query: Optional[int] = None):
        return encode_image_lm(self.tree(), self.cfg, images, n_query)
