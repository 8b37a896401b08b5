"""Emu1 composite: EVA-ViT-g → ln_visual → Causal Former → LLaMA-13B, as
`emu_tpu/models/emu1.py` (captioning/VQA path: `encode_image`,
`scatter_image_embeds`, `generate`; training: `forward_loss`). `Emu1` is
the nn.Module that holds the param tree under the JAX package's names."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from emu_tpu_torch.config import Emu1Config
from emu_tpu_torch.bridge import ParamTree
from emu_tpu_torch.generation.engine import GenerationConfig, llama_generate
from emu_tpu_torch.models import causal_former, llama, vit
from emu_tpu_torch.ops import layers as L


def init(cfg: Emu1Config, init: L.Init) -> dict:
    return {
        "visual": vit.init(cfg.vision, init),
        "ln_visual": init.layer_norm(dim=cfg.vision.width),
        "cformer": causal_former.init(cfg.t5, cfg.n_causal,
                                      cfg.llama.hidden_size, init),
        "decoder": llama.init(cfg.llama, init, with_regress_head=True),
    }


def encode_image(params: dict, cfg: Emu1Config, images):
    """[B, H, W, 3] normalized images → [B, n_causal, d_llm]."""
    feats = vit.forward_features(params["visual"], cfg.vision, images)
    feats = L.layer_norm(params["ln_visual"], feats, eps=1e-6)
    return causal_former.forward(params["cformer"], cfg.t5, feats)


def scatter_image_embeds(params: dict, token_ids, image_embeds,
                         image_token_id: int):
    """Embed tokens and overwrite the `<image>` positions, in reading
    order, with image_embeds [n_images * n_causal, d]."""
    embeds = llama.embed(params["decoder"], token_ids)
    if image_embeds is None:
        return embeds
    is_img = token_ids == image_token_id
    b, s = token_ids.shape
    order = is_img.reshape(-1).long().cumsum(0) - 1
    gathered = image_embeds[order.clamp(0, image_embeds.shape[0] - 1)]
    gathered = gathered.reshape(b, s, -1).to(embeds.dtype)
    return torch.where(is_img[:, :, None], gathered, embeds)


def forward_loss(params: dict, cfg: Emu1Config, token_ids, attention_mask,
                 image_embeds, special_ids: Tuple[int, int, int, int],
                 remat=False):
    """Masked shifted cross-entropy (the reference's modeling_llama.py
    loss), as `emu_tpu.models.emu1.forward_loss`: special_ids are (pad,
    [IMG], [/IMG], <image>); those targets and padding are ignored. remat
    takes `llama.forward_hidden`'s policies."""
    pad_id, img_id, img_end_id, image_id = special_ids
    embeds = scatter_image_embeds(params, token_ids, image_embeds, image_id)
    hidden = llama.forward_hidden(params["decoder"], cfg.llama, embeds,
                                  attention_mask, remat=remat)
    ignore = ((token_ids == pad_id) | (token_ids == img_id)
              | (token_ids == img_end_id) | (token_ids == image_id))
    shift_valid = ~ignore[:, 1:] & attention_mask[:, 1:].bool()
    return llama.masked_ce_loss(params["decoder"], hidden[:, :-1],
                                token_ids[:, 1:], shift_valid)


def generate(params: dict, cfg: Emu1Config, token_ids, attention_mask,
             image_embeds, gcfg: GenerationConfig, image_token_id: int,
             stats: Optional[dict] = None):
    """Multimodal text generation → new token ids (see llama_generate)."""
    embeds = scatter_image_embeds(params, token_ids, image_embeds,
                                  image_token_id)
    return llama_generate(params["decoder"], cfg.llama, embeds,
                          attention_mask, gcfg, stats=stats)


class Emu1(ParamTree):
    """The Emu1 parameters as an nn.Module; `state_dict()` keys are the
    JAX param paths (`visual.blocks.attn.qkv.kernel`, ...)."""

    def __init__(self, cfg: Emu1Config, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def fuse_projections(self) -> None:
        """Switch the decoder to the fused qkv/gate_up layout in place;
        the unfused weights are released."""
        self.decoder = ParamTree(llama.fuse_projections(self.decoder.tree()))

    def encode_image(self, images):
        return encode_image(self.tree(), self.cfg, images)

    def generate(self, token_ids, attention_mask, image_embeds,
                 gcfg: GenerationConfig, image_token_id: int,
                 stats: Optional[dict] = None):
        return generate(self.tree(), self.cfg, token_ids, attention_mask,
                        image_embeds, gcfg, image_token_id, stats)
