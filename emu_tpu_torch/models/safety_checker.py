"""Stable-Diffusion safety checker: the CLIP ViT-L/14 vision tower plus
concept thresholds, as `emu_tpu/models/safety_checker.py` (the diffusers
`StableDiffusionSafetyChecker` both reference pipelines run after VAE
decode): CLIP-embed the image, compare its cosine similarity with 17 NSFW
concept embeddings (3 special-care embeddings tighten the thresholds) and
black out flagged images.

The tower (quick-GELU, class embedding, pre/post LayerNorm) computes in
its pixels' dtype, the weights cast to it, as the JAX `dense` does:
`SafetyChecker` feeds it fp32 pixels, so it runs fp32 on the plain routes
(`attention_route`, `dense_plan`), as the JAX package runs fp32 XLA; bf16
pixels (`clip.image_embeds`) take `batched_mha` and kernel H.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from emu_tpu_torch.bridge import layer
from emu_tpu_torch.checkpoint import _SD
from emu_tpu_torch.ops import layers as L
from emu_tpu_torch.ops.attention import dot_product_attention
from emu_tpu_torch.pipelines import preprocess


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @classmethod
    def tiny(cls):
        return cls(image_size=28, patch_size=14, hidden_size=32,
                   num_layers=2, num_heads=2, intermediate_size=64,
                   projection_dim=16)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def encoder_layers_init(init: L.Init, n: int, d: int, ffn: int) -> dict:
    """n stacked CLIP encoder layers (LN, q/k/v/out, fc1/fc2), shared by
    the vision and text towers."""
    return {
        "ln1": init.layer_norm(n, dim=d),
        "ln2": init.layer_norm(n, dim=d),
        "attn": {k: init.dense(n, in_dim=d, out_dim=d)
                 for k in ("q", "k", "v", "out")},
        "mlp": {"fc1": init.dense(n, in_dim=d, out_dim=ffn),
                "fc2": init.dense(n, in_dim=ffn, out_dim=d)},
    }


def tower_init(cfg: CLIPVisionConfig, init: L.Init) -> dict:
    """The vision tower and its projection."""
    d = cfg.hidden_size
    grid = cfg.image_size // cfg.patch_size
    return {
        "patch_embed": {"kernel": init.normal(cfg.patch_size ** 2 * 3, d)},
        "class_embedding": init.zeros(d),
        "position_embedding": init.normal(grid * grid + 1, d),
        "pre_layrnorm": init.layer_norm(dim=d),
        "layers": encoder_layers_init(init, cfg.num_layers, d,
                                      cfg.intermediate_size),
        "post_layernorm": init.layer_norm(dim=d),
        "visual_projection": init.dense(in_dim=d, out_dim=cfg.projection_dim,
                                        bias=False),
    }


def init(cfg: CLIPVisionConfig, init: L.Init, n_concepts: int = 17,
         n_special: int = 3) -> dict:
    """The tower, its projection and the concept embeddings (N(0, 1)
    clipped at ±2) with their thresholds (0.2)."""
    p = cfg.projection_dim
    return {
        **tower_init(cfg, init),
        "concept_embeds": init.normal(n_concepts, p, std=1.0),
        "special_care_embeds": init.normal(n_special, p, std=1.0),
        "concept_embeds_weights": init.ones(n_concepts).mul_(0.2),
        "special_care_embeds_weights": init.ones(n_special).mul_(0.2),
    }


def encoder_layer(p: dict, x, num_heads: int, eps: float,
                  causal: bool = False):
    """One pre-LN CLIP encoder layer: x + attn(LN1 x), then x + MLP(LN2 x)
    with quick-GELU; attention routed by `attention_route`."""
    b, s, d = x.shape
    hd = d // num_heads
    y = L.layer_norm(p["ln1"], x, eps)
    q, k, v = (L.dense(p["attn"][n], y).reshape(b, s, num_heads, hd)
               for n in ("q", "k", "v"))
    o = dot_product_attention(q, k, v, scale=hd ** -0.5, causal=causal)
    x = x + L.dense(p["attn"]["out"], o.reshape(b, s, d))
    y = L.layer_norm(p["ln2"], x, eps)
    return x + L.dense(p["mlp"]["fc2"],
                       _quick_gelu(L.dense(p["mlp"]["fc1"], y)))


def clip_image_embeds(params: dict, cfg: CLIPVisionConfig, images):
    """Normalized CLIP pixels [B, S, S, 3] → projected embeds [B, P], in
    the pixels' dtype. The patch embedding carries a zero bias, as the JAX
    tower's does (so a bf16 one takes kernel H)."""
    eps = cfg.layer_norm_eps
    x = L.patch_embed({"kernel": params["patch_embed"]["kernel"],
                       "bias": images.new_zeros(cfg.hidden_size)},
                      images, cfg.patch_size)
    b = x.shape[0]
    cls = params["class_embedding"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + params["position_embedding"][None].to(x.dtype)
    x = L.layer_norm(params["pre_layrnorm"], x, eps)
    for i in range(cfg.num_layers):
        x = encoder_layer(layer(params["layers"], i), x, cfg.num_heads, eps)
    pooled = L.layer_norm(params["post_layernorm"], x[:, 0], eps)
    return L.dense(params["visual_projection"], pooled)


def clip_preprocess(images, size: int, device) -> torch.Tensor:
    """[B, H, W, 3] images in [0, 1] (numpy or tensor) → CLIP-normalized
    fp32 [B, size, size, 3] on `device`: bicubic shortest-side resize
    (`preprocess.resize_bicubic`, as `jax.image.resize`), center crop,
    OpenAI normalisation."""
    x = torch.as_tensor(images, dtype=torch.float32, device=device)
    _, h, w, _ = x.shape
    short = min(h, w)
    nh, nw = int(round(h * size / short)), int(round(w * size / short))
    x = preprocess.resize_bicubic(x, nh, nw)
    top, left = (nh - size) // 2, (nw - size) // 2
    return preprocess.normalize(x[:, top:top + size, left:left + size])


def _cosine(a, b):
    """Cosine similarities [A, B] of two embedding sets, in a's dtype."""
    b = b.to(a.dtype)
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return a @ b.T


class SafetyChecker:
    """The pipelines' `safety_checker(images)` hook: numpy images in [0, 1]
    [B, H, W, 3] → (a copy with flagged images set to 0, [bool] * B). It
    runs on its params' device."""

    def __init__(self, params: dict, cfg: CLIPVisionConfig =
                 CLIPVisionConfig()):
        self.params, self.cfg = params, cfg
        self.device = params["visual_projection"]["kernel"].device

    def clip_preprocess(self, images) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] → CLIP-normalized [B, 224, 224, 3] fp32
        on the checker's device (`clip_preprocess` at its image size)."""
        return clip_preprocess(images, self.cfg.image_size, self.device)

    @torch.inference_mode()
    def flags(self, images: np.ndarray) -> torch.Tensor:
        """[B] bool on the device: any concept score above its threshold."""
        p = self.params
        clip_in = self.clip_preprocess(images)
        embeds = clip_image_embeds(p, self.cfg, clip_in)
        special = (_cosine(embeds, p["special_care_embeds"])
                   - p["special_care_embeds_weights"][None].to(embeds.dtype))
        adjustment = torch.where((special > 0).any(dim=1), 0.01, 0.0)[:, None]
        concept = (_cosine(embeds, p["concept_embeds"])
                   - p["concept_embeds_weights"][None].to(embeds.dtype)
                   + adjustment)
        return (concept > 0).any(dim=1)

    def __call__(self, images: np.ndarray) -> Tuple[np.ndarray, list]:
        has_nsfw = self.flags(images).cpu().numpy()
        out = np.array(images)
        out[has_nsfw] = 0.0
        return out, has_nsfw.tolist()


def clip_layer(b: _SD) -> dict:
    """One HF CLIP encoder layer (`layer_norm1/2`, `self_attn.*_proj`,
    `mlp.fc1/2`) in the port's layout."""
    return {
        "ln1": b.ln("layer_norm1"), "ln2": b.ln("layer_norm2"),
        "attn": {"q": b.linear("self_attn.q_proj"),
                 "k": b.linear("self_attn.k_proj"),
                 "v": b.linear("self_attn.v_proj"),
                 "out": b.linear("self_attn.out_proj")},
        "mlp": {"fc1": b.linear("mlp.fc1"), "fc2": b.linear("mlp.fc2")},
    }


def convert_tower(vm: _SD, cfg: CLIPVisionConfig) -> dict:
    """An HF `CLIPVisionTransformer` under `vm`'s prefix → the tower
    (without its projection); the patch conv becomes the patchify matmul's
    [(p p 3), width] kernel."""
    p_sz = cfg.patch_size
    return {
        "patch_embed": {"kernel": vm.leaf(
            "embeddings.patch_embedding.weight", 2, 3, 1, 0
        ).reshape(p_sz * p_sz * 3, -1)},
        "class_embedding": vm.raw("embeddings.class_embedding"),
        "position_embedding": vm.raw("embeddings.position_embedding.weight"),
        "pre_layrnorm": vm.ln("pre_layrnorm"),
        "layers": vm.sub("encoder").stack(cfg.num_layers, clip_layer,
                                          "layers.{}"),
        "post_layernorm": vm.ln("post_layernorm"),
    }


def convert_safety_checker(sd: dict, cfg: CLIPVisionConfig =
                           CLIPVisionConfig(), dtype=torch.float32,
                           device="cuda") -> dict:
    """HF StableDiffusionSafetyChecker state dict (torch tensors or numpy
    arrays) → the port's params, landing on `device` in `dtype`."""
    s = _SD({k: torch.as_tensor(v) for k, v in sd.items()}, dtype=dtype,
            device=device)
    return {
        **convert_tower(s.sub("vision_model.vision_model"), cfg),
        "visual_projection": s.linear("visual_projection", bias=False),
        "concept_embeds": s.raw("concept_embeds"),
        "special_care_embeds": s.raw("special_care_embeds"),
        "concept_embeds_weights": s.raw("concept_embeds_weights"),
        "special_care_embeds_weights": s.raw("special_care_embeds_weights"),
    }
