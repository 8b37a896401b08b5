"""EmuGenerationPipeline: Emu1 text- and image-conditioned image generation,
as `emu_tpu/pipelines/emu1_pipeline.py` (the reference's
Emu1/models/pipeline.py:20-262):

- interleaved `[str | Image]` inputs become one prompt with an
  `[IMG]<image>*32[/IMG]` run per image, then the regression trigger
  `[IMG]`;
- classifier-free guidance encodes [prompt, ""] as one left-padded batch
  (conditional first) and mixes uncond + g (cond - uncond);
- the 32 regressed 5120-d embeddings condition an SD1.5-class UNet
  (cross_attention_dim 5120) through 50 PLMS steps (51 UNet calls) at
  512²; SD1.5 VAE decode, optional safety checker, PIL out.

`from_config(device="cuda")` builds the full Emu1 (ViT-g, Causal Former,
LLaMA-13B) and the UNet and VAE on one card in bf16 with random weights
from a seed; `from_pretrained` loads the reference's directory
(`multimodal_encoder/`, `unet/`, `vae/`). On the card the regression runs
kernels A-D, the UNet batched_mha (its self-attention at every level, 4096
to 64 tokens) and kernel A (its cross-attention).

The safety checker is off by default (`safety_checker=None`, as the
reference's pipelines); pass `models.safety_checker.SafetyChecker(params)`
(`convert_safety_checker` of the HF checker's state dict) to flag and black
out images after the VAE decode (`nsfw_content_detected`).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from emu_tpu_torch import checkpoint as C
from emu_tpu_torch import tokenization as T
from emu_tpu_torch.config import (Emu1Config, SchedulerConfig, UNetConfig,
                                  VAEConfig)
from emu_tpu_torch.diffusion import PNDMScheduler, unet, vae
from emu_tpu_torch.utils.profiling import Stats, mark
from emu_tpu_torch.models import emu1
from emu_tpu_torch.ops.layers import Init
from emu_tpu_torch.ops.quant import quantize_model_params, quantize_unet_params
from emu_tpu_torch.pipelines import preprocess


def model_configs(tiny: bool):
    """(Emu1Config, UNetConfig, VAEConfig) of Emu1 generation, or the tiny
    test trio."""
    if tiny:
        cfg = Emu1Config.tiny()
        return (cfg, UNetConfig.tiny(cross_attention_dim=cfg.llama.hidden_size),
                VAEConfig.tiny())
    return Emu1Config(), UNetConfig.emu1_sd15(), VAEConfig.sd15()


class EmuGenerationPipeline:
    def __init__(self, emu_params: dict, emu_cfg: Emu1Config,
                 unet_params: dict, unet_cfg: UNetConfig,
                 vae_params: dict, vae_cfg: VAEConfig,
                 tokenizer: Optional[T.EmuTokenizer] = None,
                 scheduler_cfg: SchedulerConfig = SchedulerConfig(),
                 safety_checker: Optional[Callable] = None,
                 quantize: Optional[str] = None):
        if quantize:
            emu_params = quantize_model_params(emu_params, quantize)
        self.emu_params, self.emu_cfg = emu_params, emu_cfg
        self.unet_params, self.unet_cfg = unet_params, unet_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.scheduler_cfg = scheduler_cfg
        self.tokenizer = tokenizer or T.EmuTokenizer.emu1(
            instruct=emu_cfg.instruct)
        self.safety_checker = safety_checker
        self.image_placeholder = (T.IMG + T.IMAGE * emu_cfg.n_causal
                                  + T.IMG_END)
        self.vae_scale_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        kernel = emu_params["visual"]["patch_embed"]["kernel"]
        self.device, self._img_dtype = kernel.device, kernel.dtype
        self.last_stats: dict = {}

    def quantize_unet(self) -> "EmuGenerationPipeline":
        """W8A8 for the UNet's Transformer2D interior, in place (the SD1.5
        1x1 conv projections stay float). Opt-in."""
        self.unet_params = quantize_unet_params(self.unet_params)
        return self

    @classmethod
    def from_config(cls, seed: int = 0, dtype=None, tiny: bool = False,
                    device="cuda", **kwargs) -> "EmuGenerationPipeline":
        """Random weights drawn on `device` from `seed`, in bf16 on CUDA and
        fp32 on the CPU unless `dtype` says otherwise."""
        device = torch.device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
        init = Init(device=device, dtype=dtype,
                    generator=torch.Generator(device=device).manual_seed(seed))
        emu_cfg, unet_cfg, vae_cfg = model_configs(tiny)
        return cls(emu1.init(emu_cfg, init), emu_cfg,
                   unet.init(unet_cfg, init), unet_cfg,
                   vae.init(vae_cfg, init), vae_cfg, **kwargs)

    @classmethod
    def from_pretrained(cls, path: str, dtype=None, tiny: bool = False,
                        device="cuda", **kwargs) -> "EmuGenerationPipeline":
        """The reference's checkpoint directory: `multimodal_encoder/` (the
        Emu state dict: a `.bin`, a `.safetensors` or a sharded index; peft
        LoRA adapters are merged) beside diffusers-style `unet/` and `vae/`
        weight directories; `feature_extractor/` and `safety_checker/` are
        ignored. On `device`, in bf16 on CUDA and fp32 on the CPU unless
        `dtype` says otherwise."""
        device = torch.device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
        emu_cfg, unet_cfg, vae_cfg = model_configs(tiny)
        emu_params = C.load_emu1_checkpoint(
            os.path.join(path, "multimodal_encoder"), emu_cfg, dtype, device)
        unet_params = C.convert_unet(
            C.load_state_dict(os.path.join(path, "unet")), unet_cfg, dtype,
            device)
        vae_params = C.convert_vae(
            C.load_state_dict(os.path.join(path, "vae")), vae_cfg, dtype,
            device)
        return cls(emu_params, emu_cfg, unet_params, unet_cfg, vae_params,
                   vae_cfg, **kwargs)

    def _encode_inputs(self, inputs, do_cfg: bool) -> torch.Tensor:
        text, images = "", []
        for x in inputs:
            if isinstance(x, str):
                text += x
            else:
                text += T.IMG_PLACEHOLDER
                images.append(preprocess.preprocess_image(
                    x, self.emu_cfg.vision.image_size))
        prompts = [text, ""] if do_cfg else [text]
        image_embeds = None
        if images:
            batch = torch.from_numpy(np.stack(images)).to(self.device,
                                                          self._img_dtype)
            e = emu1.encode_image(self.emu_params, self.emu_cfg, batch)
            image_embeds = e.reshape(-1, e.shape[-1])
        prompts = [p.replace(T.IMG_PLACEHOLDER, self.image_placeholder)
                   + T.IMG for p in prompts]
        ids, mask = self.tokenizer.encode_batch(prompts, padding_side="left")
        return emu1.generate_image_embeds(
            self.emu_params, self.emu_cfg,
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device), image_embeds,
            self.tokenizer.image_token_id)

    @torch.inference_mode()
    def __call__(self, inputs: List, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 generator: Optional[torch.Generator] = None,
                 cache_interval: int = 1,
                 callback: Optional[Callable] = None):
        """→ (PIL image, nsfw flag or None). generator draws the initial
        latents (seed 0 on the pipeline's device when None);
        callback(i, latents) runs after every PLMS step; timings (the
        card's, from CUDA events) land in last_stats."""
        do_cfg = guidance_scale > 1.0
        m0 = mark(self.device)
        prompt_embeds = self._encode_inputs(inputs, do_cfg)   # [2|1, 32, d]
        latents = draw_latents(
            generator, (1, height // self.vae_scale_factor,
                        width // self.vae_scale_factor,
                        self.unet_cfg.in_channels),
            self.device, prompt_embeds.dtype)
        stats = Stats()
        stats.interval("condition_s", m0, mark(self.device))
        image = _denoise_pndm(
            self.unet_params, self.unet_cfg, self.vae_params, self.vae_cfg,
            self.scheduler_cfg, num_inference_steps, latents, prompt_embeds,
            guidance_scale, do_cfg, cache_interval, callback, stats)
        self.last_stats = stats
        image = image.cpu().numpy()
        stats.settle()
        nsfw = None
        if self.safety_checker is not None:
            image, nsfw = self.safety_checker(image)
        return to_pil(image)[0], nsfw


def draw_latents(generator: Optional[torch.Generator], shape, device, dtype):
    """N(0, 1) latents from `generator` (seed 0 on `device` when None), in
    `dtype` on `device`. jax.random's stream cannot be reproduced, so the
    parity tests hand both packages the same latents instead."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=generator,
                       device=generator.device).to(device, dtype)


def cfg_mix(eps: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """uncond + g (cond - uncond), the conditional branch first: the
    difference in the model's dtype, the mix in fp32, as the JAX package's
    fp32 guidance scalar promotes it."""
    cond, uncond = eps.chunk(2, dim=0)
    return uncond.float() + guidance_scale * (cond - uncond).float()


def decode_latents(vae_params, vae_cfg: VAEConfig, latents, t0: tuple,
                   stats: Optional[dict]):
    """The VAE decode of final latents → images [B, H, W, 3] fp32 in
    [0, 1]; stats (a `profiling.Stats`) gets denoise_s (since the mark t0,
    `profiling.mark`) and decode_s, the card's times where it is one."""
    t1 = mark(latents.device)
    img = vae.decode(vae_params, vae_cfg, latents / torch.tensor(
        vae_cfg.scaling_factor, dtype=latents.dtype))
    img = (img.float() / 2 + 0.5).clamp(0.0, 1.0)
    if stats is not None:
        Stats.interval(stats, "denoise_s", t0, t1)
        Stats.interval(stats, "decode_s", t1, mark(latents.device))
    return img


def _denoise_pndm(unet_params, unet_cfg, vae_params, vae_cfg, sched_cfg,
                  steps: int, latents, prompt_embeds, guidance_scale: float,
                  do_cfg: bool, cache_interval: int = 1, callback=None,
                  stats: Optional[dict] = None):
    """The PLMS denoise loop (steps + 1 UNet calls) and the VAE decode →
    images [B, H, W, 3] fp32 in [0, 1]; cache_interval as
    `visual_generation._denoise_euler`."""
    t0 = mark(latents.device)
    sched = PNDMScheduler(sched_cfg, num_inference_steps=steps)
    state = sched.init_state()
    n_branches = prompt_embeds.shape[0] if do_cfg else 1
    cache = None
    for i in range(sched.num_steps):
        inp = torch.cat([latents] * n_branches, 0) if do_cfg else latents
        t = sched.timesteps[i].float().to(inp.device).expand(inp.shape[0])
        full = i % cache_interval == 0
        eps = unet.forward(unet_params, unet_cfg, inp, t, prompt_embeds,
                           deep_cache=None if full else cache,
                           return_cache=cache_interval > 1)
        if cache_interval > 1:
            eps, new_cache = eps
            cache = new_cache if full else cache
        if do_cfg:
            eps = cfg_mix(eps, guidance_scale)
        latents, state = sched.step(eps, i, latents, state)
        if callback is not None:
            callback(i, latents)
    return decode_latents(vae_params, vae_cfg, latents, t0, stats)


def to_pil(images: np.ndarray):
    """[B, H, W, 3] floats in [0, 1] → PIL images."""
    from PIL import Image
    images = (images * 255).round().astype("uint8")
    return [Image.fromarray(im) for im in images]
