"""EmuVisualGeneration: Emu2-Gen image generation and autoencoding, as
`emu_tpu/pipelines/visual_generation.py` (the reference's
Emu2/emu/diffusion.py:31-318):

- autoencoding mode (one image, no text): `emu2.encode_image` is the UNet
  condition directly; the CFG negative is the zero image's, cached;
- generation mode: `emu2.generate_image_embeds` regresses n_query
  1792-d embeddings; the CFG negative is the empty prompt's, cached;
- SDXL added conditions: time_ids = original size + crop + target size,
  text_embeds = mean(prompt_embeds over the tokens);
- EulerDiscrete, 50 steps at 1024², CFG 3.0, latents × init_noise_sigma,
  the SDXL VAE (scaling 0.13025), PIL out.

`from_config(device="cuda", quantize="int4")` builds the full Emu2-Gen on
one card with random weights from a seed: the decoder int4 and the tower
W8A8, drawn and quantized one layer at a time, the SDXL UNet and VAE in
bf16. `from_pretrained` loads the reference's pipeline state dict (one
blob, keys under `multimodal_encoder.` / `unet.` / `vae.`), quantizing the
decoder and the tower one layer at a time as they land. On the card the regression runs kernels A, C, D, F and G, the UNet
batched_mha (its self-attention at the 4096- and 1024-token levels) and
kernel A (its cross-attention).

The safety checker is off by default (`safety_checker=None`, as the
reference's pipelines); pass `models.safety_checker.SafetyChecker(params)`
(`convert_safety_checker` of the HF checker's state dict) to flag and black
out images after the VAE decode (`nsfw_content_detected`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from emu_tpu_torch import checkpoint as C
from emu_tpu_torch import tokenization as T
from emu_tpu_torch.config import (Emu2Config, SchedulerConfig, UNetConfig,
                                  VAEConfig)
from emu_tpu_torch.diffusion import EulerDiscreteScheduler, unet, vae
from emu_tpu_torch.utils.profiling import Stats, mark
from emu_tpu_torch.models import emu2, llama
from emu_tpu_torch.ops.layers import Init
from emu_tpu_torch.ops.quant import quantize_model_params, quantize_unet_params
from emu_tpu_torch.pipelines import preprocess
from emu_tpu_torch.pipelines.emu1_pipeline import (cfg_mix, decode_latents,
                                                   draw_latents, to_pil)


@dataclass
class VisualGenerationOutput:
    image: object
    nsfw_content_detected: Optional[bool] = None


def model_configs(tiny: bool):
    """(Emu2Config, UNetConfig, VAEConfig) of Emu2-Gen, or the tiny test
    trio."""
    if tiny:
        cfg = Emu2Config.tiny()
        return (cfg, UNetConfig.tiny(cross_attention_dim=cfg.vision.width,
                                     sdxl=True), VAEConfig.tiny())
    return Emu2Config(), UNetConfig.emu2_sdxl(), VAEConfig()


class EmuVisualGeneration:
    def __init__(self, emu_params: dict, emu_cfg: Emu2Config,
                 unet_params: dict, unet_cfg: UNetConfig,
                 vae_params: dict, vae_cfg: VAEConfig,
                 tokenizer: Optional[T.EmuTokenizer] = None,
                 scheduler_cfg: SchedulerConfig = SchedulerConfig(),
                 safety_checker: Optional[Callable] = None,
                 quantize: Optional[str] = None):
        """Params: the JAX package's trees as torch tensors. quantize: None
        | "int8" | "int4", the serving recipe (decoder weight-only on the
        fused qkv/gate_up layout, tower W8A8; already-quantized leaves
        pass)."""
        if quantize:
            dec = emu_params["decoder"]
            if "q_proj" in dec["layers"]["self_attn"]:
                dec = llama.fuse_projections(dec)
            emu_params = quantize_model_params(dict(emu_params, decoder=dec),
                                               quantize)
        self.emu_params, self.emu_cfg = emu_params, emu_cfg
        self.unet_params, self.unet_cfg = unet_params, unet_cfg
        self.vae_params, self.vae_cfg = vae_params, vae_cfg
        self.scheduler_cfg = scheduler_cfg
        self.tokenizer = tokenizer or T.EmuTokenizer.emu2(
            instruct=emu_cfg.instruct)
        self.safety_checker = safety_checker
        self.image_placeholder = T.IMG + T.IMAGE * emu_cfg.n_query + T.IMG_END
        self.vae_scale_factor = 2 ** (len(vae_cfg.block_out_channels) - 1)
        self.negative_prompt = {}          # CFG negative cache
        kernel = emu_params["visual"]["patch_embed"]["kernel"]
        self.device, self._img_dtype = kernel.device, kernel.dtype
        self.last_stats: dict = {}

    def quantize_unet(self) -> "EmuVisualGeneration":
        """W8A8 for the UNet's Transformer2D interior, in place
        (`quantize_unet_params`). Opt-in; composes with cache_interval."""
        self.unet_params = quantize_unet_params(self.unet_params)
        return self

    @classmethod
    def from_config(cls, seed: int = 0, dtype=None, tiny: bool = False,
                    device="cuda", quantize: Optional[str] = None,
                    **kwargs) -> "EmuVisualGeneration":
        """Random weights drawn on `device` from `seed`, in bf16 on CUDA and
        fp32 on the CPU unless `dtype` says otherwise; quantize="int4" (or
        "int8") draws the decoder already quantized, one layer at a time,
        so its bf16 copy never exists whole."""
        device = torch.device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
        init = Init(device=device, dtype=dtype,
                    generator=torch.Generator(device=device).manual_seed(seed))
        emu_cfg, unet_cfg, vae_cfg = model_configs(tiny)
        return cls(emu2.init(emu_cfg, init, quantize=quantize), emu_cfg,
                   unet.init(unet_cfg, init), unet_cfg,
                   vae.init(vae_cfg, init), vae_cfg, quantize=quantize,
                   **kwargs)

    @classmethod
    def from_pretrained(cls, model_path: str, dtype=None, tiny: bool = False,
                        device="cuda", quantize: Optional[str] = None,
                        **kwargs) -> "EmuVisualGeneration":
        """The whole Emu2-Gen pipeline from one state dict (a
        `.safetensors`/`.bin` blob or a sharded directory) whose keys carry
        the `multimodal_encoder.` / `unet.` / `vae.` prefixes of the
        reference pipeline; `safety_checker.*` entries are ignored (the
        pipelines default to safety_checker=None). On `device`, in bf16 on
        CUDA and fp32 on the CPU unless `dtype` says otherwise."""
        sd = C.load_state_dict(model_path)
        split = {"multimodal_encoder": {}, "unet": {}, "vae": {}}
        for k, v in sd.items():
            head, _, rest = k.partition(".")
            if head in split:
                split[head][rest] = v
        missing = [k for k, v in split.items() if not v]
        if missing:
            raise ValueError(f"{model_path}: no {missing} weights found "
                             "(keys must be prefixed like the reference "
                             "pipeline state dict)")
        device = torch.device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
        emu_cfg, unet_cfg, vae_cfg = model_configs(tiny)
        return cls(
            C.convert_emu2(split["multimodal_encoder"], emu_cfg, dtype,
                           device, quantize), emu_cfg,
            C.convert_unet(split["unet"], unet_cfg, dtype, device), unet_cfg,
            C.convert_vae(split["vae"], vae_cfg, dtype, device), vae_cfg,
            quantize=quantize, **kwargs)

    # -- conditioning --------------------------------------------------------

    def _image_batch(self, arrs):
        return torch.from_numpy(np.stack(arrs)).to(self.device,
                                                   self._img_dtype)

    def _encode_inputs(self, inputs, do_cfg: bool) -> torch.Tensor:
        size = self.emu_cfg.vision.image_size
        has_image = has_text = False
        text, images = "", []
        for x in inputs:
            if isinstance(x, str):
                has_text = True
                text += x
            else:
                has_image = True
                text += T.IMG_PLACEHOLDER
                images.append(preprocess.preprocess_image(x, size))

        if has_image and not has_text:          # autoencoding mode
            if len(images) != 1:
                raise ValueError("autoencoding mode takes exactly one image "
                                 f"(got {len(images)}); add text for "
                                 "generation mode")
            batch = self._image_batch(images)
            prompt = emu2.encode_image(self.emu_params, self.emu_cfg, batch)
            if do_cfg:
                key = "[NULL_IMAGE]"
                if key not in self.negative_prompt:
                    self.negative_prompt[key] = emu2.encode_image(
                        self.emu_params, self.emu_cfg, torch.zeros_like(batch))
                prompt = torch.cat([prompt, self.negative_prompt[key]], 0)
            return prompt

        image_embeds = None
        if images:
            e = emu2.encode_image_lm(self.emu_params, self.emu_cfg,
                                     self._image_batch(images))
            image_embeds = e.reshape(-1, e.shape[-1])
        prompt = self._regress(text, image_embeds)
        if do_cfg:
            if "" not in self.negative_prompt:
                self.negative_prompt[""] = self._regress("", None)
            prompt = torch.cat([prompt, self.negative_prompt[""]], 0)
        return prompt

    def _regress(self, text: str, image_embeds) -> torch.Tensor:
        text = text.replace(T.IMG_PLACEHOLDER, self.image_placeholder) + T.IMG
        ids, mask = self.tokenizer.encode_batch([text], padding_side="left")
        return emu2.generate_image_embeds(
            self.emu_params, self.emu_cfg,
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device), image_embeds,
            self.tokenizer.image_token_id)

    # -- generation ----------------------------------------------------------

    @torch.inference_mode()
    def __call__(self, inputs, height: int = 1024, width: int = 1024,
                 num_inference_steps: int = 50, guidance_scale: float = 3.0,
                 crop_info: List[int] = (0, 0),
                 original_size: List[int] = (1024, 1024),
                 generator: Optional[torch.Generator] = None,
                 cache_interval: int = 1,
                 callback: Optional[Callable] = None
                 ) -> VisualGenerationOutput:
        """inputs: a prompt string, an image, or a list of both. generator:
        draws the initial latents (seed 0 on the pipeline's device when
        None). callback(i, latents) runs after every denoise step. Timings
        (condition_s, denoise_s, decode_s; the card's, from CUDA events)
        land in last_stats."""
        if not isinstance(inputs, list):
            inputs = [inputs]
        do_cfg = guidance_scale > 1.0
        m0 = mark(self.device)
        prompt_embeds = self._encode_inputs(inputs, do_cfg)
        time_ids = torch.tensor(
            list(original_size) + list(crop_info) + [height, width],
            dtype=torch.float32, device=self.device)
        time_ids = time_ids[None].expand(prompt_embeds.shape[0], -1)
        latents = draw_latents(
            generator, (1, height // self.vae_scale_factor,
                        width // self.vae_scale_factor,
                        self.unet_cfg.in_channels),
            self.device, prompt_embeds.dtype)
        stats = Stats()
        stats.interval("condition_s", m0, mark(self.device))
        image = _denoise_euler(
            self.unet_params, self.unet_cfg, self.vae_params, self.vae_cfg,
            self.scheduler_cfg, num_inference_steps, latents, prompt_embeds,
            time_ids, guidance_scale, do_cfg, cache_interval, callback, stats)
        self.last_stats = stats
        image = image.cpu().numpy()
        stats.settle()
        nsfw = None
        if self.safety_checker is not None:
            image, nsfw = self.safety_checker(image)
        return VisualGenerationOutput(image=to_pil(image)[0],
                                      nsfw_content_detected=nsfw)


def _denoise_euler(unet_params, unet_cfg, vae_params, vae_cfg, sched_cfg,
                   steps: int, latents, prompt_embeds, time_ids,
                   guidance_scale: float, do_cfg: bool,
                   cache_interval: int = 1, callback=None,
                   stats: Optional[dict] = None):
    """The Euler denoise loop and the VAE decode → images [B, H, W, 3]
    fp32 in [0, 1]. cache_interval > 1 runs one full UNet pass per group of
    `cache_interval` steps and reuses its deep feature for the rest (the
    UNet's `deep_cache`: an approximation that trades a little fidelity for
    most of the transformer-heavy interior)."""
    t0 = mark(latents.device)
    sched = EulerDiscreteScheduler(sched_cfg, num_inference_steps=steps)
    latents = latents * torch.tensor(sched.init_noise_sigma,
                                     dtype=latents.dtype)
    text_embeds = prompt_embeds.mean(1)
    cache = None
    for i in range(sched.num_inference_steps):
        inp = torch.cat([latents] * 2, 0) if do_cfg else latents
        inp = sched.scale_model_input(inp, i)
        t = sched.timesteps[i].to(inp.device).expand(inp.shape[0])
        full = i % cache_interval == 0
        eps = unet.forward(unet_params, unet_cfg, inp, t, prompt_embeds,
                           added_text_embeds=text_embeds,
                           added_time_ids=time_ids,
                           deep_cache=None if full else cache,
                           return_cache=cache_interval > 1)
        if cache_interval > 1:
            eps, new_cache = eps
            cache = new_cache if full else cache
        if do_cfg:
            eps = cfg_mix(eps, guidance_scale)
        latents = sched.step(eps, i, latents)
        if callback is not None:
            callback(i, latents)
    return decode_latents(vae_params, vae_cfg, latents, t0, stats)
