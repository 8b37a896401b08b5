"""EmuChatGeneration: the Emu2 multimodal chat API, as
`emu_tpu/pipelines/chat.py`: plain (`List[str | Image]`) and chat
(`List[List[str | Image]]`) inputs, USER/ASSISTANT role alternation with
`</s>` between turns, the system message, the grounding suffix,
`[VIDEO]`/`[/VIDEO]` spans whose frames become `[gIMG]` placeholders,
bicubic-448 host preprocessing, and the reference's generation defaults
(beam 5, length_penalty -1, prompts padded to a multiple of 64).

`quantize="int8" | "int4"` is the serving recipe (decoder weight-only,
vision tower W8A8; `ops.quant.quantize_model_params`). With int4 on a
CUDA card the decoder runs kernels F and G and the tower kernel E at two
or more images. `from_config(device="cuda", quantize="int4")` builds the
full Emu2-Chat with random weights on one card, quantized one layer at a
time; `from_pretrained(path, quantize="int4")` loads a checkpoint the same
way (`checkpoint.load_emu2_checkpoint`), each layer quantized as it lands.

Decoding: beam search (the default), greedy, sampling (`do_sample` with
`temperature`/`top_k`/`top_p`; beam sampling with `num_beams` > 1) from
an explicit `generator`, and contrastive search (`penalty_alpha`, which
sets one beam).

`embed_inputs` is the admission unit of the continuous engine
(`generation.continuous`, served by `serving.continuous_helper`).

`preprocess_mode="device"` ships each image to the card as raw uint8
and resizes and normalises it there (`preprocess.device_preprocess`, one
call per distinct image shape); "host" (the default) is PIL's bicubic,
the reference's transform bit for bit.

`mesh=` (a `parallel.make_mesh` over a process group, one process per
rank) shards the tree by `emu2.sharding_rules` after fusion and
quantization, as the JAX pipeline does: the tower and the decoder run
tensor-parallel over "model" (see `models.llama`, `models.vit`), and every
rank decodes the same tokens. `multito(devices)` / `multicuda` is the
reference's device-list API (`Emu2/emu/chat.py:235-283`) over that mesh:
one process per listed card, started by the caller (`torchrun
--nproc_per_node N`), rank r holding its shard on `devices[r]`. One torch
process cannot run one tensor-parallel program over several cards the way
one JAX program does, and the reference's own alternative, whole layers
placed on the listed cards in one process with the activations moved
between them, runs one card at a time; so the port keeps the JAX
package's meaning. With one device, `multito([device])` only moves the
model there.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from emu_tpu_torch import tokenization as T
from emu_tpu_torch.checkpoint import load_emu2_checkpoint
from emu_tpu_torch.config import Emu2Config
from emu_tpu_torch.generation.engine import GenerationConfig
from emu_tpu_torch.models import emu2, llama
from emu_tpu_torch.ops.layers import Init
from emu_tpu_torch.ops.quant import quantize_model_params
from emu_tpu_torch.parallel import mesh as M
from emu_tpu_torch.pipelines import preprocess
from emu_tpu_torch.utils.profiling import RECORDER, Stats, mark


def with_depth(cfg: Emu2Config, depth: int) -> Emu2Config:
    """The same widths with the tower and the decoder cut to `depth`."""
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=depth),
        llama=dataclasses.replace(cfg.llama, num_hidden_layers=depth))


class EmuChatGeneration:
    def __init__(self, params: dict, cfg: Emu2Config,
                 tokenizer: Optional[T.EmuTokenizer] = None,
                 fuse: bool = True, quantize: Optional[str] = None,
                 preprocess_mode: str = "host", mesh=None):
        """params: the JAX package's Emu2 tree as torch tensors. fuse=True
        rewrites the decoder to the fused qkv_proj/gate_up layout (exact);
        quantize: None | "int8" | "int4" (already-quantized leaves pass);
        preprocess_mode: "host" (PIL) or "device" (raw bytes to the
        device); mesh: shard the tree over it (this rank's slice stays on
        the device the tree is on)."""
        if preprocess_mode not in ("host", "device"):
            raise ValueError(f"preprocess_mode {preprocess_mode!r}")
        self.preprocess_mode = preprocess_mode
        if fuse and "q_proj" in params["decoder"]["layers"]["self_attn"]:
            params = dict(params,
                          decoder=llama.fuse_projections(params["decoder"]))
        if quantize:
            params = quantize_model_params(params, quantize)
        if mesh is not None:
            params = M.shard_params(params, mesh, emu2.sharding_rules,
                                    emu2.tensor_layout(cfg))
        self.cfg = cfg
        self.model = emu2.Emu2(cfg, params)
        self.tokenizer = tokenizer or T.EmuTokenizer.emu2(
            instruct=cfg.instruct)
        self.image_placeholder = T.IMG + T.IMAGE * cfg.n_query + T.IMG_END
        self.video_placeholder = T.IMG + T.GIMG * cfg.v_query + T.IMG_END
        # the tower computes in its images' dtype: feed it patch_embed's
        # (never quantized)
        kernel = params["visual"]["patch_embed"]["kernel"]
        self.device, self._img_dtype = kernel.device, kernel.dtype
        self.last_stats: dict = Stats()
        RECORDER.anchor(self.device)

    def multito(self, devices) -> "EmuChatGeneration":
        """The reference's device-list API over a tensor-parallel mesh (see
        the module docstring): with N devices, N processes of an
        initialised process group each call it with the same list; rank r
        keeps its "model" slice of the tree on `devices[r]`. Devices may be
        given as indices (`multicuda([0, 1])`). With one device the model
        moves there."""
        devices = [torch.device(f"cuda:{d}" if isinstance(d, int) else d)
                   for d in devices]
        params = self.params
        if len(devices) == 1:
            self.model.to(devices[0])
            self.device = devices[0]
            RECORDER.anchor(self.device)
            return self
        if any(M.TP_KEY in v for v in params.values()
               if isinstance(v, dict)):
            raise ValueError("multito: the tree is sharded already")
        world = (M.dist.get_world_size() if M.dist.is_initialized() else 1)
        if world != len(devices):
            raise ValueError(
                f"multito over {len(devices)} devices needs a process group "
                f"of {len(devices)} ranks (one process per device, e.g. "
                f"torchrun --nproc_per_node {len(devices)}); this one has "
                f"{world}")
        mesh = M.make_mesh((1, len(devices)))
        self.device = devices[M.dist.get_rank()]
        self.model = emu2.Emu2(self.cfg, M.shard_params(
            params, mesh, emu2.sharding_rules, emu2.tensor_layout(self.cfg),
            device=self.device))
        RECORDER.anchor(self.device)
        return self

    multicuda = multito

    @classmethod
    def from_config(cls, instruct: bool = False, seed: int = 0, dtype=None,
                    device="cuda", depth: Optional[int] = None,
                    quantize: Optional[str] = None,
                    **kwargs) -> "EmuChatGeneration":
        """Random weights drawn on `device` from `seed` (n_query 256 for
        instruct, 64 for base), in bf16 on CUDA and fp32 on the CPU unless
        `dtype` says otherwise; depth cuts the tower and the decoder."""
        cfg = Emu2Config.chat() if instruct else Emu2Config()
        if depth is not None:
            cfg = with_depth(cfg, depth)
        device = torch.device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
        gen = torch.Generator(device=device).manual_seed(seed)
        tree = emu2.init(cfg, Init(device=device, dtype=dtype, generator=gen),
                         quantize=quantize)
        return cls(tree, cfg, quantize=quantize, **kwargs)

    @classmethod
    def from_pretrained(cls, path: str, instruct: bool = False, dtype=None,
                        quantize: Optional[str] = None, device="cuda",
                        depth: Optional[int] = None,
                        **kwargs) -> "EmuChatGeneration":
        """An Emu2 checkpoint (a `.bin`/`.safetensors` file or an HF sharded
        directory) on `device`, in bf16 on CUDA and fp32 on the CPU unless
        `dtype` says otherwise; quantize fuses and quantizes each layer as
        it lands; depth loads the first `depth` layers of the tower and the
        decoder (a cut for tests)."""
        cfg = Emu2Config.chat() if instruct else Emu2Config()
        if depth is not None:
            cfg = with_depth(cfg, depth)
        device = torch.device(device)
        dtype = dtype or (torch.bfloat16 if device.type == "cuda"
                          else torch.float32)
        params = load_emu2_checkpoint(path, cfg, dtype, device, quantize)
        return cls(params, cfg, quantize=quantize, **kwargs)

    @property
    def params(self) -> dict:
        return self.model.tree()

    # -- input assembly ------------------------------------------------------

    def _preprocess(self, image):
        if self.preprocess_mode == "device":
            return preprocess.to_uint8_rgb(image)
        return preprocess.preprocess_image(image, self.cfg.vision.image_size)

    def _prepare_inputs(self, inputs):
        is_video = False
        text, images, videos = "", [], []
        for x in inputs:
            if x == T.FAKE_VIDEO_END:
                is_video = False
            elif isinstance(x, str):
                if x == T.VIDEO:
                    is_video = True
                text += x
            elif is_video:
                text += T.VID_PLACEHOLDER
                videos.append(self._preprocess(x))
            else:
                text += T.IMG_PLACEHOLDER
                images.append(self._preprocess(x))
        return text, images, videos

    def _prepare_chat_inputs(self, inputs, is_grounding: bool):
        text = (T.GROUND_SYSTEM_MESSAGE if is_grounding
                else T.SYSTEM_MESSAGE)
        images, videos = [], []
        prev = None
        for msg in inputs:
            if prev == T.ASSISTANT:
                text += f"{T.EOS}{T.USER}: "
                prev = T.USER
            elif prev is None:
                text += f" {T.USER}: "
                prev = T.USER
            else:
                text += f" {T.ASSISTANT}: "
                prev = T.ASSISTANT
            t, im, vid = self._prepare_inputs(msg)
            text += t
            images += im
            videos += vid
        text += f" {T.ASSISTANT}:"
        if is_grounding:
            text += T.GRD
        return text, images, videos

    def _assemble_batch(self, batch_inputs: List[List], is_grounding: bool):
        """Conversations → (prompt texts, image arrays, video arrays)."""
        texts, images, videos = [], [], []
        for inputs in batch_inputs:
            if not isinstance(inputs, list):
                raise TypeError("each conversation is a list")
            if inputs and isinstance(inputs[0], list):
                if len(inputs) % 2 != 1:
                    raise ValueError("last message must be user input")
                text, im, vid = self._prepare_chat_inputs(inputs,
                                                          is_grounding)
            else:
                text, im, vid = self._prepare_inputs(inputs)
            text = text.replace(T.IMG_PLACEHOLDER, self.image_placeholder)
            text = text.replace(T.VID_PLACEHOLDER, self.video_placeholder)
            texts.append(text)
            images += im
            videos += vid
        return texts, images, videos

    def _image_batch(self, arrs):
        """Preprocessed arrays → the tower's batch in its compute dtype. In
        device mode the raw uint8 images go to the device grouped by shape
        (resolutions may differ) and are resized and normalised there."""
        if self.preprocess_mode != "device":
            return torch.from_numpy(np.stack(arrs)).to(self.device,
                                                       self._img_dtype)
        size = self.cfg.vision.image_size
        groups: dict = {}
        for i, a in enumerate(arrs):
            groups.setdefault(a.shape, []).append(i)
        out = [None] * len(arrs)
        for idx in groups.values():
            raw = torch.from_numpy(np.stack([arrs[i] for i in idx]))
            x = preprocess.device_preprocess(raw.to(self.device), size)
            for j, i in enumerate(idx):
                out[i] = x[j]
        return torch.stack(out).to(self._img_dtype)

    def _encode_visuals(self, images, videos):
        image_embeds = video_embeds = None
        if images:
            e = self.model.encode_image_lm(self._image_batch(images),
                                           self.cfg.n_query)
            image_embeds = e.reshape(-1, e.shape[-1])
        if videos:
            e = self.model.encode_image_lm(self._image_batch(videos),
                                           self.cfg.v_query)
            video_embeds = e.reshape(-1, e.shape[-1])
        return image_embeds, video_embeds

    @torch.no_grad()
    def embed_inputs(self, inputs: List, is_grounding: bool = False):
        """One conversation → (inputs_embeds [1, S, D], mask [1, S], token
        ids [1, S] numpy): the prompt in decoder-embedding space with the
        visual embeds scattered in. The admission unit of the continuous
        engine; the ids also feed the text-only speculative path."""
        texts, images, videos = self._assemble_batch([inputs], is_grounding)
        ids, mask = self.tokenizer.encode_batch(texts)
        image_embeds, video_embeds = self._encode_visuals(images, videos)
        params = self.params
        ids_t = torch.from_numpy(ids).to(self.device)
        embeds = emu2.scatter_embeds(params, ids_t, image_embeds,
                                     self.tokenizer.image_token_id)
        if video_embeds is not None:
            embeds = emu2.scatter_embeds(params, ids_t, video_embeds,
                                         self.tokenizer.gimg_token_id,
                                         base_embeds=embeds)
        return embeds, torch.from_numpy(mask).to(self.device), ids

    # -- generation ----------------------------------------------------------

    def __call__(self, inputs: List, **kwargs) -> str:
        return self.generate_batch([inputs], **kwargs)[0]

    def generate_batch(self, batch_inputs: List[List],
                       is_grounding: bool = False,
                       skip_special_tokens: bool = True,
                       speculative: bool = False, **kwargs) -> List[str]:
        """Several independent conversations as one left-padded batch →
        the decoded answers; kwargs as `generate_ids`. `speculative` is the
        continuous backend's routing hint; the batched path ignores it, as
        the JAX pipeline does."""
        ids = self.generate_ids(batch_inputs, is_grounding, **kwargs)
        ids = ids.cpu().numpy()
        self.last_stats.settle()
        return self.tokenizer.batch_decode(ids, skip_special_tokens)

    @torch.inference_mode()
    def generate_ids(self, batch_inputs: List[List], is_grounding=False,
                     num_beams: int = 5, max_new_tokens: int = 10,
                     min_len: int = 1, do_sample: bool = False,
                     penalty_alpha=None, top_p=None, top_k=None,
                     temperature=None, length_penalty: float = -1.0,
                     repetition_penalty: float = 1.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Several conversations as one left-padded batch → new token ids
        [B, max_new_tokens], with the reference's defaults (beam 5,
        length_penalty -1); penalty_alpha (contrastive search) sets one
        beam. generator draws the samples (seeded 0 when None). Timings of
        the call (encode_s, prefill_s, decode_s, decode_steps) land in
        `last_stats` (card times resolve once the ids are read)."""
        texts, images, videos = self._assemble_batch(batch_inputs,
                                                     is_grounding)
        ids, mask = self.tokenizer.encode_batch(texts, padding_side="left",
                                                pad_to_multiple=64)
        m0 = mark(self.device)
        image_embeds, video_embeds = self._encode_visuals(images, videos)
        if penalty_alpha:
            num_beams = 1
        self.last_stats = Stats(images=len(images), frames=len(videos),
                                rows=len(texts), prompt_len=ids.shape[1],
                                beams=max(num_beams, 1))
        self.last_stats.interval("encode_s", m0, mark(self.device))
        gcfg = GenerationConfig(
            max_new_tokens=max_new_tokens, min_length=min_len,
            num_beams=num_beams, do_sample=do_sample,
            temperature=temperature or 1.0, top_k=top_k or 0,
            top_p=top_p or 1.0, repetition_penalty=repetition_penalty,
            length_penalty=length_penalty,
            penalty_alpha=penalty_alpha or 0.0,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id)
        return emu2.generate(
            self.params, self.cfg, torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device), gcfg,
            self.tokenizer.image_token_id, image_embeds=image_embeds,
            video_token_id=self.tokenizer.gimg_token_id,
            video_embeds=video_embeds, stats=self.last_stats,
            generator=generator)

    @torch.inference_mode()
    def next_token_logits(self, inputs: List,
                          is_grounding: bool = False) -> torch.Tensor:
        """Last-position logits [1, V] of one conversation's prompt (a
        prefill, no decode): the quantity held against a reference."""
        embeds, mask, _ = self.embed_inputs(inputs, is_grounding)
        dec = self.params["decoder"]
        cache = llama.init_cache(self.cfg.llama, 1, embeds.shape[1],
                                 device=self.device, dtype=embeds.dtype,
                                 params=dec)
        hidden, _ = llama.prefill(dec, self.cfg.llama, embeds, mask, cache)
        return llama.logits(dec, hidden[:, -1])
