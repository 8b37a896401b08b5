"""Emu1 runner, as `emu_tpu/cli/inference.py`: captioning, VQA,
interleaved-context QA and video QA with the reference's system prompts
and [USER]/[ASSISTANT] template, images through `encode_image`, text
through `generate` (beam 5 by default).

Usage:
  python -m emu_tpu_torch.cli.inference --ckpt-path emu.bin \
      [--tokenizer-path tok/] [--instruct] [--image x.png]
  python -m emu_tpu_torch.cli.inference --device cuda --full [--image x.png]
  python -m emu_tpu_torch.cli.inference --device cuda --full \
      --interleaved "[<IMG_PLH>]A cat. [<IMG_PLH>]And this?" \
      --image a.png --image b.png
  python -m emu_tpu_torch.cli.inference --device cuda --full \
      --frames f0.png f1.png f2.png --question "What happens?"
With --ckpt-path it loads the Emu1 checkpoint (a `.bin`, `.safetensors` or
an HF sharded directory; Emu-I's LoRA adapters are merged) and, with
--tokenizer-path, the LLaMA tokenizer (else the hash-bucket
SimpleTokenizer). Without a checkpoint the weights are random, drawn from
--seed: --full is the full Emu1, otherwise the JAX CLI's tiny
configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from emu_tpu_torch import tokenization as T
from emu_tpu_torch.checkpoint import load_emu1_checkpoint
from emu_tpu_torch.config import Emu1Config
from emu_tpu_torch.generation.engine import GenerationConfig
from emu_tpu_torch.mm_eval.engine import image_system_msg  # noqa: F401
from emu_tpu_torch.mm_eval.trie import build_trie
from emu_tpu_torch.models import emu1, llama
from emu_tpu_torch.ops.layers import Init
from emu_tpu_torch.pipelines import preprocess
from emu_tpu_torch.utils.profiling import RECORDER, Stats, mark

# the JAX CLI's video prompt (its `video_system_msg`), kept in the port
video_system_msg = (
    "You are a helpful assistant and you will be presented with a video "
    "consisting of multiple chronological images: [IMG]ImageContent[/IMG]. "
    "You will be able to see the video after I provide it to you. "
    "Please answer my questions based on the given video.")
# the marker an interleaved prompt puts where each image goes
IMAGE_MARKER = "[<IMG_PLH>]"


class Emu1Runner:
    def __init__(self, model: emu1.Emu1, cfg: Emu1Config,
                 tokenizer: T.EmuTokenizer):
        if "q_proj" in model.decoder.tree()["layers"]["self_attn"]:
            # fused qkv/gate_up decode layout: exact, fewer launches
            model.fuse_projections()
        self.model, self.cfg, self.tokenizer = model, cfg, tokenizer
        self.device = model.decoder.norm.device
        self.dtype = model.decoder.norm.dtype
        self.placeholder = "[IMG]" + "<image>" * cfg.n_causal + "[/IMG]"
        self.last_stats: dict = Stats()
        RECORDER.anchor(self.device)

    def _prompt(self, text: str, system: str, instruct: bool) -> str:
        return (f"{system} [USER]: {text} [ASSISTANT]:".strip() if instruct
                else text)

    def _inputs(self, images: Sequence, texts: Sequence[str], system: str,
                instruct: bool):
        ids, mask = self.tokenizer.encode_batch(
            [self._prompt(t, system, instruct) for t in texts],
            padding_side="left")
        image_embeds = None
        m0 = mark(self.device)
        if images:
            # the host's preprocessing and upload, then the tower and the
            # Causal Former on the card
            with RECORDER.span("pipeline.preprocess"):
                # the ViT computes in its input's dtype: feed it the model's
                batch = torch.from_numpy(preprocess.preprocess_batch(
                    images, self.cfg.vision.image_size)).to(self.device,
                                                            self.dtype)
            with RECORDER.span("pipeline.encode", self.device):
                e = self.model.encode_image(batch)
            image_embeds = e.reshape(-1, e.shape[-1])
        self.last_stats = Stats(images=len(images), rows=len(texts),
                                prompt_len=int(ids.shape[1]))
        self.last_stats.interval("encode_s", m0, mark(self.device))
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device), image_embeds)

    @torch.inference_mode()
    def generate_ids(self, images: Sequence, texts: Sequence[str],
                     system: str = "", instruct: bool = True,
                     max_new_tokens: int = 128, beam_size: int = 5,
                     length_penalty: float = 0.0, do_sample: bool = False,
                     temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 1.0, penalty_alpha: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     trie: Optional[dict] = None) -> torch.Tensor:
        """A batch of prompts (images in reading order over the batch) →
        new token ids [len(texts), max_new_tokens]. do_sample samples (with
        beam_size > 1: beam sampling) from `generator`; penalty_alpha with
        top_k > 1 and one beam is contrastive search; trie constrains a
        greedy or sampled decode (`build_trie`). Timings of the call land
        in `last_stats` (card times resolve once the ids are read)."""
        ids, mask, image_embeds = self._inputs(images, texts, system,
                                               instruct)
        self.last_stats["beams"] = max(beam_size, 1)
        gcfg = GenerationConfig(
            max_new_tokens=max_new_tokens, num_beams=beam_size,
            length_penalty=length_penalty, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            penalty_alpha=penalty_alpha,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id)
        return self.model.generate(ids, mask, image_embeds, gcfg,
                                   self.tokenizer.image_token_id,
                                   self.last_stats, generator, trie)

    def generate_batch(self, images: Sequence, texts: Sequence[str],
                       **kw) -> List[str]:
        out = self.generate_ids(images, texts, **kw).tolist()
        self.last_stats.settle()
        return [s.strip() for s in self.tokenizer.batch_decode(out)]

    def generate(self, images, text_sequence: str, system: str = "",
                 instruct: bool = True, max_new_tokens: int = 128,
                 beam_size: int = 5, length_penalty: float = 0.0,
                 **decode) -> str:
        """One prompt → its answer; `decode` as `generate_ids`'s sampling,
        contrastive and trie arguments."""
        return self.generate_batch(
            images or [], [text_sequence], system=system, instruct=instruct,
            max_new_tokens=max_new_tokens, beam_size=beam_size,
            length_penalty=length_penalty, **decode)[0]

    @torch.inference_mode()
    def next_token_logits(self, images, text_sequence: str, system: str = "",
                          instruct: bool = True) -> torch.Tensor:
        """Last-position logits [1, V] of the prompt (a prefill, no
        decode): the quantity held against a reference."""
        ids, mask, image_embeds = self._inputs(images or [], [text_sequence],
                                               system, instruct)
        params = self.model.tree()
        embeds = emu1.scatter_image_embeds(params, ids, image_embeds,
                                           self.tokenizer.image_token_id)
        dec = params["decoder"]
        cache = llama.init_cache(self.cfg.llama, 1, ids.shape[1],
                                 device=self.device, dtype=embeds.dtype,
                                 params=dec)
        hidden, _ = llama.prefill(dec, self.cfg.llama, embeds, mask, cache)
        return llama.logits(dec, hidden[:, -1])

    # -- the reference demo flows --------------------------------------------

    def caption_prompt(self) -> str:
        return (f"{self.placeholder}Please provide an accurate and concise "
                "description of the given image. The image depicts a photo of")

    def caption(self, image, max_new_tokens: int = 512,
                beam_size: int = 5, **decode) -> str:
        return self.generate([image], self.caption_prompt(),
                             system=image_system_msg,
                             max_new_tokens=max_new_tokens,
                             beam_size=beam_size, **decode)

    def vqa(self, image, question: str, max_new_tokens: int = 64,
            beam_size: int = 5, **decode) -> str:
        return self.generate([image], f"{self.placeholder}{question}",
                             system=image_system_msg,
                             max_new_tokens=max_new_tokens,
                             beam_size=beam_size, **decode)

    def interleaved_prompt(self, text_with_placeholders: str) -> str:
        """Each `[<IMG_PLH>]` marker becomes a full image placeholder."""
        return text_with_placeholders.replace(IMAGE_MARKER, self.placeholder)

    def interleaved(self, images, text_with_placeholders: str,
                    max_new_tokens: int = 128, beam_size: int = 5,
                    **decode) -> str:
        """Images and text in one prompt: `images` in the order of the
        markers, no system message."""
        return self.generate(images,
                             self.interleaved_prompt(text_with_placeholders),
                             system="", max_new_tokens=max_new_tokens,
                             beam_size=beam_size, **decode)

    def video_prompt(self, n_frames: int, question: str) -> str:
        """One full image placeholder per frame, then the question."""
        return self.placeholder * n_frames + question

    def video_qa(self, frames, question: str, max_new_tokens: int = 64,
                 beam_size: int = 5, **decode) -> str:
        """A question about a video given as its frames, in order."""
        return self.generate(frames, self.video_prompt(len(frames), question),
                             system=video_system_msg,
                             max_new_tokens=max_new_tokens,
                             beam_size=beam_size, **decode)

    def candidate_trie(self, candidates: Sequence[str]) -> dict:
        """The trie over the candidate answers' token sequences (each
        " answer" + EOS), as the JAX eval model's VizWiz answerability
        pass builds it, over the logits' width (the embedding's rows)."""
        seqs = [self.tokenizer.encode(" " + c, add_bos=False)
                + [self.tokenizer.eos_token_id] for c in candidates]
        return build_trie(seqs, self.model.decoder.embed_tokens.shape[0],
                          self.tokenizer.eos_token_id,
                          self.tokenizer.pad_token_id)

    def vqa_choice_ids(self, image, question: str,
                       candidates: Sequence[str]) -> torch.Tensor:
        """A greedy VQA answer constrained to one of `candidates` (the
        trie decode) → its new token ids [1, longest candidate + 1]."""
        trie = self.candidate_trie(candidates)
        n = max(len(self.tokenizer.encode(" " + c, add_bos=False))
                for c in candidates) + 1
        return self.generate_ids([image], [f"{self.placeholder}{question}"],
                                 system=image_system_msg, max_new_tokens=n,
                                 beam_size=1, trie=trie)


def tiny_config() -> Emu1Config:
    """The JAX CLI's tiny smoke configuration (32 causal tokens, vocab 262)."""
    base = Emu1Config.tiny()
    return Emu1Config(vision=base.vision, t5=base.t5, n_causal=32,
                      instruct=True,
                      llama=dataclasses.replace(base.llama,
                                                extended_vocab_size=262))


def tokenizer_for(cfg: Emu1Config) -> T.EmuTokenizer:
    """The CLI's SimpleTokenizer path (no tokenizer assets needed)."""
    return T.EmuTokenizer(T.SimpleTokenizer(cfg.llama.vocab_size),
                          T.emu1_special_tokens(cfg.instruct),
                          base_vocab=cfg.llama.vocab_size)


def with_depth(cfg: Emu1Config, depth: int) -> Emu1Config:
    """The same widths with every stack cut to `depth` layers."""
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=depth),
        t5=dataclasses.replace(cfg.t5, num_layers=depth),
        llama=dataclasses.replace(cfg.llama, num_hidden_layers=depth))


def build_runner(full: bool = False, device="cuda", seed: int = 0,
                 depth: Optional[int] = None, ckpt_path: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 instruct: bool = False) -> Emu1Runner:
    """A runner on `device`, in bf16 on CUDA (the kernels' dtype) and fp32
    on the CPU.

    ckpt_path: an Emu1 checkpoint (`checkpoint.load_emu1_checkpoint`) of
    the full Emu1 (`Emu1Config(instruct=instruct)`), with the LLaMA
    tokenizer at tokenizer_path (the SimpleTokenizer when None). Without
    one the weights are random, drawn on `device` from `seed`: full=True is
    the full Emu1 (ViT-g 40x1408, T5-base Causal Former, LLaMA-13B
    40x5120, vocab 32004), otherwise the JAX CLI's tiny configuration.
    depth cuts every stack to that many layers (a checkpoint's first
    `depth` layers)."""
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if ckpt_path is not None:
        cfg = Emu1Config(instruct=instruct)
        if depth is not None:
            cfg = with_depth(cfg, depth)
        tree = load_emu1_checkpoint(ckpt_path, cfg, dtype, device)
        tok = (T.EmuTokenizer.emu1(tokenizer_path, instruct=instruct)
               if tokenizer_path else tokenizer_for(cfg))
        return Emu1Runner(emu1.Emu1(cfg, tree), cfg, tok)
    cfg = Emu1Config() if full else tiny_config()
    if depth is not None:
        cfg = with_depth(cfg, depth)
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = emu1.init(cfg, Init(device=device, dtype=dtype, generator=gen))
    return Emu1Runner(emu1.Emu1(cfg, tree), cfg, tokenizer_for(cfg))


def load_images(paths: Sequence[str]) -> list:
    from PIL import Image
    return [Image.open(p).convert("RGB") for p in paths]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-path", default=None,
                   help="Emu1 checkpoint (.bin, .safetensors or an HF "
                        "sharded directory)")
    p.add_argument("--tokenizer-path", default=None,
                   help="LLaMA tokenizer directory (needs transformers)")
    p.add_argument("--instruct", action="store_true",
                   help="Emu-I: the instruct special tokens and prompt")
    p.add_argument("--full", action="store_true",
                   help="full-size Emu1 (random weights) instead of tiny")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image", action="append", default=None,
                   help="image for captioning/VQA; with --interleaved, one "
                        "per [<IMG_PLH>] marker, in order")
    p.add_argument("--question", default=None)
    p.add_argument("--interleaved", default=None,
                   help="a prompt with [<IMG_PLH>] where each --image goes")
    p.add_argument("--frames", nargs="+", default=None,
                   help="image paths read as one video, in order (video QA "
                        "of --question)")
    p.add_argument("--max-new-tokens", type=int, default=32)
    args = p.parse_args()
    if args.interleaved is not None and args.frames:
        p.error("--interleaved and --frames are two different flows")
    images = load_images(args.image or [])
    if args.interleaved is not None:
        if args.interleaved.count(IMAGE_MARKER) != len(images):
            p.error(f"--interleaved has {args.interleaved.count(IMAGE_MARKER)}"
                    f" {IMAGE_MARKER} markers and {len(images)} --image")
    elif args.frames:
        if images:
            p.error("--frames takes the video's images; drop --image")
    elif len(images) > 1:
        p.error("captioning and VQA take one --image")

    runner = build_runner(full=args.full, device=args.device, seed=args.seed,
                          ckpt_path=args.ckpt_path,
                          tokenizer_path=args.tokenizer_path,
                          instruct=args.instruct)
    n = args.max_new_tokens
    t0 = time.perf_counter()
    if args.interleaved is not None:
        print("===> interleaved:", runner.interleaved(
            images, args.interleaved, max_new_tokens=n))
    elif args.frames:
        print("===> video_qa:", runner.video_qa(
            load_images(args.frames),
            args.question or "What happens in the video?", max_new_tokens=n))
    else:
        if images:
            img = images[0]
        else:
            from PIL import Image
            img = Image.fromarray(np.full((224, 224, 3), 128, "uint8"))
            print("(no --image given; using a gray test image)")
        if args.question:
            print("===> vqa:", runner.vqa(img, args.question,
                                          max_new_tokens=n))
        else:
            print("===> caption:", runner.caption(img, max_new_tokens=n))
    print(f"({time.perf_counter() - t0:.2f} s; {runner.last_stats})")


if __name__ == "__main__":
    main()
