"""The Emu2 family (EVA-CLIP tower, mean-pooled projection, LLaMA decoder):
its state dict as the benchmark draws it, the port's objects built from
it, and the plain reference of what the served path computes."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from benchmark import weights as W
from benchmark.reference import eva, llama as ref_llama


def spec(config: dict) -> W.Spec:
    """Every tensor of an Emu2 checkpoint (the reference's names), with
    its shape and how it is drawn."""
    v, lm = config["vision"], config["llama"]
    s: W.Spec = {}
    eva.tower_spec(s, v, "visual.")
    ref_llama.decoder_spec(s, lm, "decoder.lm.")
    w, d = v["width"], lm["hidden_size"]
    W.linear(s, "project_up", w, d, bias=False)
    W.linear(s, "project_down", d, w, bias=False)
    return s


def port_config(config: dict):
    from emu_tpu_torch.config import Emu2Config, LlamaConfig, VisionConfig
    return Emu2Config(vision=VisionConfig(**config["vision"]),
                      llama=LlamaConfig(**config["llama"]),
                      n_query=config["n_query"], v_query=config["v_query"],
                      instruct=True)


def build_chat(config: dict, seed: int, device):
    """The port's chat pipeline over the seeded weights, landed one layer
    at a time by the port's checkpoint converter (fused and quantized as
    each layer lands, as `from_pretrained` does)."""
    from emu_tpu_torch.checkpoint import convert_emu2
    from emu_tpu_torch.pipelines.chat import EmuChatGeneration
    cfg = port_config(config)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    quant = config.get("quantize")
    sd = W.SeededStateDict(spec(config), seed, device, dtype)
    params = convert_emu2(sd, cfg, dtype, device, quant)
    return EmuChatGeneration(params, cfg, quantize=quant)


def drawer(config: dict, seed: int, device, dtype=torch.bfloat16):
    s = spec(config)

    def weight(name: str) -> torch.Tensor:
        shape, kind = s[name]
        return W.draw(seed, name, shape, kind, device, dtype)
    return weight


def reference_logits(config: dict, seed: int, device,
                     seqs: Sequence[List[int]], rows: Sequence[List[int]],
                     images: Optional[Sequence] = None, control=False):
    """fp32 reference logits at positions rows[i] of each whole sequence
    (prompt ids then served tokens); images[i], when given, is the
    preprocessed image [H, W, 3] (fp32, normalised) of sequence i, whose
    visual tokens take the `image` placeholder positions. control=True is
    the configuration one step lower: every int8 quantity at int4."""
    # the weights in the dtype the program was built in
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    weight = drawer(config, seed, device, dtype)
    lm = config["llama"]
    kv = 8 if config["serving"].get("kv_quant") else None
    embeds = None
    if images is not None and any(im is not None for im in images):
        image_id = config["special_ids"]["image"]
        bits = (4 if control else 8) if config.get("quantize") else None
        idx = [i for i, im in enumerate(images) if im is not None]
        vis = eva.emu2_visual_tokens(
            config, weight, torch.stack([images[i] for i in idx]).to(device),
            bits)
        embeds = [None] * len(seqs)
        for k, i in enumerate(idx):
            pos = torch.tensor([j for j, t in enumerate(seqs[i])
                                if t == image_id], device=device)
            embeds[i] = (pos, vis[k])
    seq_t = [torch.tensor(s, device=device) for s in seqs]
    row_t = [torch.tensor(r, device=device) for r in rows]
    quant = config.get("quantize")
    return ref_llama.logits(
        lm, weight, "decoder.lm.", seq_t, row_t, int4=quant == "int4",
        act_bits=4 if control else None,
        kv_bits=4 if control and kv else kv, embeds=embeds)
