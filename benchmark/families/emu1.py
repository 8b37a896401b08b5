"""The Emu1 family (EVA-CLIP-g tower, T5-class Causal Former, LLaMA
decoder, bf16): its state dict as the benchmark draws it, the port's runner
built from it, and the plain reference of a caption's log-probabilities."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from benchmark import weights as W
from benchmark.reference import eva, llama as ref_llama, t5


def spec(config: dict) -> W.Spec:
    """Every tensor of an Emu1 checkpoint (the reference's names), with
    its shape and how it is drawn."""
    v, t, lm = config["vision"], config["t5"], config["llama"]
    s: W.Spec = {}
    eva.tower_spec(s, v, "visual.")
    W.layer_norm(s, "ln_visual", v["width"])
    c = "cformer.cformer."
    d, inner = t["d_model"], t["num_heads"] * t["d_kv"]
    for i in range(t["num_layers"]):
        b = f"{c}block.{i}.layer."
        for j, name, kv_in in ((0, "SelfAttention", d),
                               (1, "EncDecAttention", t["encoder_width"])):
            s[f"{b}{j}.layer_norm.weight"] = ((d,), "ones:0.05")
            W.linear(s, f"{b}{j}.{name}.q", d, inner, bias=False)
            W.linear(s, f"{b}{j}.{name}.k", kv_in, inner, bias=False)
            W.linear(s, f"{b}{j}.{name}.v", kv_in, inner, bias=False)
            W.linear(s, f"{b}{j}.{name}.o", inner, d, bias=False)
        s[f"{b}2.layer_norm.weight"] = ((d,), "ones:0.05")
        W.linear(s, f"{b}2.DenseReluDense.wi", d, t["d_ff"], bias=False)
        W.linear(s, f"{b}2.DenseReluDense.wo", t["d_ff"], d, bias=False)
    s[c + "block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
        (t["relative_attention_num_buckets"], t["num_heads"]), "normal:0.5")
    s[c + "final_layer_norm.weight"] = ((d,), "ones:0.05")
    s["cformer.causal_tokens"] = ((1, config["n_causal"], d), "normal:1.0")
    W.linear(s, "cformer.projection", d, lm["hidden_size"], bias=True)
    ref_llama.decoder_spec(s, lm, "decoder.lm.")
    return s


def port_config(config: dict):
    from emu_tpu_torch.config import (Emu1Config, LlamaConfig, T5Config,
                                      VisionConfig)
    return Emu1Config(vision=VisionConfig(**config["vision"]),
                      llama=LlamaConfig(**config["llama"]),
                      t5=T5Config(**config["t5"]),
                      n_causal=config["n_causal"], instruct=False)


def build_runner(config: dict, seed: int, device):
    """The port's Emu1 runner over the seeded weights, landed one layer at
    a time by the port's checkpoint converter, with the runner's own
    hash-bucket tokenizer."""
    from emu_tpu_torch.checkpoint import convert_emu1
    from emu_tpu_torch.cli.inference import Emu1Runner, tokenizer_for
    from emu_tpu_torch.models import emu1
    cfg = port_config(config)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    sd = W.SeededStateDict(spec(config), seed, device, dtype)
    tree = convert_emu1(sd, cfg, dtype, device)
    return Emu1Runner(emu1.Emu1(cfg, tree), cfg, tokenizer_for(cfg))


def drawer(config: dict, seed: int, device, dtype=torch.bfloat16):
    s = spec(config)

    def weight(name: str) -> torch.Tensor:
        shape, kind = s[name]
        return W.draw(seed, name, shape, kind, device, dtype)
    return weight


def reference_logits(config: dict, seed: int, device,
                     seqs: Sequence[List[int]], rows: Sequence[List[int]],
                     images: Sequence, control=None):
    """fp32 reference logits at positions rows[i] of each whole sequence
    (prompt ids then the caption's tokens), the n_causal visual tokens of
    images[i] (preprocessed [S, S, 3] fp32) taking its `image` positions.
    control, a precision one step below bf16 (8: int8, "fp8": float8
    e4m3): every product of the tower, the adapter and the decoder with
    its weights rounded to it per output channel and its inputs per
    token."""
    # the weights in the dtype the program was built in
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    weight = drawer(config, seed, device, dtype)
    bits = control or None
    image_id = config["special_ids"]["image"]
    embeds = []
    for ids, im in zip(seqs, images):
        pos = torch.tensor([j for j, tk in enumerate(ids) if tk == image_id],
                           device=device)
        feats = eva.tower(config["vision"], weight, im[None].to(device),
                          bits=bits)
        feats = eva.layer_norm(feats, weight("ln_visual.weight"),
                               weight("ln_visual.bias"),
                               config["vision"].get("ln_eps", 1e-6))
        e = t5.causal_former(config, weight, feats, bits=bits)[0]
        embeds.append((pos, e))
    seq_t = [torch.tensor(s, device=device) for s in seqs]
    row_t = [torch.tensor(r, device=device) for r in rows]
    return ref_llama.logits(config["llama"], weight, "decoder.lm.", seq_t,
                            row_t, int4=False, act_bits=bits,
                            embeds=embeds, w_bits=bits)
