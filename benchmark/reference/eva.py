"""Plain PyTorch reference of the EVA-CLIP vision tower and Emu2's visual
tokens: patch embedding, class token, absolute positions, pre-norm
(x + attn(LN(x)), x + mlp(LN(x)); Emu1's ViT-g) or post-norm
(x + LN(attn(x)), x + LN(mlp(x)); Emu2's EVA-4B) blocks with a qkv
projection that has q and v biases only, exact-erf GELU MLP; for Emu2 the
patch tokens mean-pooled to `n_query` and projected to the decoder's
width.

fp32, TF32 off, one block at a time, weights drawn again through
`weight(name)`. A W8A8 tower (Emu2-Chat's serving recipe) has its products
rounded as the configuration serves them: each weight column to max|w| /
127 steps, each token's activations to max|x| / 127 steps; `bits` sets
both (None: float products; a control lowers it one step).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.llama import quant_rows


def quant_columns(w_out_in: torch.Tensor, bits) -> torch.Tensor:
    """A Linear weight [out, in] rounded per output channel → its kernel
    [in, out] in fp32."""
    return quant_rows(w_out_in.float(), bits).t()


def tower_spec(s: dict, v: dict, prefix: str) -> None:
    """The tower's entries in a benchmark state-dict spec (the EVA
    checkpoint's names under `prefix`): matrices at std 1 / sqrt(fan-in),
    biases and position embeddings at 0.02, LayerNorm scales 1 + 0.05
    noise."""
    from benchmark import weights as W
    w, p = v["width"], v["patch_size"]
    seq = (v["image_size"] // p) ** 2 + 1
    hidden = int(w * v["mlp_ratio"])
    s[prefix + "patch_embed.proj.weight"] = ((w, 3, p, p),
                                             f"normal:{(3 * p * p) ** -0.5}")
    s[prefix + "patch_embed.proj.bias"] = ((w,), "normal:0.02")
    s[prefix + "cls_token"] = ((1, 1, w), "normal:0.02")
    s[prefix + "pos_embed"] = ((1, seq, w), "normal:0.02")
    for i in range(v["layers"]):
        b = f"{prefix}blocks.{i}."
        W.layer_norm(s, b + "norm1", w)
        W.layer_norm(s, b + "norm2", w)
        W.linear(s, b + "attn.qkv", w, 3 * w, bias=False)
        s[b + "attn.q_bias"] = ((w,), "normal:0.02")
        s[b + "attn.v_bias"] = ((w,), "normal:0.02")
        W.linear(s, b + "attn.proj", w, w, bias=True)
        W.linear(s, b + "mlp.fc1", w, hidden, bias=True)
        W.linear(s, b + "mlp.fc2", hidden, w, bias=True)


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def tower(v: dict, weight: Callable[[str], torch.Tensor], images,
          bits: Optional[int] = 8, prefix: str = "visual.") -> torch.Tensor:
    """images [B, S, S, 3] normalised fp32 → [B, 1 + (S/p)^2, width];
    bits None: float products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, p, eps = v["width"], v["patch_size"], v.get("ln_eps", 1e-6)
    heads = w // v["head_width"]
    x = F.conv2d(images.float().permute(0, 3, 1, 2),
                 weight(prefix + "patch_embed.proj.weight").float(),
                 weight(prefix + "patch_embed.proj.bias").float(), stride=p)
    b = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    cls = weight(prefix + "cls_token").float().expand(b, 1, w)
    x = torch.cat([cls, x], 1) + weight(prefix + "pos_embed").float()
    s = x.shape[1]

    def dense(name, t, bias=True):
        y = quant_rows(t, bits) @ quant_columns(weight(name + ".weight"),
                                                bits)
        return y + weight(name + ".bias").float() if bias else y

    for i in range(v["layers"]):
        blk = f"{prefix}blocks.{i}."

        def ln(name, t):
            return layer_norm(t, weight(blk + name + ".weight"),
                              weight(blk + name + ".bias"), eps)

        def attn(t):
            qkv = dense(blk + "attn.qkv", t, bias=False)
            q, k, val = qkv.split(w, -1)
            q = q + weight(blk + "attn.q_bias").float()
            val = val + weight(blk + "attn.v_bias").float()
            q, k, val = (u.reshape(b, s, heads, -1).transpose(1, 2)
                         for u in (q, k, val))
            att = (q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5).softmax(-1)
            return dense(blk + "attn.proj",
                         (att @ val).transpose(1, 2).reshape(b, s, w))

        def mlp(t):
            return dense(blk + "mlp.fc2", F.gelu(dense(blk + "mlp.fc1", t)))

        if v.get("postnorm"):
            x = x + ln("norm1", attn(x))
            x = x + ln("norm2", mlp(x))
        else:
            x = x + attn(ln("norm1", x))
            x = x + mlp(ln("norm2", x))
    return x


def emu2_visual_tokens(config: dict, weight, images,
                       bits: Optional[int] = 8) -> torch.Tensor:
    """Normalised images [B, S, S, 3] → their n_query decoder-width tokens
    [B, n_query, d]: the tower's patch tokens mean-pooled over square
    windows and multiplied by project_up (not quantized)."""
    feats = tower(config["vision"], weight, images, bits=bits)
    b, g = feats.shape[0], int(round((feats.shape[1] - 1) ** 0.5))
    q = int(round(config["n_query"] ** 0.5))
    st = g // q
    t = feats[:, 1:].reshape(b, q, st, q, st, -1).mean((2, 4)).reshape(
        b, q * q, -1)
    return t @ weight("project_up.weight").float().t()
