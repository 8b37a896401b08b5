"""Core neural-net ops over the JAX package's param layout.

Parameters are nested dicts of tensors shaped as in `emu_tpu` (linear
kernels [in, out], so `y = x @ W`; the patch embedding a [p·p·c, width]
matmul kernel). Normalisations run in fp32 and cast back, matching the
reference's LayerNormFp32 (`emu_tpu/ops/layers.py:131-156`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops import quant as Q
from emu_tpu_torch.ops.fused_mlp import (_matmul_f32, fused_dense, fused_mlp,
                                        fused_mlp_w8a8)
from emu_tpu_torch.ops.q4_matmul import matmul_q4, q4_plan


@dataclass(frozen=True)
class Init:
    """Where parameters are made and what draws the random ones.

    Random weights are N(0, std²) clipped at ±2σ, drawn in fp32 one leading
    slice at a time (one layer of a stacked tensor), so a 13B model is
    built on the device with a few hundred MB of scratch. On the meta
    device nothing is drawn: shapes only, for loading a checkpoint."""
    device: Union[str, torch.device] = "cpu"
    dtype: torch.dtype = torch.float32
    generator: Optional[torch.Generator] = None

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, *shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def normal(self, *shape, std: float = 0.02):
        t = torch.empty(shape, device=self.device, dtype=self.dtype)
        if t.is_meta:
            return t
        for part in (t if t.dim() > 2 else (t,)):
            part.copy_(torch.empty(part.shape, device=t.device).normal_(
                generator=self.generator).clamp_(-2.0, 2.0).mul_(std))
        return t

    def dense(self, *lead, in_dim: int, out_dim: int, bias: bool = True,
              quant: Optional[str] = None):
        """A dense layer's params; quant ("int8", "w8a8", "int4") draws the
        kernel one leading slice at a time in `dtype` and stores only its
        quantized form (`quant.quantize_dense`), so a model too large for
        the device in bf16 is built quantized."""
        if quant is None:
            p = {"kernel": self.normal(*lead, in_dim, out_dim)}
        elif not lead:
            p = Q.quantize_dense(self.normal(in_dim, out_dim), quant)
        else:
            p = {}
            for i in range(lead[0]):
                q = Q.quantize_dense(self.normal(in_dim, out_dim), quant)
                if not p:
                    p = {k: torch.empty(lead[0], *v.shape, dtype=v.dtype,
                                        device=v.device) for k, v in q.items()}
                for k, v in q.items():
                    p[k][i] = v
        if bias:
            p["bias"] = self.zeros(*lead, out_dim)
        return p

    def layer_norm(self, *lead, dim: int):
        return {"scale": self.ones(*lead, dim), "bias": self.zeros(*lead, dim)}


def dense_plan(params: dict, x) -> bool:
    """Whether `dense` takes kernel H (`fused_dense`, its plain form): a
    biased dense with float (or dequantized int4) weights and bf16
    activations, that autograd is not recording. fp32 activations keep
    torch.matmul; a recorded dense keeps the plain fp32 composition (the
    JAX `dense` differentiates through XLA, with no kernel); weight-only
    int8 keeps it too, since its scale sits between the product and the
    bias."""
    bias = params.get("bias")
    if bias is None or x.dtype != torch.bfloat16 or not (
            "kernel" in params or "kernel_q4" in params):
        return False
    return not _cuda.records(x, params.get("kernel"), bias)


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ b), as the JAX `dense`: the product and the bias are
    summed in fp32 and rounded once to x's dtype; kernel H where
    `dense_plan` admits it.

    Also takes the quantized forms of `ops.quant`: W8A8 {"kernel_w8a8",
    "scale"}, weight-only int8 {"kernel_q8", "scale"} (the scale applies
    to the fp32 sum), and int4 {"kernel_q4", "scale4"}, which runs kernel
    F where `q4_plan` allows and otherwise dequantizes to x's dtype."""
    bias = params.get("bias")
    if "kernel_w8a8" in params:
        return Q.dense_w8a8(params, x)
    if "kernel_q8" in params:
        y = _matmul_f32(x, params["kernel_q8"].to(x.dtype))
        y = y * params["scale"].float()
    elif "kernel_q4" in params:
        if q4_plan(params, x):
            return matmul_q4(x, params["kernel_q4"], params["scale4"], bias)
        w = Q.dequantize_int4(params, x.dtype)
        if bias is None:
            return torch.matmul(x, w)
        if dense_plan(params, x):
            return fused_dense(x, w, bias)
        y = _matmul_f32(x, w)
    elif bias is None:
        return torch.matmul(x, params["kernel"].to(x.dtype))
    elif dense_plan(params, x):
        return fused_dense(x, params["kernel"].to(x.dtype), bias)
    else:
        y = _matmul_f32(x, params["kernel"].to(x.dtype))
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_dense(norm_params: dict, params: dict, x: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """dense(layer_norm(x)) with the JAX composition's two roundings (the
    normalised input to x's dtype, the output once): kernel H's pre form
    where `dense_plan` admits a float-weight dense, else the two calls."""
    recorded = _cuda.records(*norm_params.values())
    if "kernel" in params and dense_plan(params, x) and not recorded:
        return fused_dense(x, params["kernel"].to(x.dtype), params["bias"],
                           norm_params["scale"], norm_params["bias"],
                           ln_mode="pre", eps=eps)
    return dense(params, layer_norm(norm_params, x, eps))


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    """LayerNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """LLaMA RMSNorm / T5LayerNorm with HF semantics: variance in fp32, cast
    back to the input dtype BEFORE the scale multiply."""
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
         ).to(x.dtype)
    return y * scale.to(x.dtype)


def w8a8_mlp_plan(params: dict, x) -> Optional[int]:
    """The hidden block of kernel E for a W8A8 GELU MLP, or None for the
    unfused route (two W8A8 products, the whole hidden row quantized at
    once). The JAX package's rule: bf16, no sub-LN, >= 2048 rows, width
    <= 2304; the block is 768 at those widths."""
    names = ("fc1", "fc2")
    if "ffn_ln" in params or any(n not in params
                                 or "kernel_w8a8" not in params[n]
                                 for n in names):
        return None
    if x.numel() // x.shape[-1] < 2048 or x.element_size() > 2:
        return None
    dim = max(x.shape[-1], params["fc2"]["kernel_w8a8"].shape[1])
    return 768 if dim <= 2304 else None


def gelu_mlp(params: dict, x, subln_eps: Optional[float] = None):
    """ViT MLP: Linear → exact GELU → (optional sub-LN) → Linear; W8A8
    shapes that `w8a8_mlp_plan` admits run kernel E."""
    bf = w8a8_mlp_plan(params, x)
    if bf is not None:
        p1, p2 = params["fc1"], params["fc2"]
        return fused_mlp_w8a8(x, p1["kernel_w8a8"], p1["scale"],
                              p1.get("bias"), p2["kernel_w8a8"], p2["scale"],
                              p2.get("bias"), bf=bf)
    h = F.gelu(dense(params["fc1"], x))
    if "ffn_ln" in params:
        h = layer_norm(params["ffn_ln"], h, eps=subln_eps or 1e-6)
    return dense(params["fc2"], h)


def swiglu_mlp(params: dict, x, subln_eps: Optional[float] = None):
    """EVA SwiGLU MLP: silu(w1(x)) * w2(x) → (optional sub-LN) → w3."""
    h = F.silu(dense(params["w1"], x)) * dense(params["w2"], x)
    if "ffn_ln" in params:
        h = layer_norm(params["ffn_ln"], h, eps=subln_eps or 1e-6)
    return dense(params["w3"], h)


def fused_block_mlp(norm_params: dict, mlp_params: dict, x, eps: float,
                    postnorm: bool):
    """Whole MLP residual branch in one fused MLP kernel: pre-norm (Emu1)
    x + mlp(LN(x)); post-norm (Emu2) x + LN(mlp(x)). For blocks without a
    sub-LN inside the MLP. Float weights run kernel B at every row count;
    W8A8 weights run kernel E where `w8a8_mlp_plan` admits them. Otherwise,
    and for fp32 activations (the JAX package's rule, `layers.py:195`),
    this returns None: the caller runs the unfused branch."""
    p = mlp_params
    if not _cuda.kernel_dtype(x):
        return None
    kw = dict(ln_scale=norm_params["scale"], ln_bias=norm_params["bias"],
              ln_mode="post" if postnorm else "pre", residual=True, eps=eps)
    if "fc1" in p and "kernel_w8a8" in p["fc1"]:
        bf = w8a8_mlp_plan(p, x)
        if bf is None:
            return None
        return fused_mlp_w8a8(x, p["fc1"]["kernel_w8a8"], p["fc1"]["scale"],
                              p["fc1"].get("bias"), p["fc2"]["kernel_w8a8"],
                              p["fc2"]["scale"], p["fc2"].get("bias"), bf=bf,
                              **kw)
    if any("kernel" not in p[n] for n in p if n != "ffn_ln"):
        return None                       # other quantized forms: unfused
    if "w1" in p:
        return fused_mlp(x, p["w1"]["kernel"], p["w1"].get("bias"),
                         p["w2"]["kernel"], p["w2"].get("bias"),
                         p["w3"]["kernel"], p["w3"].get("bias"),
                         activation="swiglu", **kw)
    return fused_mlp(x, p["fc1"]["kernel"], p["fc1"].get("bias"),
                     p["fc2"]["kernel"], p["fc2"].get("bias"), **kw)


def llama_mlp(params: dict, x):
    """LLaMA gated MLP: down(silu(gate(x)) * up(x)); one matmul for both
    input projections on the fused `gate_up` layout."""
    if "gate_up" in params:
        g, u = dense(params["gate_up"], x).chunk(2, dim=-1)
        return dense(params["down"], F.silu(g) * u)
    return dense(params["down"],
                 F.silu(dense(params["gate"], x)) * dense(params["up"], x))


def patch_embed(params: dict, images, patch_size: int):
    """[B, H, W, C] images → [B, (H/p)*(W/p), width] patch tokens: the
    stride == kernel conv as a patchify reshape plus one matmul, pixels in
    (h, w, c) order."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return dense(params, x.reshape(b, gh * gw, p * p * c))


def avg_pool_tokens(tokens, n_query: int):
    """Average-pool a square token grid [B, S, C] (S a perfect square) to
    [B, n_query, C], in fp32 (the Emu2 adapter's permute + avg_pool2d)."""
    b, s, c = tokens.shape
    g = int(round(s ** 0.5))
    q = int(round(n_query ** 0.5))
    stride = g // q
    x = tokens.reshape(b, q, stride, q, stride, c).float().mean(dim=(2, 4))
    return x.reshape(b, q * q, c).to(tokens.dtype)
