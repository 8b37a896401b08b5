"""Kernels B and E: the transformer MLP branch [LN →] fc1 → act → fc2
[→ LN] [+ residual], fused.

Kernel B (`csrc/fused_mlp.cu`) replaces `emu_tpu/ops/fused_mlp.py:
fused_mlp` in its GELU forms: pre-LN (every Emu1 ViT-g block) and post-LN
(every bf16 Emu2 EVA-4B block); exact erf GELU, fp32 accumulation, fp32
LayerNorm, residual add, bf16 in and out, with the [M, hidden] activation
kept out of device memory. SwiGLU exists in the plain twin and raises
NotImplementedError on CUDA.

Kernel E (`csrc/fused_mlp_w8a8.cu`) replaces `fused_mlp_w8a8`: the W8A8
GELU MLP with per-row activation quantization and the hidden activation
re-quantized per row within each block of `bf` hidden columns.

`fused_mlp` and `fused_mlp_w8a8` are the wrappers: on a CPU tensor each
runs its plain twin (`*_reference`); on a CUDA tensor it launches its
kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops.quant import int_matmul, quantize_activations

_MAX_N = 1792  # the kernel keeps [16, N] fp32 in registers: 8 warps x 14 tiles


def _layer_norm32(x32, scale, bias, eps):
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fused_mlp_reference(x, w1, b1, w2, b2, w3=None, b3=None, ln_scale=None,
                        ln_bias=None, *, activation: str = "gelu",
                        ln_mode=None, residual: bool = False,
                        eps: float = 1e-6):
    """Plain twin of `fused_mlp`: products in the input dtype, bias,
    activation, LayerNorm and residual in fp32, as the TPU kernel."""
    dt = x.dtype
    xn = x
    if ln_mode == "pre":
        xn = _layer_norm32(x.float(), ln_scale, ln_bias, eps).to(dt)

    def fc(a, w, b):
        y = torch.matmul(a, w.to(dt)).float()
        return y if b is None else y + b.float()

    if activation == "swiglu":
        h = (F.silu(fc(xn, w1, b1)) * fc(xn, w2, b2)).to(dt)
        y = fc(h, w3, b3)
    else:
        y = fc(F.gelu(fc(xn, w1, b1)).to(dt), w2, b2)
    if ln_mode == "post":
        y = _layer_norm32(y, ln_scale, ln_bias, eps)
    if residual:
        y = y + x.float()
    return y.to(dt)


def fused_mlp(x, w1, b1, w2, b2, w3=None, b3=None, ln_scale=None,
              ln_bias=None, *, activation: str = "gelu", ln_mode=None,
              residual: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """x [..., K] → [..., N] through [LN →] fc1/act/fc2 [→ LN] [+ x].

    gelu: act(x@w1+b1) @ w2 + b2 (exact erf GELU); swiglu:
    (silu(x@w1+b1) * (x@w2+b2)) @ w3 + b3. Kernels are [in, out]; biases
    may be None; residual requires N == K."""
    if _cuda.on_cpu(x, "fused_mlp"):
        return fused_mlp_reference(
            x, w1, b1, w2, b2, w3, b3, ln_scale, ln_bias,
            activation=activation, ln_mode=ln_mode, residual=residual,
            eps=eps)
    _cuda.refuse_grad("fused_mlp", x, w1, b1, w2, b2, w3, b3, ln_scale,
                      ln_bias)
    if activation != "gelu":
        raise NotImplementedError(
            "fused_mlp on CUDA builds the GELU forms only; SwiGLU is still to "
            "port")
    lead, k = x.shape[:-1], x.shape[-1]
    f, n = w1.shape[1], w2.shape[1]
    bf = torch.bfloat16
    _cuda.require(x.dtype == w1.dtype == w2.dtype == bf,
                  "fused_mlp: x, w1, w2 must be bfloat16")
    _cuda.require(w1.shape == (k, f) and w2.shape == (f, n),
                  f"fused_mlp: bad shapes x{tuple(x.shape)} "
                  f"w1{tuple(w1.shape)} w2{tuple(w2.shape)}")
    _cuda.require(k % 16 == 0 and f % 16 == 0 and n % 16 == 0 and n <= _MAX_N,
                  f"fused_mlp: K, F, N must be multiples of 16 and N <= "
                  f"{_MAX_N} (got {k}, {f}, {n})")
    _cuda.require(not residual or n == k, "fused_mlp: residual needs N == K")
    _cuda.require((ln_mode is not None) == (ln_scale is not None),
                  "fused_mlp: ln_mode needs ln_scale and ln_bias")
    xf = x.reshape(-1, k).contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    for name, t in (("x", xf), ("w1", w1), ("w2", w2)):
        _cuda.require(t.device == x.device and t.data_ptr() % 32 == 0,
                      f"fused_mlp: {name} must be 32-byte aligned")
    vecs = [None if t is None else t.to(bf).contiguous()
            for t in (ln_scale, ln_bias, b1, b2)]
    m = xf.shape[0]
    out = torch.empty(m, n, device=x.device, dtype=bf)
    with torch.cuda.device(x.device):
        lib = _cuda.library()
        # fp32 partial sums, one [M, N] slice per hidden-dim split, summed
        # in a fixed order (see csrc/fused_mlp.cu)
        splits = lib.emu_fused_mlp_splits(m, f)
        ws = torch.empty(splits, m, n, device=x.device, dtype=torch.float32)
        status = lib.emu_fused_mlp_fwd(
            xf.data_ptr(), _cuda.ptr(vecs[0]), _cuda.ptr(vecs[1]),
            w1.data_ptr(), _cuda.ptr(vecs[2]), w2.data_ptr(),
            _cuda.ptr(vecs[3]), ws.data_ptr(), out.data_ptr(), m, k, f, n,
            splits, float(eps), int(residual), int(ln_mode == "post"),
            _cuda.stream(x))
    _cuda.check(status, "fused_mlp")
    fused_mlp.launches += 1
    return out.reshape(*lead, n)


fused_mlp.launches = 0


def _erf_as(x):
    """erf by Abramowitz & Stegun 7.1.26, the form the TPU kernels use."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_as(x):
    return 0.5 * x * (1.0 + _erf_as(x * 2.0 ** -0.5))


def fused_mlp_w8a8_reference(x, w1_q8, scale1, b1, w2_q8, scale2, b2,
                             ln_scale=None, ln_bias=None, *, ln_mode=None,
                             residual: bool = False, eps: float = 1e-6,
                             bf: int = 768):
    """Plain twin of `fused_mlp_w8a8`, in the TPU kernel's order of
    operations; the integer products are exact (`quant.int_matmul`)."""
    k = x.shape[-1]
    f, n = w1_q8.shape[1], w2_q8.shape[1]
    x32 = x.reshape(-1, k).float()
    xin = _layer_norm32(x32, ln_scale, ln_bias, eps) if ln_mode == "pre" \
        else x32
    xq, sx = quantize_activations(xin)
    h = int_matmul(xq, w1_q8).float() * sx * scale1.float()
    if b1 is not None:
        h = h + b1.float()
    h = gelu_as(h)
    m = h.shape[0]
    nb = -(-f // bf)
    # zero padding to whole blocks does not move a block's max
    hb = F.pad(h, (0, nb * bf - f)).reshape(m, nb, bf)
    hq, sh = quantize_activations(hb)
    acc = torch.zeros(m, n, device=x.device)
    for j in range(nb):   # the per-block sums, in block order
        hj = hq[:, j, :min(bf, f - j * bf)].contiguous()
        wj = w2_q8[j * bf:j * bf + hj.shape[1]]
        acc = acc + int_matmul(hj, wj).float() * sh[:, j]
    y = acc * scale2.float()
    if b2 is not None:
        y = y + b2.float()
    if ln_mode == "post":
        y = _layer_norm32(y, ln_scale, ln_bias, eps)
    if residual:
        y = y + x32
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


def fused_mlp_w8a8(x, w1_q8, scale1, b1, w2_q8, scale2, b2, ln_scale=None,
                   ln_bias=None, *, ln_mode=None, residual: bool = False,
                   eps: float = 1e-6, bf: int = 768) -> torch.Tensor:
    """W8A8 GELU MLP x [..., K] → [..., N]: [LN →] quant → fc1 (s8) →
    GELU → requant per (row, bf-wide hidden block) → fc2 (s8) [→ LN]
    [+ x]. Weights int8 [K, F] / [F, N] with fp32 per-output-channel
    scales; biases may be None; residual requires N == K."""
    if _cuda.on_cpu(x, "fused_mlp_w8a8"):
        return fused_mlp_w8a8_reference(
            x, w1_q8, scale1, b1, w2_q8, scale2, b2, ln_scale, ln_bias,
            ln_mode=ln_mode, residual=residual, eps=eps, bf=bf)
    _cuda.refuse_grad("fused_mlp_w8a8", x, scale1, b1, scale2, b2, ln_scale,
                      ln_bias)
    lead, k = x.shape[:-1], x.shape[-1]
    f, n = w1_q8.shape[1], w2_q8.shape[1]
    bf16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    _cuda.require(x.dtype == bf16 and w1_q8.dtype == w2_q8.dtype == i8,
                  "fused_mlp_w8a8: x must be bfloat16, weights int8")
    _cuda.require(w1_q8.shape == (k, f) and w2_q8.shape == (f, n),
                  f"fused_mlp_w8a8: bad shapes x{tuple(x.shape)} "
                  f"w1{tuple(w1_q8.shape)} w2{tuple(w2_q8.shape)}")
    _cuda.require(k % 128 == 0 and f % 128 == 0 and bf % 128 == 0
                  and f % bf == 0 and n <= 2048,
                  f"fused_mlp_w8a8: K, F, bf must be multiples of 128, F of "
                  f"bf, N <= 2048 (got {k}, {f}, {bf}, {n})")
    _cuda.require(not residual or n == k,
                  "fused_mlp_w8a8: residual needs N == K")
    _cuda.require((ln_mode is not None) == (ln_scale is not None),
                  "fused_mlp_w8a8: ln_mode needs ln_scale and ln_bias")
    xf = x.reshape(-1, k).contiguous()
    m = xf.shape[0]
    vec = [None if t is None else t.to(bf16).contiguous()
           for t in (b1, b2, ln_scale, ln_bias)]
    w1_q8, w2_q8 = w1_q8.contiguous(), w2_q8.contiguous()
    scale1, scale2 = scale1.float().contiguous(), scale2.float().contiguous()
    dev = x.device
    xq, sx = torch.empty(m, k, device=dev, dtype=i8), torch.empty(m, device=dev)
    h, hq = (torch.empty(m, f, device=dev, dtype=f32),
             torch.empty(m, f, device=dev, dtype=i8))
    hs = torch.empty(m, f // bf, device=dev, dtype=f32)
    ws = torch.empty(m, n, device=dev, dtype=f32)
    out = torch.empty(m, n, device=dev, dtype=bf16)
    with torch.cuda.device(dev):
        status = _cuda.library().emu_fused_mlp_w8a8_fwd(
            xf.data_ptr(), w1_q8.data_ptr(), scale1.data_ptr(),
            _cuda.ptr(vec[0]), w2_q8.data_ptr(), scale2.data_ptr(),
            _cuda.ptr(vec[1]),
            _cuda.ptr(vec[2]), _cuda.ptr(vec[3]),
            {None: 0, "pre": 1, "post": 2}[ln_mode], int(residual),
            float(eps), xq.data_ptr(), sx.data_ptr(), h.data_ptr(),
            hq.data_ptr(), hs.data_ptr(), ws.data_ptr(), out.data_ptr(),
            m, k, f, n, bf, _cuda.stream(x))
    _cuda.check(status, "fused_mlp_w8a8")
    fused_mlp_w8a8.launches += 1
    return out.reshape(*lead, n)


fused_mlp_w8a8.launches = 0
