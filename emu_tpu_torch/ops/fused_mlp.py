"""Kernels B, E and H: the transformer MLP branch [LN →] fc1 → act → fc2
[→ LN] [+ residual], fused, and one dense layer with its epilogue.

Kernel B (`csrc/fused_mlp.cu`) replaces `emu_tpu/ops/fused_mlp.py:
fused_mlp`: the GELU forms, pre-LN (every Emu1 ViT-g block) and post-LN
(every bf16 Emu2 EVA-4B block), and the SwiGLU form (a SwiGLU EVA ViT);
exact erf GELU or silu(g)·u, fp32 accumulation, fp32 LayerNorm, residual
add, bf16 in and out. Its two products run on kernel H's TMA + wgmma GEMM
with the activation in the first one's epilogue; the [M, hidden]
activation crosses device memory once, in bf16 (the value the TPU kernel
rounds it to before the second product). `mlp_plan` is its host side.

Kernel E (`csrc/fused_mlp_w8a8.cu`) replaces `fused_mlp_w8a8`: the W8A8
GELU MLP with per-row activation quantization and the hidden activation
re-quantized per row within each block of `bf` hidden columns, both
products on s8 wgmma, fc1's blocks of one hidden block a thread-block
cluster sharing their row maxima. `w8a8_plan` is its host side.

Kernel H (`csrc/fused_dense.cu`) replaces `fused_dense`: [LN(x) →] x·W +
b [→ LN over the row] [+ residual], the product on the tensor cores in
fp32, one rounding at the end. Its plain form carries every biased bf16
dense of the port (`layers.dense`, `dense_plan`). `fused_dense_plan`
chooses its GEMM by shape: the TMA + wgmma plan or the mma.sync plan.

`fused_mlp`, `fused_mlp_w8a8` and `fused_dense` are the wrappers: on a CPU
tensor each runs its plain twin (`*_reference`); on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops.quant import int_matmul, quantize_activations

def _matmul_f32(x, w):
    """x @ w with the fp32 sum kept, not rounded to x's dtype: the
    products of bf16 values are exact in fp32, so this is the sum a bf16
    matmul accumulates before its rounding."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float())


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


# Kernel B's hidden activation crosses device memory once, in bf16; its
# width is F rounded up to this, since the tensor maps of the first
# product's weights and of h need rows of a whole 16 bytes
MLP_F_ALIGN = 8
# the C entries' LayerNorm placement (B, E and H)
_LN_MODES = {None: 0, "pre": 1, "post": 2}


def mlp_plan(m: int, k: int, f: int, n: int, activation: str = "gelu",
             ln_mode=None) -> dict:
    """Kernel B's host-side plan for x [m, k] -> hidden [m, f] -> [m, n]:
    `f_pad`, the hidden width the first product writes (the hidden-side
    weights are zero-padded to it when f is not a multiple of
    MLP_F_ALIGN); `cols`, the hidden columns a block of the first product
    owns (SwiGLU: 64 gate and 64 up columns of the same units); the grids
    of both products (blocks along N, along M: 128-row tiles); the
    workspaces in bytes (xn: the pre form's LN(x), h: the hidden
    activation, ws: the post form's fp32 output). A function of the shape
    alone; raises ValueError outside the kernel's envelope."""
    _cuda.require(activation in ("gelu", "swiglu"),
                  f"fused_mlp: unknown activation {activation!r}")
    _cuda.require(ln_mode in _LN_MODES,
                  f"fused_mlp: unknown ln_mode {ln_mode!r}")
    _cuda.require(m > 0 and f > 0 and k % 16 == 0 and n % 16 == 0,
                  f"fused_mlp: K, N must be multiples of 16 (got {k}, {n})")
    f_pad = -(-f // MLP_F_ALIGN) * MLP_F_ALIGN
    cols = 64 if activation == "swiglu" else 128
    rows = -(-m // 128)
    return {"f_pad": f_pad, "pad": f_pad != f, "cols": cols,
            "grid1": (-(-f_pad // cols), rows),
            "grid2": (-(-n // 128), rows),
            "xn_bytes": 2 * m * k if ln_mode == "pre" else 0,
            "h_bytes": 2 * m * f_pad,
            "ws_bytes": 4 * m * n if ln_mode == "post" else 0}


def mlp_hidden_columns(plan: dict, bx: int) -> range:
    """The hidden columns that block bx of kernel B's first product
    writes (its tile of `cols`, cut at f_pad)."""
    c0 = bx * plan["cols"]
    return range(c0, min(c0 + plan["cols"], plan["f_pad"]))


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
    swiglu = activation == "swiglu"
    # the hidden-side weights [K, F] and the output projection [F, N]
    w_out, b_out = (w3, b3) if swiglu else (w2, b2)
    hidden = [w1, w2] if swiglu else [w1]
    lead, k = x.shape[:-1], x.shape[-1]
    f, n = w1.shape[1], w_out.shape[1]
    bf = torch.bfloat16
    _cuda.require(x.dtype == bf and all(w.dtype == bf
                                        for w in hidden + [w_out]),
                  "fused_mlp: x and the weights must be bfloat16")
    _cuda.require(all(w.shape == (k, f) for w in hidden)
                  and w_out.shape == (f, n),
                  f"fused_mlp: bad shapes x{tuple(x.shape)} "
                  f"w1{tuple(w1.shape)} w_out{tuple(w_out.shape)}")
    _cuda.require(not residual or n == k, "fused_mlp: residual needs N == K")
    _cuda.require((ln_mode is not None) == (ln_scale is not None),
                  "fused_mlp: ln_mode needs ln_scale and ln_bias")
    xf = x.reshape(-1, k).contiguous()
    m = xf.shape[0]
    plan = mlp_plan(m, k, f, n, activation, ln_mode)
    b_hid = [b1, b2] if swiglu else [b1]
    if plan["pad"]:
        # zero hidden columns up to f_pad: act(0) = silu(0)·0 = 0, and the
        # output weights' rows past F read as zeros in the kernel
        grow = plan["f_pad"] - f
        hidden = [F.pad(w, (0, grow)) for w in hidden]
        b_hid = [None if t is None else F.pad(t, (0, grow)) for t in b_hid]
    hidden = [w.contiguous() for w in hidden]
    w_out = w_out.contiguous()
    for name, t in (("x", xf), *zip(("w1", "w2"), hidden), ("w_out", w_out)):
        _cuda.require(t.device == x.device and t.data_ptr() % 16 == 0,
                      f"fused_mlp: {name} must be 16-byte aligned")
    lns, lnb, *bias = [None if t is None else t.to(bf).contiguous()
                       for t in (ln_scale, ln_bias, *b_hid, b_out)]
    # the C entry's (w2, b2) and (w3, b3): SwiGLU's up and output
    # projections; GELU's output projection and NULL
    w3_, b3_ = (w_out, bias[2]) if swiglu else (None, None)
    w2_ = hidden[1] if swiglu else w_out
    out = torch.empty(m, n, device=x.device, dtype=bf)
    dev = x.device
    xn = (torch.empty(m, k, device=dev, dtype=bf) if plan["xn_bytes"]
          else None)
    h = torch.empty(m, plan["f_pad"], device=dev, dtype=bf)
    ws = (torch.empty(m, n, device=dev, dtype=torch.float32)
          if plan["ws_bytes"] else None)
    with _cuda.device_of(x):
        status = _cuda.library().emu_fused_mlp_fwd(
            xf.data_ptr(), _cuda.ptr(lns), _cuda.ptr(lnb),
            hidden[0].data_ptr(), _cuda.ptr(bias[0]), w2_.data_ptr(),
            _cuda.ptr(bias[1]), _cuda.ptr(w3_), _cuda.ptr(b3_), _cuda.ptr(xn),
            h.data_ptr(), _cuda.ptr(ws), out.data_ptr(), m, k,
            plan["f_pad"], f, n, float(eps), int(residual),
            _LN_MODES[ln_mode], _cuda.stream(x))
    _cuda.check(status, "fused_mlp")
    fused_mlp.launches += 1
    fused_mlp.forms[activation] += 1
    return out.reshape(*lead, n)


fused_mlp.launches = 0
fused_mlp.forms = {"gelu": 0, "swiglu": 0}


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


W8A8_TILE = 128        # kernel E's output tiles: 128 x 128, K 128 bytes a step
W8A8_MAX_CLUSTER = 8   # the portable thread-block cluster


def w8a8_plan(m: int, k: int, f: int, n: int, bf: int) -> dict:
    """Kernel E's host-side plan for x [m, k] -> hidden [m, f] (re-quantized
    per row within blocks of bf columns) -> [m, n]: `cluster`, the blocks of
    fc1 that share one hidden block's row maxima (the largest divisor of
    bf / 128 that is at most W8A8_MAX_CLUSTER; the library checks the same
    rule), `tiles`, the 128-column tiles each of them owns (more than one:
    computed once for the maxima and once to quantize, `recompute`),
    `blocks`, the hidden blocks (a last one narrower than bf is the TPU
    wrapper's zero padding), `units`, fc1's (row tile, hidden block) work
    units, which one wave of clusters walks (the library sizes the wave to
    what the card holds at once; `w8a8_fc1_work`), fc2's grid, and the
    workspaces in bytes (xq, sx, hq, hs; ws: the post form's fp32
    output). A function of the shape alone; raises ValueError outside the
    kernel's envelope."""
    _cuda.require(m > 0 and k % 16 == 0 and f % 16 == 0 and n % 16 == 0
                  and bf > 0 and bf % W8A8_TILE == 0 and n <= 2048,
                  f"fused_mlp_w8a8: K, F, N must be multiples of 16, bf of "
                  f"{W8A8_TILE}, N <= 2048 (got {k}, {f}, {n}, bf {bf})")
    per = bf // W8A8_TILE
    cluster = max(c for c in range(1, W8A8_MAX_CLUSTER + 1) if per % c == 0)
    blocks = -(-f // bf)
    rows = -(-m // W8A8_TILE)
    return {"cluster": cluster, "tiles": per // cluster,
            "recompute": per > cluster, "blocks": blocks,
            "row_tiles": rows, "units": blocks * rows,
            "grid2": (-(-n // W8A8_TILE), rows),
            "xq_bytes": m * k, "sx_bytes": 4 * m, "hq_bytes": m * f,
            "hs_bytes": 4 * m * blocks, "ws_bytes": 4 * m * n}


def w8a8_fc1_work(plan: dict, bf: int, f: int, clusters: int,
                  bx: int) -> list:
    """The (row tile, hidden column) pairs that block bx of kernel E's
    persistent fc1 quantizes when the wave holds `clusters` clusters, as
    the kernel walks them: cluster bx // cluster takes the units u = id +
    k * clusters (row tile u // blocks, hidden block u % blocks), and rank
    bx % cluster owns `tiles` consecutive 128-column tiles of each, cut at
    f."""
    c, t = plan["cluster"], plan["tiles"]
    cid, rank = bx // c, bx % c
    work = []
    for u in range(cid, plan["units"], clusters):
        row, jb = divmod(u, plan["blocks"])
        for q in range(t):
            c0 = (jb * (bf // W8A8_TILE) + rank * t + q) * W8A8_TILE
            work.extend((row, col) for col in range(c0, min(c0 + W8A8_TILE,
                                                              f)))
    return work


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
    _cuda.require(not residual or n == k,
                  "fused_mlp_w8a8: residual needs N == K")
    _cuda.require(ln_mode in _LN_MODES
                  and (ln_mode is not None) == (ln_scale is not None),
                  "fused_mlp_w8a8: ln_mode needs ln_scale and ln_bias")
    xf = x.reshape(-1, k).contiguous()
    m = xf.shape[0]
    plan = w8a8_plan(m, k, f, n, bf)
    vec = [None if t is None else t.to(bf16).contiguous()
           for t in (b1, b2, ln_scale, ln_bias)]
    w1_q8, w2_q8 = w1_q8.contiguous(), w2_q8.contiguous()
    for name, t in (("x", xf), ("w1", w1_q8), ("w2", w2_q8)):
        _cuda.require(t.device == x.device and t.data_ptr() % 16 == 0,
                      f"fused_mlp_w8a8: {name} must be 16-byte aligned")
    scale1, scale2 = scale1.float().contiguous(), scale2.float().contiguous()
    dev = x.device
    xq, sx = torch.empty(m, k, device=dev, dtype=i8), torch.empty(m, device=dev)
    hq = torch.empty(m, f, device=dev, dtype=i8)
    hs = torch.empty(m, plan["blocks"], device=dev, dtype=f32)
    ws = (torch.empty(m, n, device=dev, dtype=f32) if ln_mode == "post"
          else None)
    out = torch.empty(m, n, device=dev, dtype=bf16)
    with _cuda.device_of(x):
        status = _cuda.library().emu_fused_mlp_w8a8_fwd(
            xf.data_ptr(), w1_q8.data_ptr(), scale1.data_ptr(),
            _cuda.ptr(vec[0]), w2_q8.data_ptr(), scale2.data_ptr(),
            _cuda.ptr(vec[1]), _cuda.ptr(vec[2]), _cuda.ptr(vec[3]),
            _LN_MODES[ln_mode], int(residual), float(eps), xq.data_ptr(),
            sx.data_ptr(), hq.data_ptr(), hs.data_ptr(), _cuda.ptr(ws),
            out.data_ptr(), m, k, f, n, bf, plan["cluster"],
            _cuda.stream(x))
    _cuda.check(status, "fused_mlp_w8a8")
    fused_mlp_w8a8.launches += 1
    return out.reshape(*lead, n)


fused_mlp_w8a8.launches = 0


def fused_dense_reference(x, w, b=None, ln_scale=None, ln_bias=None,
                          residual=None, *, ln_mode=None, eps: float = 1e-6):
    """Plain twin of `fused_dense`, step by step as the TPU kernel
    (`_make_dense_kernel`): the pre-LN input rounded to x's dtype before
    the product, the product summed in fp32, bias, post-LN and residual in
    fp32, one rounding at the end."""
    dt = x.dtype
    xn = x
    if ln_mode == "pre":
        xn = _layer_norm32(x.float(), ln_scale, ln_bias, eps).to(dt)
    y = _matmul_f32(xn, w.to(dt))
    if b is not None:
        y = y + b.float()
    if ln_mode == "post":
        y = _layer_norm32(y, ln_scale, ln_bias, eps)
    if residual is not None:
        y = y + residual.float()
    return y.to(dt)


_DENSE_PLANS = {"mma": 0, "tma": 1}
# Aligned denses of at most this many rows keep the mma.sync plan. At the
# UNets' 2-row time embedding (2 x 320 -> 1280) a call costs the host more
# than the card, and the mma.sync plan's call (one launch, no tensor maps)
# measured faster by CUDA events on an H100 than the TMA plan's (PERF.md
# section 6, kernel H).
DENSE_MMA_ROWS = 2


def fused_dense_plan(m: int, k: int, n: int, aligned: bool) -> str:
    """Kernel H's GEMM for an [m, k] x [k, n] product: "tma" (the TMA +
    wgmma GEMM) for K and N multiples of 8 with x and w 16-byte aligned
    (`aligned`) above DENSE_MMA_ROWS rows, "mma" (the mma.sync GEMM) for
    the rest."""
    if aligned and k % 8 == 0 and n % 8 == 0 and m > DENSE_MMA_ROWS:
        return "tma"
    return "mma"


def fused_dense(x, w, b=None, ln_scale=None, ln_bias=None, residual=None, *,
                ln_mode=None, eps: float = 1e-6) -> torch.Tensor:
    """x [..., K] → [..., N]: [LN →] x @ w + b [→ LN] [+ residual].

    w is [K, N]; b [N] may be None; ln_mode "pre" normalises x (ln_scale,
    ln_bias [K]), "post" the output row (ln_scale, ln_bias [N]);
    `residual` is an explicit [..., N] tensor added last, in fp32. Any M,
    K and N (ragged edges are masked in the kernel)."""
    if _cuda.on_cpu(x, "fused_dense"):
        return fused_dense_reference(x, w, b, ln_scale, ln_bias, residual,
                                     ln_mode=ln_mode, eps=eps)
    _cuda.refuse_grad("fused_dense", x, w, b, ln_scale, ln_bias, residual)
    lead, k = x.shape[:-1], x.shape[-1]
    n = w.shape[-1]
    bf = torch.bfloat16
    # the shape messages are built only on failure: this wrapper carries
    # every biased dense of the UNets, so its host time is their step's
    if ln_mode not in _LN_MODES:
        raise ValueError(f"fused_dense: unknown ln_mode {ln_mode!r}")
    _cuda.require(x.dtype == w.dtype == bf,
                  "fused_dense: x and w must be bfloat16")
    if w.shape != (k, n):
        raise ValueError(f"fused_dense: bad shapes x{tuple(x.shape)} "
                         f"w{tuple(w.shape)}")
    _cuda.require((ln_mode is not None) == (ln_scale is not None
                                            and ln_bias is not None),
                  "fused_dense: ln_mode needs ln_scale and ln_bias")
    xf = x.reshape(-1, k).contiguous()
    m = xf.shape[0]
    out = torch.empty(m, n, device=x.device, dtype=bf)
    if m == 0:
        return out.reshape(*lead, n)
    w = w.contiguous()
    if residual is not None:
        if residual.shape[-1] != n or residual.numel() != m * n:
            raise ValueError(f"fused_dense: residual {tuple(residual.shape)} "
                             f"must be [..., {n}] over {m} rows")
        residual = residual.to(bf).reshape(m, n).contiguous()
    # bias and LN vectors are read as they are (bf16, the models' own) and
    # widened in the kernel; other dtypes go to fp32 once here
    vecs = [t for t in (b, ln_scale, ln_bias) if t is not None]
    vec_bf16 = all(t.dtype == bf for t in vecs)
    b, ln_scale, ln_bias = (
        None if t is None else
        (t if vec_bf16 else t.float()).contiguous()
        for t in (b, ln_scale, ln_bias))
    xn = (torch.empty(m, k, device=x.device, dtype=bf)
          if ln_mode == "pre" else None)
    ws = (torch.empty(m, n, device=x.device, dtype=torch.float32)
          if ln_mode == "post" else None)
    # the pre form's GEMM reads its fresh (aligned) xn workspace
    plan = fused_dense_plan(m, k, n, w.data_ptr() % 16 == 0 and (
        xn is not None or xf.data_ptr() % 16 == 0))
    with _cuda.device_of(x):
        status = _cuda.library().emu_fused_dense_fwd(
            xf.data_ptr(), w.data_ptr(), _cuda.ptr(b), _cuda.ptr(ln_scale),
            _cuda.ptr(ln_bias), _cuda.ptr(residual), _cuda.ptr(xn),
            _cuda.ptr(ws), out.data_ptr(), m, k, n, _LN_MODES[ln_mode],
            int(vec_bf16), _DENSE_PLANS[plan], float(eps), _cuda.stream(x))
    _cuda.check(status, "fused_dense")
    fused_dense.launches += 1
    fused_dense.forms[ln_mode or "plain"] += 1
    fused_dense.plans[plan] += 1
    return out.reshape(*lead, n)


fused_dense.launches = 0
fused_dense.forms = {"plain": 0, "pre": 0, "post": 0}
fused_dense.plans = {"tma": 0, "mma": 0}
