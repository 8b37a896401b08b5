"""Kernel C: residual add + RMSNorm, forward and backward (`csrc/rmsnorm.cu`).

Replaces `emu_tpu/ops/fused_norm.py`: the forward `_norm_call` (behind
`add_rmsnorm` and `rms_norm_fused`): y = x + r in the activation dtype,
h = y * rsigma * w with the reduction and the scale multiply in fp32, and
rsigma = rsqrt(mean(y²) + eps) saved per row; and the backward
`_norm_bwd_call`, with g = dh * w (fp32):

    dx = g * rsigma - y * rsigma³ * mean(g * y) (+ dy, the residual's
         cotangent, in the add form), given to both x and r;
    dw = sum over rows of dh * y * rsigma.

Note the fp32 scale multiply: `ops.layers.rms_norm` (HF semantics) casts
back first. As in the JAX package (`fused_norm._eligible`), only 2-byte
activations take the kernels; fp32 activations take `layers.rms_norm`, the
package's XLA route. Unlike the TPU package, the LLaMA layers run the kernel
at every row count (8 decode rows as well as prefill slabs), not only from
256 rows up.

`rmsnorm_fwd` and `rmsnorm_bwd` are the wrappers: on a CPU tensor they run
their plain twins, on a CUDA tensor they launch the kernel or raise.
`add_rmsnorm` and `rms_norm_fused` take `torch.autograd.Function`s over them
where autograd records, and `rmsnorm_fwd` alone where it does not (every
serving and generation call): the forward's host path does only what the
launch needs.
"""

from __future__ import annotations

import functools

import torch

from emu_tpu_torch.ops import _cuda
from emu_tpu_torch.ops import layers as L


def rmsnorm_reference(w, x, r=None, eps: float = 1e-6):
    """Plain twin of `rmsnorm_fwd` → (y, h, rsigma [rows])."""
    y = x if r is None else x + r
    yf = y.float()
    rsig = torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    h = (yf * rsig * w.float()).to(x.dtype)
    return y, h, rsig.reshape(-1)


# Kernel C's row kernels (csrc/rmsnorm.cu): threads a block, the most
# 16-byte vectors a thread holds of a row (VMAX), the backward ring's depth
# in steps (BWD_STAGES there: 3 measured 4% slower than 2 at 2048 x 5120,
# PERF.md, PR 12)
NORM_THREADS, NORM_VMAX, NORM_STAGES = 256, 8, 2


@functools.lru_cache(maxsize=256)
def row_tpr(w: int, aligned: bool = True) -> int:
    """Threads a row of kernel C's row kernels, forward and backward alike,
    for rows of width w: the fewest powers of two from 32 that hold the row
    in NORM_VMAX 16-byte vectors a thread; 0 (the scalar kernels) where w %
    8 != 0, w > 8 * NORM_VMAX * NORM_THREADS or an operand is not 16-byte
    aligned. The kernels refuse a plan they cannot hold."""
    if w % 8 or w > 8 * NORM_VMAX * NORM_THREADS or not aligned:
        return 0
    tpr = 32
    while tpr * NORM_VMAX * 8 < w:
        tpr *= 2
    return tpr


def rmsnorm_fwd(w, x, r=None, eps: float = 1e-6):
    """(y, h, rsigma) for x/r [..., W] and w [W]; y is x when r is None.
    w is read in its stored dtype (bf16 or fp32; another float dtype is
    widened to fp32) and used in fp32, as the TPU kernel reads it."""
    if _cuda.on_cpu(x, "rmsnorm"):
        return rmsnorm_reference(w, x, r, eps)
    _cuda.refuse_grad("rmsnorm", w, x, r)
    wd = x.shape[-1]
    bf = torch.bfloat16
    if not (x.dtype == bf and (r is None or r.dtype == bf)):
        raise ValueError("rmsnorm: x and r must be bfloat16")
    if not (w.shape == (wd,) and (r is None or r.shape == x.shape)
            and w.device == x.device):
        raise ValueError(f"rmsnorm: bad shapes or devices x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} on {w.device}")
    if w.dtype not in (bf, torch.float32):
        w = w.float()
    x = x.contiguous()
    r = None if r is None else r.contiguous()
    w = w.contiguous()
    y = x if r is None else torch.empty_like(x)
    h = torch.empty_like(x)
    m = x.numel() // wd
    rsig = torch.empty(m, device=x.device, dtype=torch.float32)
    # y and h are fresh: the allocator aligns them
    tpr = row_tpr(wd, all(t.data_ptr() % 16 == 0 for t in (x, r, w)
                          if t is not None))
    with _cuda.device_of(x):
        status = _cuda.library().emu_add_rmsnorm_fwd(
            x.data_ptr(), _cuda.ptr(r), w.data_ptr(),
            None if r is None else y.data_ptr(), h.data_ptr(),
            rsig.data_ptr(), m, wd, int(w.dtype == torch.float32), tpr,
            float(eps), _cuda.stream(x))
    _cuda.check(status, "rmsnorm")
    rmsnorm_fwd.launches += 1
    return y, h, rsig


rmsnorm_fwd.launches = 0


def rmsnorm_bwd_reference(y, w, rsigma, dh, dy_ext=None):
    """Plain twin of `rmsnorm_bwd`: the JAX VJP's math (fused_norm.py:17-20)
    in fp32 → (dx in y's dtype, dw in w's dtype)."""
    wd = y.shape[-1]
    yf = y.reshape(-1, wd).float()
    dhf = dh.reshape(-1, wd).float()
    rs = rsigma.reshape(-1, 1)
    g = dhf * w.float()
    dot = (g * yf).sum(-1, keepdim=True) / wd
    dx = g * rs - yf * (rs * rs * rs) * dot
    if dy_ext is not None:
        dx = dx + dy_ext.reshape(-1, wd).float()
    dw = (dhf * yf * rs).sum(0)
    return dx.to(y.dtype).reshape(y.shape), dw.to(w.dtype)


@functools.lru_cache(maxsize=256)
def norm_bwd_plan(m: int, w: int, sms: int = _cuda.H100_SMS,
                  aligned: bool = True) -> dict:
    """How kernel C's backward runs over m rows of width w: a function of
    the shape (and of the operands' 16-byte alignment) alone.

    - kernel: "rows" where the forward takes its row kernel (`row_tpr`
      nonzero), else "any" (the scalar kernel: one row at a time, two
      passes);
    - tpr: threads a row, the forward's (`row_tpr`; 0 for "any");
      rows_step = NORM_THREADS // tpr rows a block takes at once;
    - smem: the bytes of the ring of NORM_STAGES steps of y, dh and dy_ext
      rows, and 128 to start it on a 128-byte line (one block's shared
      memory holds two steps of the widest row);
    - grid: at most one block an SM, each a contiguous run of
      rows_per_block rows (whole steps), none empty; parts: the fp32
      partial rows of dw, one a block, summed in block order."""
    tpr = row_tpr(w, aligned)
    if not tpr:
        per_block = max(1, -(-m // 256))
        grid = -(-m // per_block)
        return {"kernel": "any", "tpr": 0, "rows_step": 1, "smem": 4 * w,
                "rows_per_block": per_block, "grid": grid, "parts": grid}
    step = NORM_THREADS // tpr
    steps = -(-m // step)
    per_block = -(-steps // min(steps, sms)) if steps else 0
    grid = -(-steps // per_block) if steps else 0
    return {"kernel": "rows", "tpr": tpr, "rows_step": step,
            "smem": NORM_STAGES * 3 * step * w * 2 + 128,
            "rows_per_block": per_block * step, "grid": grid, "parts": grid}


def rmsnorm_bwd(y, w, rsigma, dh, dy_ext=None):
    """(dx, dw) of h = rmsnorm(w, y) for the cotangents dh of h and, in the
    add form, dy_ext of y; y [..., W] is the forward's y (x without the
    add), rsigma its [rows] fp32 output. w is read in its stored dtype (bf16
    or fp32; another float dtype is widened to fp32), as the forward reads
    it. dw is summed from per-block fp32 partials in a fixed order (the same
    bits on every run) and rounded once to w's dtype."""
    if _cuda.on_cpu(y, "rmsnorm_bwd"):
        return rmsnorm_bwd_reference(y, w, rsigma, dh, dy_ext)
    _cuda.refuse_grad("rmsnorm_bwd", y, w, dh, dy_ext)
    wd = y.shape[-1]
    bf = torch.bfloat16
    _cuda.require(y.dtype == dh.dtype == bf
                  and (dy_ext is None or dy_ext.dtype == bf),
                  "rmsnorm_bwd: y, dh and dy_ext must be bfloat16")
    _cuda.require(w.shape == (wd,) and dh.shape == y.shape
                  and (dy_ext is None or dy_ext.shape == y.shape),
                  f"rmsnorm_bwd: bad shapes y{tuple(y.shape)} "
                  f"dh{tuple(dh.shape)} w{tuple(w.shape)}")
    yf = y.reshape(-1, wd).contiguous()
    m = yf.shape[0]
    _cuda.require(rsigma.numel() == m and rsigma.dtype == torch.float32,
                  "rmsnorm_bwd: rsigma must be fp32 [rows]")
    wk = (w if w.dtype in (bf, torch.float32) else w.float()).contiguous()
    dhf = dh.reshape(-1, wd).contiguous()
    dyf = None if dy_ext is None else dy_ext.reshape(-1, wd).contiguous()
    dx = torch.empty_like(yf)
    aligned = all(t.data_ptr() % 16 == 0 for t in (yf, wk, dhf, dyf, dx)
                  if t is not None)
    plan = norm_bwd_plan(m, wd, _cuda.sm_count(y.device), aligned)
    dw_part = torch.empty(plan["parts"], wd, device=y.device,
                          dtype=torch.float32)
    dw = torch.empty(wd, device=y.device, dtype=wk.dtype)
    with _cuda.device_of(y):
        status = _cuda.library().emu_add_rmsnorm_bwd(
            yf.data_ptr(), wk.data_ptr(), rsigma.contiguous().data_ptr(),
            dhf.data_ptr(), _cuda.ptr(dyf), dx.data_ptr(), dw_part.data_ptr(),
            dw.data_ptr(), m, wd, int(wk.dtype == torch.float32), plan["tpr"],
            plan["rows_per_block"], plan["grid"], _cuda.stream(y))
    _cuda.check(status, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx.reshape(y.shape), dw.to(w.dtype)   # a copy only for a widened w


rmsnorm_bwd.launches = 0


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, r, eps):
        y, h, rsig = rmsnorm_fwd(w, x, r, eps)
        ctx.save_for_backward(w, y, rsig)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        w, y, rsig = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(y, w, rsig, dh, dy)
        return dw, dx, dx, None


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, eps):
        _, h, rsig = rmsnorm_fwd(w, x, None, eps)
        ctx.save_for_backward(w, x, rsig)
        return h

    @staticmethod
    def backward(ctx, dh):
        w, x, rsig = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, rsig, dh)
        return dw, dx, None


def add_rmsnorm(w, x, r, eps: float = 1e-6):
    """(x + r, rmsnorm(w, x + r)): the residual stream and the normed
    branch input, as `emu_tpu.ops.fused_norm.add_rmsnorm`; fp32
    activations take the plain composition. The autograd Function is taken
    only where autograd records (grad enabled and an input requiring grad):
    serving and generation call the forward wrapper directly."""
    if not _cuda.kernel_dtype(x):
        y = x + r
        return y, L.rms_norm(w, y, eps)
    if _cuda.records(w, x, r):
        return _AddRMSNorm.apply(w, x, r, eps)
    y, h, _ = rmsnorm_fwd(w, x, r, eps)
    return y, h


def rms_norm_fused(w, x, eps: float = 1e-6):
    """rmsnorm(w, x) through the same kernel (no residual add); fp32
    activations take `layers.rms_norm`; the Function only where autograd
    records, as in `add_rmsnorm`."""
    if not _cuda.kernel_dtype(x):
        return L.rms_norm(w, x, eps)
    if _cuda.records(w, x):
        return _RMSNorm.apply(w, x, eps)
    return rmsnorm_fwd(w, x, None, eps)[1]
