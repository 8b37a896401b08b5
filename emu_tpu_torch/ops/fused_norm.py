"""Kernel C: residual add + RMSNorm forward (`csrc/rmsnorm.cu`).

Replaces the forward of `emu_tpu/ops/fused_norm.py` (`_norm_call`, behind
`add_rmsnorm` and `rms_norm_fused`): y = x + r in the activation dtype,
h = y * rsigma * w with the reduction and the scale multiply in fp32, and
rsigma = rsqrt(mean(y²) + eps) saved per row for a later backward. Note the
fp32 scale multiply: `ops.layers.rms_norm` (HF semantics) casts back first.

Unlike the TPU package, the LLaMA layers run this kernel at every row
count (8 decode rows as well as prefill slabs), not only from 256 rows up.

`rmsnorm_fwd` is the wrapper: on a CPU tensor it runs `rmsnorm_reference`,
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from emu_tpu_torch.ops import _cuda


def rmsnorm_reference(w, x, r=None, eps: float = 1e-6):
    """Plain twin of `rmsnorm_fwd` → (y, h, rsigma [rows])."""
    y = x if r is None else x + r
    yf = y.float()
    rsig = torch.rsqrt(yf.square().mean(-1, keepdim=True) + eps)
    h = (yf * rsig * w.float()).to(x.dtype)
    return y, h, rsig.reshape(-1)


def rmsnorm_fwd(w, x, r=None, eps: float = 1e-6):
    """(y, h, rsigma) for x/r [..., W] and w [W]; y is x when r is None."""
    if _cuda.on_cpu(x, "rmsnorm"):
        return rmsnorm_reference(w, x, r, eps)
    wd = x.shape[-1]
    bf = torch.bfloat16
    _cuda.require(x.dtype == bf and (r is None or r.dtype == bf),
                  "rmsnorm: x and r must be bfloat16")
    _cuda.require(w.shape == (wd,) and (r is None or r.shape == x.shape),
                  f"rmsnorm: bad shapes x{tuple(x.shape)} w{tuple(w.shape)}")
    xf = x.reshape(-1, wd).contiguous()
    rf = None if r is None else r.reshape(-1, wd).contiguous()
    w = w.to(bf).contiguous()
    m = xf.shape[0]
    y = xf if r is None else torch.empty_like(xf)
    h = torch.empty_like(xf)
    rsig = torch.empty(m, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        status = _cuda.library().emu_add_rmsnorm_fwd(
            xf.data_ptr(), _cuda.ptr(rf), w.data_ptr(),
            None if r is None else y.data_ptr(), h.data_ptr(),
            rsig.data_ptr(), m, wd, float(eps), _cuda.stream(x))
    _cuda.check(status, "rmsnorm")
    rmsnorm_fwd.launches += 1
    return y.reshape(x.shape), h.reshape(x.shape), rsig


rmsnorm_fwd.launches = 0


def add_rmsnorm(w, x, r, eps: float = 1e-6):
    """(x + r, rmsnorm(w, x + r)): the residual stream and the normed
    branch input, as `emu_tpu.ops.fused_norm.add_rmsnorm`."""
    y, h, _ = rmsnorm_fwd(w, x, r, eps)
    return y, h


def rms_norm_fused(w, x, eps: float = 1e-6):
    """rmsnorm(w, x) through the same kernel (no residual add)."""
    return rmsnorm_fwd(w, x, None, eps)[1]
