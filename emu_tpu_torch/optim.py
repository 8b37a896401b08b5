"""`fused_adafactor`: the JAX package's optimizer (`emu_tpu/optim.py`) as a
`torch.optim.Optimizer`.

The update rule is `optax.adafactor`'s defaults (Shazeer & Stern 2018):
factored second moments over a leaf's two largest dims when both are at
least `min_dim_size_to_factor`, decay_t = 1 - (step + 1)^-decay_rate, the
moments kept in the parameter's dtype (the JAX rule rounds them each step
and computes the factors from the rounded values), update clipping by
max(1, rms(u) / threshold), the parameter-scale multiplier
max(rms(p), min_scale), and the sign folded into the step. It is plain
torch: XLA fuses it without a kernel in the JAX package.

A stacked leaf [L, m, n] (the param tree's layers) whose factored dims are
its last two is processed one layer slice at a time, so its fp32
temporaries are one layer's size (a 13B gate kernel [40, 5120, 13824] in
fp32 would be 11 GB at once). The row and column statistics are per slice
already; the clip's mean(u²) and the parameter scale's mean(p²) are over the
whole leaf, so a first pass accumulates them over the slices and a second
applies the update: the result is the JAX rule on the whole leaf.

Parameters are updated in place. `zero_grad` zeroes the grad buffers in
place (`bridge.zero_grads`) and never drops them (a `bridge.trainable` tree
presets them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from emu_tpu_torch import bridge


def factored_dims(shape, min_dim_size_to_factor: int):
    """The two largest axes (second largest, largest) to factor over, or
    None (as the JAX package and optax choose them)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class FusedAdafactor(torch.optim.Optimizer):
    def __init__(self, params, lr: float, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0,
                 eps: float = 1e-30, min_scale: float = 1e-3):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, eps=eps,
            min_scale=min_scale))

    def zero_grad(self, set_to_none: bool = False) -> None:
        bridge.zero_grads({i: p for i, p in enumerate(
            p for group in self.param_groups for p in group["params"])})

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, group)
        return loss

    def _update(self, p, g, hp) -> None:
        dims = factored_dims(tuple(p.shape), hp["min_dim_size_to_factor"])
        state = self.state[p]
        if not state:
            state["count"] = 0
            if dims is not None:
                d1, d0 = dims
                shape = list(p.shape)
                state["v_row"] = p.new_zeros(shape[:d0] + shape[d0 + 1:])
                state["v_col"] = p.new_zeros(shape[:d1] + shape[d1 + 1:])
            else:
                state["v"] = torch.zeros_like(p)
        step = state["count"] - hp["decay_offset"]
        # in fp32, as the JAX rule computes it
        decay = 1.0 - (torch.tensor(step + 1.0, dtype=torch.float32)
                       ** -hp["decay_rate"])
        decay = float(decay)
        state["count"] += 1
        # slice a stacked leaf along dim 0 when both factored dims are
        # inside each slice; otherwise the whole leaf is one slice
        if dims is not None and p.dim() >= 3 and 0 not in dims:
            slices = [slice(i, i + 1) for i in range(p.shape[0])]
        else:
            slices = [slice(None)]

        def factors(sl):
            """The update's multipliers of g from the rounded moments,
            squeezed to the moments' shapes: (row factor over d1, column
            factor over d0) or (1/sqrt(v),)."""
            if dims is None:
                return (state["v"][sl].float().pow(-0.5),)
            d1, d0 = dims
            vr32 = state["v_row"][sl].float()
            red = d1 - 1 if d1 > d0 else d1
            rf = (vr32 / vr32.mean(red, keepdim=True)).pow(-0.5)
            return rf, state["v_col"][sl].float().pow(-0.5)

        # pass 1: the moments, and the whole leaf's sums of u² and p²
        u_sq = p_sq = torch.zeros((), device=p.device)
        for sl in slices:
            gsq = g[sl].to(torch.float32, copy=True).square_()
            if dims is None:
                v = state["v"][sl]
                v.copy_(decay * v.float() + (1.0 - decay) * (gsq + hp["eps"]))
                u_sq = u_sq + (gsq * factors(sl)[0].square()).sum()
            else:
                d1, d0 = dims
                for name, axis in (("v_row", d0), ("v_col", d1)):
                    v = state[name][sl]
                    v.copy_(decay * v.float()
                            + (1.0 - decay) * (gsq.mean(axis) + hp["eps"]))
                rf, cf = factors(sl)
                # sum(g² rf² cf²) as a product: sum over d1 of rf² times
                # (g² summed over d0 against cf²), with no full-size temp
                rows = torch.matmul(gsq.movedim((d1, d0), (-2, -1)),
                                    cf.square().unsqueeze(-1)).squeeze(-1)
                u_sq = u_sq + (rows * rf.square()).sum()
            del gsq
            if hp["multiply_by_parameter_scale"]:
                p_sq = p_sq + torch.linalg.vector_norm(
                    p[sl], dtype=torch.float32).square()
        n = p.numel()
        scale = torch.full((), hp["lr"], device=p.device)
        if hp["clipping_threshold"] is not None:
            scale = scale / torch.clamp(
                torch.sqrt(u_sq / n) / hp["clipping_threshold"], min=1.0)
        if hp["multiply_by_parameter_scale"]:
            scale = scale * torch.clamp(torch.sqrt(p_sq / n),
                                        min=hp["min_scale"])
        # pass 2: p += -scale * g * rf * cf, rounded to the param dtype first
        for sl in slices:
            if dims is None:
                u = g[sl] * (factors(sl)[0] * -scale)
            else:
                d1, d0 = dims
                rf, cf = factors(sl)
                u = g[sl] * rf.unsqueeze(d0)
                u.mul_(cf.unsqueeze(d1) * -scale)
            p[sl].add_(u.to(p.dtype))


def fused_adafactor(learning_rate: float, **kwargs):
    """The optimizer factory of `training.Trainer`: `fused_adafactor(lr)`
    (params) → FusedAdafactor, as `emu_tpu.optim.fused_adafactor(lr)` is
    the JAX trainer's GradientTransformation."""
    def make(params):
        return FusedAdafactor(params, learning_rate, **kwargs)
    return make
