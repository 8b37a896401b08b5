"""The param tree as an nn.Module, and the bridge from the JAX package.

The port keeps `emu_tpu`'s parameter tree as it is: nested dicts, layers
stacked on a leading dim, linear kernels [in, out]. `ParamTree` holds such a
tree as parameters named after their JAX paths (`visual.blocks.attn.qkv.
kernel` for `params["visual"]["blocks"]["attn"]["qkv"]["kernel"]`), so a
JAX tree with numpy leaves loads with one flatten plus
`load_state_dict(strict=True)`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A nested dict of tensors held as (frozen) parameters."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict view of the same tensors (no copies)."""
        out: Dict[str, Any] = dict(self._parameters)
        out.update({n: m.tree() for n, m in self._modules.items()})
        return out


def layer(tree: dict, i: int) -> dict:
    """Layer i of a stacked subtree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def flatten(tree: dict, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


QUANT_KERNELS = ("kernel_q8", "kernel_w8a8", "kernel_q4")


def leaf_dtype(path: str, leaf: torch.Tensor, siblings,
               dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The dtype a leaf takes when a tree is cast to `dtype`: integer leaves
    (quantized kernels) keep theirs, and the `scale`/`scale4` of a quantized
    dense stay fp32, as the JAX package holds them; a LayerNorm `scale` is
    a float leaf like any other."""
    if dtype is None or not leaf.is_floating_point():
        return None
    name = path.rsplit(".", 1)[-1]
    if name in ("scale", "scale4") and any(k in siblings
                                           for k in QUANT_KERNELS):
        return torch.float32
    return dtype


def cast_tree(tree: dict, device=None, dtype: Optional[torch.dtype] = None
              ) -> dict:
    """A nested dict of tensors moved to `device` and cast by `leaf_dtype`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = cast_tree(v, device, dtype)
        else:
            out[k] = v.to(device=device, dtype=leaf_dtype(k, v, tree, dtype))
    return out


def _tensor(leaf) -> torch.Tensor:
    """A numpy/jax leaf as a tensor; bfloat16 (numpy's ml_dtypes) by bits."""
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_state_dict(jax_tree: dict, device="cpu",
                  dtype: Optional[torch.dtype] = None
                  ) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy or jax array leaves) → {dotted path: tensor},
    float leaves cast to `dtype` by the rule of `leaf_dtype`."""
    flat = {k: _tensor(v) for k, v in flatten(jax_tree).items()}
    children: Dict[str, set] = {}
    for k in flat:
        parent, _, name = k.rpartition(".")
        children.setdefault(parent, set()).add(name)
    return {k: v.to(device=device, dtype=leaf_dtype(
                k, v, children[k.rpartition(".")[0]], dtype))
            for k, v in flat.items()}


def unflatten(flat: Dict[str, Any]) -> dict:
    """{dotted path: leaf} → the nested dict (inverse of `flatten`)."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def load_jax_params(module: nn.Module, jax_tree: dict, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Load a JAX param tree into a module built for the same tree (e.g.
    on the meta device); shapes and names must match exactly."""
    module.load_state_dict(to_state_dict(jax_tree, device, dtype),
                           strict=True, assign=True)
    return module
