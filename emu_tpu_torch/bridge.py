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
    """Layer i of a stacked subtree (views, no copies); of a `Stacked`
    subtree, its layer-i autograd leaves."""
    if isinstance(tree, Stacked):
        return tree.layers[i]
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


class Stacked(dict):
    """A trainable stacked subtree: maps names to the stacked tensors, as
    any subtree does, and keeps in `layers[i]` layer i's tree of views of
    them, each an autograd leaf of its own whose `.grad` is preset to the
    matching view of one stacked grad buffer. The backward then accumulates
    every layer's gradient in place; indexing the stacked tensor instead
    would make the backward of each `select` allocate a zero tensor the
    size of the whole stacked leaf."""

    def __init__(self, tree: dict, n: int):
        super().__init__(tree)
        self.layers = [_views(tree, i) for i in range(n)]


def _views(tree: dict, i: int) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _views(v, i)
        else:
            leaf = v[i]
            if v.grad is not None:
                leaf.requires_grad_()
                leaf.grad = v.grad[i]
            out[k] = leaf
    return out


STACKED_KEYS = ("layers", "blocks")


def trainable(tree: dict) -> dict:
    """The same tensors, ready for a gradient step: every floating leaf
    gets a preset zero `.grad`; subtrees under a key in STACKED_KEYS (the
    param tree's stacked layers: LLaMA and T5 "layers", ViT "blocks")
    become `Stacked`, whose per-layer views are the autograd leaves; every
    other floating leaf requires grad itself. The tensors are shared with
    `tree`, so an optimizer step updates them in place (the counterpart of
    the JAX trainer's donated buffers)."""
    def convert(node, in_stack):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                sub = convert(v, in_stack or k in STACKED_KEYS)
                if k in STACKED_KEYS and not in_stack:
                    sub = Stacked(sub, _depth(sub))
                out[k] = sub
            elif v.is_floating_point():
                leaf = v.detach()
                leaf.grad = torch.zeros_like(leaf)
                out[k] = leaf if in_stack else leaf.requires_grad_()
            else:
                out[k] = v
        return out
    return convert(tree, False)


def _depth(tree: dict) -> int:
    for v in tree.values():
        return _depth(v) if isinstance(v, dict) else v.shape[0]
    raise ValueError("empty stacked subtree")


def grad_leaves(tree: dict):
    """(tensor, grad buffer) of every leaf of a `trainable` tree that has
    one: the stacked tensors whole, the other leaves as they are."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from grad_leaves(v)
        elif v.grad is not None:
            yield v, v.grad


def zero_grads(tree: dict) -> None:
    """Zero every grad buffer of a `trainable` tree in place."""
    for _, g in grad_leaves(tree):
        g.zero_()


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
