"""Seeded weights, made on the card by the benchmark.

Every tensor of a model's state dict is drawn from its own generator,
seeded from the run's seed and the tensor's name, so any one tensor can be
made again alone: the program receives them through a mapping that draws
each on first read (and forgets it), as a checkpoint reader hands over
tensors one at a time, and the reference draws the same tensors again,
layer by layer, once the program is gone.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, Tuple

import torch

# name -> (shape, kind); kind "normal:<std>", "ones:<std>" (1 + noise)
Spec = Dict[str, Tuple[tuple, str]]


def key_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def draw(seed: int, name: str, shape: tuple, kind: str, device,
         dtype=torch.bfloat16) -> torch.Tensor:
    """The tensor `name` of the run `seed`: N(0, std^2) ("normal:std") or
    1 + N(0, std^2) ("ones:std"), drawn in fp32 on `device`, in `dtype`."""
    g = torch.Generator(device=device).manual_seed(key_seed(seed, name))
    form, std = kind.split(":")
    t = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    t.mul_(float(std))
    if form == "ones":
        t.add_(1.0)
    elif form != "normal":
        raise ValueError(f"unknown init {kind!r} of {name}")
    return t.to(dtype)


class SeededStateDict(Mapping):
    """A read-only state dict whose tensors are drawn when read."""

    def __init__(self, spec: Spec, seed: int, device,
                 dtype=torch.bfloat16):
        self.spec, self.seed = spec, int(seed)
        self.device, self.dtype = torch.device(device), dtype

    def __getitem__(self, name: str) -> torch.Tensor:
        shape, kind = self.spec[name]
        return draw(self.seed, name, shape, kind, self.device, self.dtype)

    def __iter__(self):
        return iter(self.spec)

    def __len__(self) -> int:
        return len(self.spec)

    def __contains__(self, name) -> bool:
        return name in self.spec


def linear(spec: Spec, name: str, n_in: int, n_out: int, bias: bool,
           gain: float = 1.0) -> None:
    """A torch Linear's entries: weight [out, in] with std gain /
    sqrt(in), so every product keeps its input's scale, and bias [out]
    with std 0.02."""
    spec[f"{name}.weight"] = ((n_out, n_in), f"normal:{gain / n_in ** 0.5}")
    if bias:
        spec[f"{name}.bias"] = ((n_out,), "normal:0.02")


def layer_norm(spec: Spec, name: str, width: int) -> None:
    spec[f"{name}.weight"] = ((width,), "ones:0.05")
    spec[f"{name}.bias"] = ((width,), "normal:0.02")
