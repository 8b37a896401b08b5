"""Emu1 training, as `emu_tpu/training.py`: a train step over
`emu1.forward_loss` (the reference's masked cross-entropy: padding, [IMG],
[/IMG] and <image> targets ignored) and a minimal `Trainer` around it.

The loss runs the ViT (in the images' dtype: fp32 images take the plain
route, as they take XLA in the JAX package), the Causal Former and the LLaMA
decoder (bf16: kernels A and C forward, their backward kernels in the
backward pass), then the chunked, checkpointed lm_head cross-entropy.
Parameters live in a `bridge.trainable` tree: grad buffers preset, stacked
layers as per-layer autograd leaves, updated in place by the optimizer under
`torch.no_grad()` (the counterpart of the JAX step's donated buffers).

Not ported yet: the mesh (`mesh=`, ROADMAP Queue 1 item 16) and periodic
checkpoints (`checkpoint_dir=`, item 11); both raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from emu_tpu_torch import bridge
from emu_tpu_torch.models import causal_former, emu1, vit
from emu_tpu_torch.ops import layers as L


def emu1_loss(params: dict, cfg, images, token_ids, attention_mask,
              special_ids: Tuple[int, int, int, int], remat=False):
    """Visual encode → Causal Former → masked CE (the JAX step's loss_fn);
    the ViT checkpoints each block for any truthy remat."""
    feats = vit.forward_features(params["visual"], cfg.vision, images,
                                 remat=bool(remat))
    feats = L.layer_norm(params["ln_visual"], feats, eps=1e-6)
    vis = causal_former.forward(params["cformer"], cfg.t5, feats)
    return emu1.forward_loss(params, cfg, token_ids, attention_mask,
                             vis.reshape(-1, vis.shape[-1]), special_ids,
                             remat=remat)


def make_emu1_train_step(cfg, optimizer_factory: Callable,
                         special_ids: Tuple[int, int, int, int],
                         remat=False) -> Callable:
    """step(params, opt_state, images, token_ids, attention_mask) →
    (params, opt_state, loss), as the JAX package's jitted step.

    params: a `bridge.trainable` tree, updated in place (the same object
    comes back); opt_state: the optimizer, `optimizer_factory` applied to
    the tree's grad leaves when None is passed (the JAX `tx.init`); loss:
    a 0-dim fp32 tensor on the params' device. remat: the decoder's remat
    policy (False/True/"dots"/"named"/"dots+attn"); the ViT checkpoints
    each block for any truthy value."""

    def step(params, opt_state, images, token_ids, attention_mask):
        if opt_state is None:
            opt_state = optimizer_factory(
                [t for t, _ in bridge.grad_leaves(params)])
        bridge.zero_grads(params)
        loss = emu1_loss(params, cfg, images, token_ids, attention_mask,
                         special_ids, remat)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return step


class Trainer:
    """A minimal trainer, as the JAX package's `Trainer`.

    Example:
        trainer = Trainer(cfg, params, optim.fused_adafactor(1e-2),
                          special_ids, remat="named")
        for batch in loader:
            loss = trainer.step(**batch)

    params: a param tree (nested dict of tensors, e.g. `emu1.init` or a
    bridged JAX tree); it is moved to `device` (the card unless the caller
    asks for the CPU) and trained in place."""

    def __init__(self, cfg, params: dict, optimizer_factory: Callable,
                 special_ids, mesh=None, remat=False,
                 checkpoint_dir: Optional[str] = None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharding is not ported yet (ROADMAP "
                "Queue 1 item 16)")
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "Trainer(checkpoint_dir=...): checkpoints are not ported yet "
                "(ROADMAP Queue 1 item 11)")
        self.device = torch.device(device)
        self.params = bridge.trainable(bridge.cast_tree(params, self.device))
        self.opt_state = None          # the first step builds it
        self._step_fn = make_emu1_train_step(cfg, optimizer_factory,
                                             special_ids, remat)

    def step(self, images, token_ids, attention_mask) -> float:
        images, token_ids, attention_mask = (
            torch.as_tensor(t).to(self.device)
            for t in (images, token_ids, attention_mask))
        self.params, self.opt_state, loss = self._step_fn(
            self.params, self.opt_state, images, token_ids, attention_mask)
        return float(loss)
