"""The training step: loss → gradients (backward through remat) →
optional gradient compression → AdamW (the reference's
``repro.train.train_step``).

``make_train_step`` closes over the model and the optimizer config and
returns ``train_step(params, opt_state, batch) → (params, opt_state,
metrics)``, ``metrics`` holding ``loss``, ``lr`` and ``grad_norm`` as 0-d
float32 tensors on the device: the step reads nothing back to the host.
The gradients come from ``torch.autograd.grad`` on the parameter leaves
in ``jax.tree_util`` order; each has its parameter's type, as the
reference's.  A leaf the loss does not read (the vlm family's embedding
table, when the batch brings ``embeds``) gets a zero gradient, as
``jax.grad`` gives it, so AdamW moves it by its weight decay alone.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..dist.compression import compress_decompress
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import AdamWCfg, AdamWState, adamw_update


def value_and_grad(model, params, batch, remat: bool = True):
    """(loss, gradient tree) of ``model.loss_fn`` at ``params``."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = model.loss_fn(ps, batch, remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(ps),
                                    allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model, opt_cfg: AdamWCfg, compress_grads: bool = False,
                    remat: bool = True, donate: bool = False) -> Callable:
    """``donate``: each step writes the new parameters and moments into
    the storage of the ones it is given (``adamw_update(donate=True)``),
    which the caller must not read again."""
    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = value_and_grad(model, params, batch, remat)
        if compress_grads:
            grads = tree_map(compress_decompress, grads)
        new_params, new_state, stats = adamw_update(
            params, grads, opt_state, opt_cfg, donate=donate)
        return new_params, new_state, {"loss": loss, **stats}

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss_fn(params, batch, remat=False)

    return eval_step
