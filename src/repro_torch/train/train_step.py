"""Train-step factory: loss -> grads (optionally microbatched) -> AdamW."""
from __future__ import annotations

import torch

from ..models.api import Model
from ..models.spec import mesh_scope, tree_leaves, tree_unflatten
from .optimizer import AdamWConfig, adamw_update


def loss_and_grads(model: Model, params, batch, remat: str = "dots_no_batch",
                   sh=None):
    """(loss, grads): the loss of ``batch`` at ``params`` and its gradient
    against every leaf, a tree of ``params``' structure and dtypes (zeros
    where the loss does not depend on a leaf, as ``jax.grad`` gives).
    ``sh`` is the activation-sharding hook (None: the identity)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad(), mesh_scope(sh):
        loss = model.train_loss(tree_unflatten(params, leaves), batch, remat,
                                sh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    remat: str = "dots_no_batch", microbatches: int = 1,
                    sh=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss),
    the loss a 0-d tensor.

    ``microbatches > 1`` splits the batch's leading axis and accumulates
    float32 gradients of each slice divided by ``microbatches``, a leaf at
    a time, each slice's gradient leaf dropped once added; the loss is the
    mean of the slices' (the JAX scan's arithmetic)."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(model, params, batch, remat, sh)
        else:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(x) for k, x in batch.items()}
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            losses = []
            for i in range(microbatches):
                loss_i, g = loss_and_grads(
                    model, params, {k: x[i] for k, x in mb.items()}, remat,
                    sh)
                g = tree_leaves(g)
                for j in range(len(g)):  # a leaf at a time: one transient
                    acc[j] = acc[j] + g[j].float() / microbatches
                    g[j] = None
                losses.append(loss_i)
            grads = tree_unflatten(params, acc)
            loss = torch.stack(losses).mean()
        new_params, new_opt = adamw_update(grads, opt_state, params, opt_cfg)
        return new_params, new_opt, loss

    return step
