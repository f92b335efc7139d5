"""train_step / prefill_step / serve_step builders, as
``repro.launch.steps``.

``train_step`` is one FedSGD communication round over a client cohort:
the batch carries per-example ``loss_weights`` = alpha_i * m_i
(participation mask sampled from the paper's a*), so the gradient of the
weighted loss *is* the server aggregation of eq. (4).  AdamW state is
float32; the loss is taken on ``cast_bf16(params)``, where the products
run in float32 on the weights' bfloat16 values, as the reference's jax
promotion makes them (``models.layers.dot``).

``serve_step`` is one decode step against a KV cache; ``prefill_step`` is
one full forward pass.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.zoo import lm_loss
from repro_torch.optim.optimizers import adamw, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map


def cast_bf16(tree):
    """Every float32 leaf as bfloat16 (differentiable: the gradient
    returns to float32 through the cast, rounded to bfloat16 on the way,
    as jax's is)."""
    return tree_map(lambda p: p.to(torch.bfloat16)
                    if (isinstance(p, torch.Tensor) and p.dtype == torch.float32)
                    else p, tree)


def value_and_grad(loss_fn: Callable, params):
    """((loss, aux), grads) of ``loss_fn(params) -> (loss, aux)``, grads a
    tree of ``params``' structure (zeros for a leaf the loss does not
    reach, as jax gives), as ``jax.value_and_grad(..., has_aux=True)``."""
    leaves = {id(p): p.detach().requires_grad_(True) for p in tree_leaves(params)}
    live = tree_map(lambda p: leaves[id(p)], params)
    loss, aux = loss_fn(live)
    order = tree_leaves(live)
    grads = torch.autograd.grad(loss, order, allow_unused=True,
                                materialize_grads=True)
    by_id = {id(p): g for p, g in zip(order, grads)}
    aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, aux)
    return (loss.detach(), aux), tree_map(lambda p: by_id[id(p)], live)


def make_train_step(cfg: ArchConfig, lr: float = 1e-4,
                    q_chunk: int = 1024, remat="full",
                    clip_norm: float = 1.0) -> Callable:
    opt = adamw(lr)

    def train_step(params, opt_state, batch):
        def loss_fn(p):
            return lm_loss(cfg, cast_bf16(p), batch, q_chunk=q_chunk, remat=remat)

        (loss, parts), grads = value_and_grad(loss_fn, params)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        metrics = dict(parts, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ArchConfig, q_chunk: int = 1024) -> Callable:
    def prefill_step(params, batch):
        logits, _ = T.forward(cfg, params, batch, q_chunk=q_chunk, remat=False)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, batch):
        return T.decode_step(cfg, params, cache, batch["tokens"], batch["pos"])

    return serve_step
