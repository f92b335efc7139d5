"""Functional optimizers (SGD / momentum / AdamW), as
``repro.optim.optimizers``, on trees of tensors (``repro_torch.tree``).

``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``apply_updates`` adds them.  AdamW keeps float32 moments
whatever the parameter dtype, and its state is the reference's
``AdamState(mu, nu, count)`` with ``count`` an int32 0-dim tensor, so a
checkpoint's keypaths (``.mu['embed']``, ``.count``) are the reference's.
The arithmetic is the reference's, operation for operation, in float32.
Callers run these outside autograd (``torch.no_grad``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u.to(p.dtype)) if u is not None else p,
                    params, updates)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)

    def update(grads, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                         state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=leaf.device))

    def update(grads, state, params):
        count = state.count + 1
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        # b ** count in float32, as the reference's weakly typed base
        t = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full((), b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.full((), b2, device=t.device), t)

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return -lr * step

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)), norm): the
    squares summed over the leaves in the reference's flattening order."""
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
