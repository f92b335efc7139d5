"""Wrappers for the masked_aggregate kernel: the eq.-4 server sum.

``masked_aggregate_batched`` takes g [T, N, D] and coef [T, N]; for CPU
tensors it runs the plain version of ``ref.py``, for CUDA tensors it
launches the kernel of ``csrc/masked_aggregate.cu`` on the current
stream, or raises.  ``masked_aggregate`` and ``masked_aggregate_pytree``
(the FL engines' ``aggregate_fn``) reshape client stacks for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_lib import LAUNCHES, check_operands, launch
from repro_torch.kernels.masked_aggregate.ref import masked_aggregate_ref
from repro_torch.tree import tree_map


def masked_aggregate_batched(gstack: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """g [T, N, D], coef [T, N] -> [T, D] float32."""
    if gstack.ndim != 3 or tuple(coef.shape) != tuple(gstack.shape[:2]):
        raise ValueError(f"expected g [T, N, D] and coef [T, N], got "
                         f"{tuple(gstack.shape)} and {tuple(coef.shape)}")
    if gstack.device.type == "cpu":
        return masked_aggregate_ref(gstack, coef)
    check_operands(gstack, coef)
    t, n, d = gstack.shape
    out = torch.empty((t, d), dtype=torch.float32, device=gstack.device)
    launch("repro_masked_aggregate", gstack.data_ptr(), coef.data_ptr(),
           out.data_ptr(), t, n, d)
    LAUNCHES["masked_aggregate"] += 1
    return out


def masked_aggregate(gstack: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Reduce the client axis: gstack [N, ...] with coef [N] -> [...], or,
    with a leading trajectory axis, gstack [T, N, ...] with coef [T, N]
    -> [T, ...]."""
    batched = coef.ndim == 2
    if not batched:
        gstack, coef = gstack[None], coef[None]
    t, n = coef.shape
    flat = gstack.reshape(t, n, -1).to(torch.float32).contiguous()
    out = masked_aggregate_batched(flat, coef.to(torch.float32).contiguous())
    out = out.reshape((t,) + tuple(gstack.shape[2:]))
    return out if batched else out[0]


def masked_aggregate_pytree(gstack_tree, coef: torch.Tensor):
    """``masked_aggregate`` over every leaf of a (nested dict) tree of
    client stacks, each result in its leaf's dtype."""
    return tree_map(lambda g: masked_aggregate(g, coef).to(g.dtype),
                    gstack_tree)
