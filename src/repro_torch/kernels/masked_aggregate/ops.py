"""Wrappers for the masked_aggregate kernels: the eq.-4 server sum, plain
and with each client's uplink stochastically rounded to b bits.

``masked_aggregate_batched`` takes g [T, N, D] and coef [T, N];
``quantized_masked_aggregate_batched`` also takes noise [T, N, D] and
the per-row scale and level count [T, N], which ``row_scale_batched``
computes from g.  For CPU tensors they run the plain versions
(``ref.py``, ``row_scale``), for CUDA tensors they launch the kernels of
``csrc/masked_aggregate.cu`` on the current stream, or raise.
``masked_aggregate`` / ``quantized_masked_aggregate`` reshape client
stacks for them, and the ``*_pytree`` front ends (the FL engines'
aggregation) map them over a parameter tree.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.cuda_lib import LAUNCHES, check_operands, launch
from repro_torch.kernels.masked_aggregate.ref import (
    masked_aggregate_ref, quantized_masked_aggregate_ref, quantizer_levels)
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


# ------------------------------------------------------------ quantised

def quantized_masked_aggregate_batched(gstack: torch.Tensor, coef: torch.Tensor,
                                       noise: torch.Tensor, scale: torch.Tensor,
                                       levels: torch.Tensor) -> torch.Tensor:
    """g and noise [T, N, D], coef, scale and levels [T, N] -> [T, D]
    float32: out[t, d] = sum_i coef[t, i] Q(g[t, i, d])."""
    if (gstack.ndim != 3 or tuple(noise.shape) != tuple(gstack.shape)
            or any(tuple(x.shape) != tuple(gstack.shape[:2])
                   for x in (coef, scale, levels))):
        raise ValueError(
            f"expected g and noise [T, N, D] and coef, scale, levels [T, N], "
            f"got {tuple(gstack.shape)}, {tuple(noise.shape)}, "
            f"{tuple(coef.shape)}, {tuple(scale.shape)}, {tuple(levels.shape)}")
    if gstack.device.type == "cpu":
        return quantized_masked_aggregate_ref(gstack, coef, noise, scale, levels)
    check_operands(gstack, coef, noise, scale, levels)
    t, n, d = gstack.shape
    out = torch.empty((t, d), dtype=torch.float32, device=gstack.device)
    launch("repro_quantized_masked_aggregate", gstack.data_ptr(),
           coef.data_ptr(), noise.data_ptr(), scale.data_ptr(),
           levels.data_ptr(), out.data_ptr(), t, n, d)
    LAUNCHES["quantized_masked_aggregate"] += 1
    return out


def row_scale(flat: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """max(amax|g_row|, 1e-12) / L per client row of ``flat`` [..., D]."""
    return torch.clamp(torch.amax(torch.abs(flat), dim=-1), min=1e-12) / levels


def row_scale_batched(gstack: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """g [T, N, D] and levels [T, N] -> scale [T, N] float32, each row's
    max(amax|g|, 1e-12) / L: ``row_scale`` for CPU tensors, the scale
    kernel for CUDA tensors, bit for bit (a NaN in a row gives NaN, an
    inf inf)."""
    if gstack.ndim != 3 or tuple(levels.shape) != tuple(gstack.shape[:2]):
        raise ValueError(f"expected g [T, N, D] and levels [T, N], got "
                         f"{tuple(gstack.shape)} and {tuple(levels.shape)}")
    if gstack.device.type == "cpu":
        return row_scale(gstack, levels)
    check_operands(gstack, levels)
    t, n, d = gstack.shape
    if d == 0:
        raise ValueError("row_scale_batched needs rows of at least one value")
    scale = torch.empty((t, n), dtype=torch.float32, device=gstack.device)
    launch("repro_row_scale", gstack.data_ptr(), levels.data_ptr(),
           scale.data_ptr(), t * n, d)
    LAUNCHES["row_scale"] += 1
    return scale


def quantized_masked_aggregate(gstack: torch.Tensor, coef: torch.Tensor,
                               noise: torch.Tensor, bits) -> torch.Tensor:
    """gstack and noise [N, ...] with coef [N] -> [...], or with a leading
    trajectory axis [T, N, ...] and coef [T, N] -> [T, ...]: each client
    row stochastically rounded to its width, then the masked sum.
    ``bits`` is a number or a tensor that broadcasts to coef's shape
    ([N], or [T, N]).  The level count and each row's scale are computed
    here, once, for the kernel (or its plain version): on the card two
    launches, the scale pass and the sum."""
    batched = coef.ndim == 2
    if not batched:
        gstack, noise, coef = gstack[None], noise[None], coef[None]
    t, n = coef.shape
    flat = gstack.reshape(t, n, -1).to(torch.float32).contiguous()
    noise_f = noise.reshape(t, n, -1).to(torch.float32).contiguous()
    bits = torch.as_tensor(bits, dtype=torch.float32, device=flat.device)
    levels = torch.broadcast_to(quantizer_levels(bits), (t, n)).contiguous()
    scale = row_scale_batched(flat, levels)
    out = quantized_masked_aggregate_batched(
        flat, coef.to(torch.float32).contiguous(), noise_f, scale, levels)
    out = out.reshape((t,) + tuple(gstack.shape[2:]))
    return out if batched else out[0]


def uniform_noise_like(gstack_tree, generator):
    """uniform(0,1) noise shaped like a tree of client stacks, drawn leaf
    by leaf in sorted-key order (as jax flattens the tree), one draw of
    [N, *leaf_shape] per leaf from each trajectory's generator.
    ``generator`` is one ``torch.Generator`` for leaves [N, ...], or a
    sequence of them, one per trajectory, for leaves [T, N, ...]; each
    sits on the stacks' device."""
    batched = isinstance(generator, Sequence)
    gens = list(generator) if batched else [generator]

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(tree[k]) for k in sorted(tree)}
        buf = torch.empty(tree.shape, dtype=torch.float32, device=tree.device)
        rows = buf if batched else buf[None]
        if len(rows) != len(gens):
            raise ValueError(f"{len(gens)} generators for {len(rows)} "
                             "trajectories")
        for row, gen in zip(rows, gens):
            row.uniform_(generator=gen)
        return buf

    return draw(gstack_tree)


def quantized_aggregate_pytree(gstack_tree, coef: torch.Tensor, bits, *,
                               generator=None, noise=None):
    """``quantized_masked_aggregate`` over every leaf of a tree of client
    stacks, each result in its leaf's dtype.  The noise is the explicit
    tree ``noise`` (leaves shaped like the stacks), or is drawn from
    ``generator`` (one per trajectory when coef is [T, N]) by
    :func:`uniform_noise_like`."""
    if (generator is None) == (noise is None):
        raise ValueError("pass exactly one of generator= and noise=")
    if noise is None:
        noise = uniform_noise_like(gstack_tree, generator)
    return tree_map(
        lambda g, u: quantized_masked_aggregate(
            g, coef, torch.as_tensor(u, device=g.device), bits).to(g.dtype),
        gstack_tree, noise)
