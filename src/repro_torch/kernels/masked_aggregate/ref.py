"""Plain PyTorch versions of the masked_aggregate kernels."""
from __future__ import annotations

import torch


def masked_aggregate_ref(gstack: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """out[t, d] = sum_i coef[t, i] g[t, i, d] for g [T, N, D] and coef
    [T, N]: the kernel's arithmetic, clients added in order to a float32
    accumulator."""
    g = gstack.to(torch.float32)
    c = coef.to(torch.float32)
    acc = torch.zeros((g.shape[0], g.shape[2]), dtype=torch.float32,
                      device=g.device)
    for i in range(g.shape[1]):
        acc = acc + c[:, i, None] * g[:, i]
    return acc


def quantizer_levels(bits) -> torch.Tensor:
    """Symmetric level count max(2^(b-1) - 1, 1) in float32, with the
    ternary floor at bits = 1; ``bits`` is a number or a tensor."""
    b = torch.as_tensor(bits, dtype=torch.float32)
    return torch.clamp(torch.pow(2.0, b - 1.0) - 1.0, min=1.0)


def stochastic_round(g: torch.Tensor, noise: torch.Tensor,
                     scale: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """clip(floor(g/s) + [u < g/s - floor(g/s)], -L, L) * s, with ``scale``
    and ``levels`` broadcast against g: the quantiser's arithmetic, shared
    by the engines and the kernel's plain version.  g/s is a true
    division of tensors on every device."""
    scaled = g / scale
    low = torch.floor(scaled)
    q = low + (noise < scaled - low).to(torch.float32)
    return torch.minimum(torch.maximum(q, -levels), levels) * scale


def quantized_masked_aggregate_ref(gstack: torch.Tensor, coef: torch.Tensor,
                                   noise: torch.Tensor, scale: torch.Tensor,
                                   levels: torch.Tensor) -> torch.Tensor:
    """out[t, d] = sum_i coef[t, i] Q(g[t, i, :])[d] for g and noise
    [T, N, D] and coef, scale and levels [T, N]: each client row
    stochastically rounded at its own scale and level count, then the
    clients added in order to a float32 accumulator, as the kernel
    does."""
    acc = torch.zeros((gstack.shape[0], gstack.shape[2]), dtype=torch.float32,
                      device=gstack.device)
    for i in range(gstack.shape[1]):
        q = stochastic_round(gstack[:, i], noise[:, i], scale[:, i, None],
                             levels[:, i, None])
        acc = acc + coef[:, i, None] * q
    return acc
