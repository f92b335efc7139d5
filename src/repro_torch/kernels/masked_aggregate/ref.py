"""Plain PyTorch version of the masked_aggregate kernel."""
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
