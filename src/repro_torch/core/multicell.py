"""Multi-cell metro problems: C cells coupled by interference and backhaul.

As ``repro.core.multicell``: a :class:`MultiCellProblem` stacks the
per-cell problems into one :class:`core.batch.ProblemBatch` and adds the
metro-level coupling, ``coupling[c, c']`` the aggregate interference gain
from cell c' transmissions into cell c's base station (zero diagonal)
and ``backhaul_bits`` the shared per-round uplink budget.

This slice holds what the scenario registry builds (``metro_coupled``,
``interference_grid``): the problem, its validation and the grid
coupling.  The dual-decomposition solve (``solve_coupled``) comes with
a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batch import ProblemBatch, stack_problems
from repro_torch.core.problem import WirelessFLProblem


@dataclasses.dataclass(frozen=True)
class MultiCellProblem:
    """C per-cell problem (7) instances plus their metro-level coupling.

    ``cells`` stacks the per-cell leaves (``[C, N_max]``, fading
    ``[C, N_max, K]``); ``coupling`` is ``[C, C]`` float32 on the cells'
    device; ``backhaul_bits`` is the shared budget (``None``: none).
    """

    cells: ProblemBatch
    coupling: torch.Tensor
    backhaul_bits: Optional[float] = None

    @property
    def n_cells(self) -> int:
        return self.cells.batch_size


def make_multicell(problems: Sequence[WirelessFLProblem] | ProblemBatch,
                   coupling, *, backhaul_bits: Optional[float] = None,
                   device=None) -> MultiCellProblem:
    """Validate and assemble a :class:`MultiCellProblem`.

    ``problems`` is either per-cell instances (stacked here, on
    ``device``, default the card) or a stacked :class:`ProblemBatch`;
    ``coupling`` must be a ``[C, C]`` finite, non-negative matrix with a
    zero diagonal.
    """
    cells = problems if isinstance(problems, ProblemBatch) \
        else stack_problems(list(problems), device=device)
    g = (coupling.detach().cpu().numpy() if isinstance(coupling, torch.Tensor)
         else np.asarray(coupling)).astype(np.float64)
    c = cells.batch_size
    if g.shape != (c, c):
        raise ValueError(f"coupling must be [{c}, {c}] for {c} cells, "
                         f"got {g.shape}")
    if not np.isfinite(g).all():
        raise ValueError("coupling gains must be finite — a NaN/Inf entry "
                         "would poison every cell's interference estimate")
    if np.any(g < 0):
        raise ValueError("coupling gains must be non-negative")
    if np.any(np.diag(g) != 0):
        raise ValueError(
            "coupling must have a zero diagonal — own-cell OFDMA traffic "
            "is orthogonal, not interference (model extra in-cell noise "
            "through noise_power instead)")
    if backhaul_bits is not None and backhaul_bits <= 0:
        raise ValueError(f"backhaul_bits must be positive, "
                         f"got {backhaul_bits}")
    return MultiCellProblem(
        cells=cells,
        coupling=torch.from_numpy(g.astype(np.float32)).to(cells.device),
        backhaul_bits=None if backhaul_bits is None else float(backhaul_bits))


def grid_coupling(n_cells: int, *, gain: float, alpha: float = 2.0,
                  spacing: float = 1.0) -> np.ndarray:
    """Square-grid coupling matrix: cells on a ceil(sqrt(C)) grid, gain
    ``gain / dist^alpha`` between distinct cells (``dist`` in units of
    ``spacing``), zero diagonal.  ``gain`` is the nearest-neighbour
    coupling; diagonal neighbours get ``gain / 2^(alpha/2)`` and so on.
    """
    side = int(np.ceil(np.sqrt(n_cells)))
    xy = np.stack(np.divmod(np.arange(n_cells), side), axis=1) * spacing
    d = np.linalg.norm(xy[:, None, :] - xy[None, :, :], axis=-1)
    with np.errstate(divide="ignore"):
        g = gain * spacing ** alpha / np.maximum(d, 1e-30) ** alpha
    np.fill_diagonal(g, 0.0)
    return g
