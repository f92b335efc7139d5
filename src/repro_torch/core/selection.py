"""Closed-form selection probabilities (eq. 13) given fixed powers.

With P fixed, problem (12) separates per (i, k) into a box-constrained
linear program whose optimum saturates the tightest constraint:

    a*_ik = min( 1, tau^th / T_ik(P_ik), E^max_i / (P_ik T_ik(P_ik) + E^c_i) )

The paper prints the middle term as ``tau^th / (S * T_ik)``, which is
dimensionally inconsistent; the corrected form is the default and
``faithful_eq13_typo=True`` reproduces the printed one.
"""
from __future__ import annotations

import torch

from repro_torch.core.problem import WirelessFLProblem, _bcast_like, div


def selection_update_elements(power, tx_time, emax, ec, *, tau: float,
                              s_bits, faithful_eq13_typo: bool = False
                              ) -> torch.Tensor:
    """a*_ik per eq. (13) on raw element tensors; ``tx_time`` is
    T_ik(P_ik) at ``power``."""
    time_term = div(tau, torch.clamp(tx_time, min=1e-30))
    if faithful_eq13_typo:
        time_term = div(time_term, s_bits)
    energy_term = emax / torch.clamp(power * tx_time + ec, min=1e-30)
    a = torch.minimum(torch.clamp(time_term, max=1.0), energy_term)
    # P = 0 transmits nothing: T = inf
    a = torch.where(power > 0, a, 0.0)
    return torch.clamp(a, 0.0, 1.0)


def optimal_selection(problem: WirelessFLProblem, power: torch.Tensor, *,
                      faithful_eq13_typo: bool = False) -> torch.Tensor:
    """a*_ik per eq. (13); a 1-d ``power`` on a fading problem broadcasts
    across rounds and yields an [N, K] result."""
    t = problem.tx_time(power)
    rank = max(power.ndim, t.ndim)
    ec = _bcast_like(problem.compute_energy(), rank)
    emax = _bcast_like(problem.energy_budget_j, rank)
    return selection_update_elements(_bcast_like(power, rank), t, emax, ec,
                                     tau=problem.tau_th,
                                     s_bits=problem.payload_bits(rank),
                                     faithful_eq13_typo=faithful_eq13_typo)
