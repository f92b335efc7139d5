"""Beyond-paper: the *global* optimum of problem (7) by monotone bisection.

For one element, a is feasible iff

    F(a):   P^min(a) <= P^max     and     tau * P^min(a) + a E^c <= E^max,

both increasing in a, so the feasible set is an interval [0, a*] and a
fixed number of bisection steps finds a* (``repro.core.optimal``).
"""
from __future__ import annotations

import torch

from repro_torch.core.alternating import JointSolution, _solution_shape
from repro_torch.core.problem import WirelessFLProblem, _bcast_like


def _feasible(problem: WirelessFLProblem, a: torch.Tensor) -> torch.Tensor:
    """F(a) elementwise; a = 0 is always feasible."""
    p_min = torch.clamp(problem.p_min(a), min=0.0)
    rank = max(a.ndim, p_min.ndim)
    av = _bcast_like(a, rank)
    ec = _bcast_like(problem.compute_energy(), rank)
    emax = _bcast_like(problem.energy_budget_j, rank)
    power_ok = p_min <= problem.p_max * (1 + 1e-9)
    energy_ok = problem.tau_th * p_min + av * ec <= emax * (1 + 1e-9)
    return (power_ok & energy_ok) | (av <= 0)


def solve_joint_optimal(problem: WirelessFLProblem, *, n_bisect: int = 60,
                        per_round: bool = True) -> JointSolution:
    """Exact per-element optimum of (7) by ``n_bisect`` bisection steps."""
    shape = _solution_shape(problem, per_round)
    lo = torch.zeros(shape, device=problem.device)
    hi = torch.ones(shape, device=problem.device)
    feas1 = _feasible(problem, hi)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = _feasible(problem, mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    a = torch.where(feas1, 1.0, lo)
    power = torch.clamp(problem.p_min(a), 0.0, problem.p_max)
    return JointSolution(a=a, power=power, objective=problem.objective(a),
                         n_iters=n_bisect, converged=True)
