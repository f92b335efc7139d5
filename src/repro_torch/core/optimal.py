"""Beyond-paper: the *global* optimum of problem (7) by monotone bisection.

For one element, a is feasible iff

    F(a):   P^min(a) <= P^max     and     tau * P^min(a) + a E^c <= E^max,

both increasing in a, so the feasible set is an interval [0, a*] and a
fixed number of bisection steps finds a* (``repro.core.optimal``).
"""
from __future__ import annotations

import torch

from repro_torch.core.alternating import (FleetElements, JointSolution,
                                          problem_elements)
from repro_torch.core.power import element_p_min
from repro_torch.core.problem import WirelessFLProblem


N_BISECT = 60


def optimal_elements(el: FleetElements, *, s_bits: float, tau: float,
                     p_max: float, n_bisect: int = N_BISECT):
    """The exact per-element optimum on raw elements of any one shape:
    a* = 1 where F(1) holds, else ``n_bisect`` bisection steps on F, and
    P* = clip(P^min(a*), 0, P^max); returns ``(a*, P*)``."""
    s = s_bits if el.sbits is None else el.sbits

    def p_min(a):
        return torch.clamp(element_p_min(a, el.pg, el.bw, s_bits=s, tau=tau),
                           min=0.0)

    def feasible(a):
        """F(a); a = 0 is always feasible."""
        pm = p_min(a)
        power_ok = pm <= p_max * (1 + 1e-9)
        energy_ok = tau * pm + a * el.ec <= el.emax * (1 + 1e-9)
        return (power_ok & energy_ok) | (a <= 0)

    lo, hi = torch.zeros_like(el.pg), torch.ones_like(el.pg)
    feas1 = feasible(hi)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    a = torch.where(feas1, 1.0, lo)
    return a, torch.clamp(p_min(a), max=p_max)


def solve_joint_optimal(problem: WirelessFLProblem, *, n_bisect: int = N_BISECT,
                        per_round: bool = True) -> JointSolution:
    """Exact per-element optimum of (7) by ``n_bisect`` bisection steps."""
    a, power = optimal_elements(problem_elements(problem, per_round),
                                s_bits=problem.grad_size_bits,
                                tau=problem.tau_th, p_max=problem.p_max,
                                n_bisect=n_bisect)
    return JointSolution(a=a, power=power, objective=problem.objective(a),
                         n_iters=n_bisect, converged=True)
