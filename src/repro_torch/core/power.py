"""Power allocation: Dinkelbach's method (Algorithm 1) and its closed form.

The per-(i, k) fractional program (9)

    min_{P^min <= P <= P^max}   a S P / (B log2(1 + P * pg))

is solved for every element at once.  Dinkelbach's inner step is

    P*(lambda) = lambda * B / (a S ln 2) - 1 / pg        (then clipped)

and, because the ratio is increasing in P, its fixed point is the lower
boundary P = clip(P^min(a), 0, P^max): ``analytic_power`` exposes that
closed form.  As in ``repro.core.power``, every update exists at the
element level (``*_elements``: raw tensors of any common shape) and at
the problem level (``WirelessFLProblem`` broadcast shims).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.problem import (LN2, WirelessFLProblem, _bcast_like,
                                      div, log2)

_A_FLOOR = 1e-12   # guards the a -> 0 division in P*(lambda)


class PowerSolution(NamedTuple):
    power: torch.Tensor      # P*_ik
    lam: torch.Tensor        # converged Dinkelbach lambda (= min energy E^u at a)
    n_iters: int             # iterations to fleet-wide convergence
    feasible: torch.Tensor   # bool, P^min(a) <= P^max elementwise


# -------------------------------------------------------- element level

def element_p_min(a, pg, bw, *, s_bits, tau: float) -> torch.Tensor:
    """P^min_ik = (2^{a S / (B tau)} - 1) / pg, exponent clamped at 120;
    a gain that is not positive gives ``inf`` (the infeasible-device
    gate) instead of the 0 / 0 = NaN of the raw division."""
    exponent = torch.clamp(a * s_bits / (bw * tau), max=120.0)
    num = torch.expm1(exponent * LN2)
    return torch.where(pg > 0, num / torch.where(pg > 0, pg, 1.0), torch.inf)


def element_tx_time(power, pg, bw, *, s_bits) -> torch.Tensor:
    """T_ik(P) = S / r_ik(P) with r = B log2(1 + P pg)  (eq. 1)."""
    return div(s_bits, torch.clamp(bw * log2(1.0 + power * pg), min=1e-30))


def _element_lam(a, power, pg, bw, *, s_bits) -> torch.Tensor:
    """Objective (9a): a P T(P), defined 0 where a = 0 (rate(0) = 0)."""
    t = element_tx_time(power, pg, bw, s_bits=s_bits)
    return torch.where(a > 0, torch.clamp(a, min=_A_FLOOR) * power * t, 0.0)


def analytic_power_elements(a, pg, bw, *, s_bits, tau: float, p_max: float
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form optimum of (9) per element: P* = clip(P^min(a), 0, P^max).

    Returns ``(power, lam, feasible)`` with ``lam`` the objective (9a) at
    the optimum.
    """
    p_min = torch.clamp(element_p_min(a, pg, bw, s_bits=s_bits, tau=tau),
                        min=0.0)
    feasible = p_min <= p_max * (1 + 1e-6)
    p = torch.clamp(p_min, max=p_max)
    return p, _element_lam(a, p, pg, bw, s_bits=s_bits), feasible


def dinkelbach_power_elements(a, pg, bw, *, s_bits, tau: float, p_max: float,
                              lam0: float | torch.Tensor = 1e-3,
                              eps: float = 1e-6, max_iters: int = 64,
                              batch_dims: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor, int,
                                         torch.Tensor]:
    """Vectorised Algorithm 1 over raw element tensors.

    Returns ``(power, lam, n_iters, feasible)``.  The loop stops when
    every element's lambda moved less than ``eps`` relative to itself, or
    after ``max_iters`` steps; converged elements keep their values.

    ``batch_dims`` leading axes index independent problems: ``n_iters``
    is then an int tensor of their shape, each problem's count of the
    steps it took before all of its own elements converged, which is
    the count its own solve would report.
    """
    a_safe = torch.clamp(a, min=_A_FLOOR)
    p_min = torch.clamp(element_p_min(a, pg, bw, s_bits=s_bits, tau=tau),
                        min=0.0)
    p_lo = torch.clamp(p_min, max=p_max)
    feasible = p_min <= p_max * (1 + 1e-6)
    # pg <= 0 (gated-out element): drop the -1/pg offset; the clip to
    # [p_lo, p_max] dominates anyway
    inv_pg = torch.where(pg > 0, div(1.0, torch.where(pg > 0, pg, 1.0)), 0.0)

    def p_star(lam):
        p = lam * bw / (a_safe * s_bits * LN2) - inv_pg
        return torch.clamp(torch.maximum(p, p_lo), max=p_max)

    def lam_of(p):
        return _element_lam(a, p, pg, bw, s_bits=s_bits)

    lam = torch.broadcast_to(torch.as_tensor(lam0, dtype=a.dtype,
                                             device=a.device), a.shape)
    p = p_star(lam)
    lam = lam_of(p)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    it = 0
    counts = torch.zeros(a.shape[:batch_dims], dtype=torch.int64,
                         device=a.device) if batch_dims else None
    while it < max_iters and not bool(torch.all(done)):
        if batch_dims:
            counts += ~done.flatten(batch_dims).all(dim=-1)
        p_new = p_star(lam)
        lam_new = lam_of(p_new)
        done_new = torch.abs(lam_new - lam) <= eps * torch.clamp(
            torch.abs(lam_new), min=1e-30)
        p = torch.where(done, p, p_new)
        lam = torch.where(done, lam, lam_new)
        done = done | done_new
        it += 1
    return p, lam, counts if batch_dims else it, feasible


def energy_gate_elements(a, lam, emax, ec) -> torch.Tensor:
    """Algorithm 2 line 4: objective (9a) <= H_ik = E^max - a E^c (eq. 10)."""
    h = emax - a * ec
    return lam <= h + 1e-9


# -------------------------------------------------------- problem level

def _element_operands(problem: WirelessFLProblem, a: torch.Tensor):
    """``(a, pg, bw, s)`` broadcast to a common element rank (a 1-d ``a``
    on a fading problem is materialised to the path gain's shape)."""
    pg = problem._pg(a)
    bw = problem.bandwidth_hz
    rank = max(a.ndim, pg.ndim)
    if rank > bw.ndim:
        bw = bw[:, None]
    if a.ndim < pg.ndim:
        a = torch.broadcast_to(a[:, None], pg.shape)
    return a, pg, bw, problem.payload_bits(rank)


def dinkelbach_power(problem: WirelessFLProblem, a: torch.Tensor, *,
                     lam0: float | torch.Tensor = 1e-3, eps: float = 1e-6,
                     max_iters: int = 64) -> PowerSolution:
    """Vectorised Algorithm 1 over every (i, k) subproblem simultaneously."""
    a, pg, bw, s = _element_operands(problem, a)
    p, lam, iters, feasible = dinkelbach_power_elements(
        a, pg, bw, s_bits=s, tau=problem.tau_th, p_max=problem.p_max,
        lam0=lam0, eps=eps, max_iters=max_iters)
    return PowerSolution(power=p, lam=lam, n_iters=iters, feasible=feasible)


def analytic_power(problem: WirelessFLProblem, a: torch.Tensor) -> PowerSolution:
    """Closed-form optimum of (9): P* = clip(P^min(a), 0, P^max)."""
    a, pg, bw, s = _element_operands(problem, a)
    p, lam, feasible = analytic_power_elements(
        a, pg, bw, s_bits=s, tau=problem.tau_th, p_max=problem.p_max)
    return PowerSolution(power=p, lam=lam, n_iters=0, feasible=feasible)


def energy_bound_ok(problem: WirelessFLProblem, a: torch.Tensor,
                    sol: PowerSolution) -> torch.Tensor:
    """Algorithm 2 line 4 on a problem: objective (9a) <= E^max - a E^c."""
    rank = max(a.ndim, sol.lam.ndim)
    ec = _bcast_like(problem.compute_energy(), rank)
    emax = _bcast_like(problem.energy_budget_j, rank)
    return energy_gate_elements(_bcast_like(a, rank), sol.lam, emax, ec)
