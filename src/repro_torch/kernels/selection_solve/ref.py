"""Plain PyTorch versions of the selection_solve kernels.

The same math as ``csrc/selection_solve.cu`` on the same flat operands:
the wrappers in ``ops.py`` use these for CPU tensors, and the kernels are
held against them on the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.alternating import FleetElements, _fused_step, fused_init
from repro_torch.core.problem import LN2

N_BISECT = 60
N_ALT = 50      # fused alternating iterations (solve_joint's max_iters)


def _feasible(a, pg, bw, emax, ec, s_bits, tau, p_max):
    """The kernel's own F(a): no ``pg > 0`` gate, unlike element_p_min."""
    expo = torch.clamp(a * s_bits / (bw * tau), max=120.0)
    p_min = torch.expm1(expo * LN2) / pg
    return (p_min <= p_max) & (tau * p_min + a * ec <= emax)


def selection_solve_ref(pg, bw, emax, ec, *, s_bits: float, tau: float,
                        p_max: float):
    """Exact optimum of (7) per element: a = 1 where feasible, else
    ``N_BISECT`` bisection steps on F(a); P* = clip(P^min(a*), 0, P^max)."""
    ones = torch.ones_like(pg)
    feas1 = _feasible(ones, pg, bw, emax, ec, s_bits, tau, p_max)
    lo, hi = torch.zeros_like(pg), ones
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        ok = _feasible(mid, pg, bw, emax, ec, s_bits, tau, p_max)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    a = torch.where(feas1, 1.0, lo)
    expo = torch.clamp(a * s_bits / (bw * tau), max=120.0)
    p = torch.clamp(torch.expm1(expo * LN2) / pg, 0.0, p_max)
    return a, p


def fused_solve_ref(pg, bw, emax, ec, *, s_bits: float, tau: float,
                    p_max: float, n_iters: int = N_ALT,
                    faithful_eq13_typo: bool = False):
    """Algorithm 2's fused fixed point with a fixed trip count: the
    ``_fused_step`` and ``fused_init`` of ``core/alternating.py``, run
    ``n_iters`` times (the first step counts as one, as there)."""
    el = FleetElements(pg=pg, bw=bw, emax=emax, ec=ec)
    kw = dict(s_bits=float(s_bits), tau=float(tau), p_max=float(p_max),
              faithful_eq13_typo=bool(faithful_eq13_typo))
    step = functools.partial(_fused_step, el=el, power_solver="analytic", **kw)
    a0, _ = fused_init(el, **kw)
    a, p, _ = step(a0)
    for _ in range(1, n_iters):
        a, p, _ = step(a)
    return a, p
