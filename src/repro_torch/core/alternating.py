"""Algorithm 2: alternating optimisation of (7).

repeat:
    P^{n+1}  <- power update (Algorithm 1 / closed form) at a^n
    if objective (9a) bounded by H (eq. 10):      (feasibility gate, line 4)
        a^{n+1} <- closed form (13)
until converged

Three implementations, as in ``repro.core.alternating``:

* ``solve_joint``       — the paper-shaped solve: stops on the *global*
                          objective delta, with Dinkelbach's inner loop as
                          the power solver by default.
* ``solve_joint_trace`` — the same steps and stopping predicate, recording
                          the objective path.
* ``solve_joint_fused`` — the fused single-level solver: one flat,
                          convergence-masked fixed point over the separable
                          (device, round) elements, closed-form power, the
                          eq.-10 gate and eq.-13 in one step; it stops when
                          every element moved less than ``eps``.  With a
                          ``bit_menu`` it also picks each element's uplink
                          width (the joint bit/power/selection solve).

The loops are python loops that read one flag from the device per step.
The port runs on one device: ``mesh`` is refused and ``shard`` changes
nothing but the code path, as in the reference on one device.  Warm
starts (``init=``) and ``sanitize=`` belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.power import (
    PowerSolution,
    analytic_power,
    analytic_power_elements,
    dinkelbach_power,
    dinkelbach_power_elements,
    element_tx_time,
    energy_bound_ok,
    energy_gate_elements,
)
from repro_torch.core.problem import WirelessFLProblem
from repro_torch.core.selection import optimal_selection, selection_update_elements


def _not_in_this_slice(what: str, slice_: str):
    raise NotImplementedError(f"{what} is not ported yet; it comes with {slice_}")


class JointSolution(NamedTuple):
    a: torch.Tensor          # selection probabilities a*_ik
    power: torch.Tensor      # transmit powers P*_ik
    objective: torch.Tensor  # scalar, sum_i w_i a_i (per round)
    n_iters: int             # outer iterations used
    converged: bool
    # total inner power-solver (Algorithm 1) iterations; 0 in analytic mode
    inner_iters: int = 0
    # per-element uplink widths chosen by the bit-allocation step; set
    # only when solving with a ``bit_menu``
    bits: Optional[torch.Tensor] = None


def _init_state(problem: WirelessFLProblem, shape):
    """Feasible (a^0, P^0): transmit at P^max, then a^0 from (13)."""
    p0 = torch.full(shape, problem.p_max, device=problem.device)
    return optimal_selection(problem, p0), p0


def _solution_shape(problem: WirelessFLProblem, per_round: bool):
    n = problem.n_devices
    if problem.fading is not None:
        if not per_round:
            raise ValueError(
                "per_round=False is meaningless on a fading problem: the "
                "closed forms are separable per (i, k), so solve with "
                "per_round=True (solution shape [N, K])")
        return (n, problem.n_rounds)
    return (n,)


# ------------------------------------------------- shared Algorithm-2 step

def _alternating_step(problem: WirelessFLProblem, a: torch.Tensor,
                      solver: Callable[..., PowerSolution],
                      faithful_eq13_typo: bool):
    """One Algorithm-2 alternation: power update, eq.-10 gate, eq.-13.
    Returns ``(a_new, power, inner_iters)``."""
    sol = solver(problem, a)
    ok = energy_bound_ok(problem, a, sol) & sol.feasible
    a_new = optimal_selection(problem, sol.power,
                              faithful_eq13_typo=faithful_eq13_typo)
    # freeze elements whose power subproblem is infeasible / unbounded
    return torch.where(ok, a_new, a), sol.power, sol.n_iters


def _converged(obj: torch.Tensor, obj_prev: torch.Tensor, eps: float) -> bool:
    """The stopping predicate both solve_joint paths share, in float32."""
    return bool(torch.abs(obj - obj_prev) < eps)


def _power_solver(power_solver: str, init) -> Callable[..., PowerSolution]:
    if init is not None:
        _not_in_this_slice("init= (warm starts)", "the serving slice")
    if power_solver == "analytic":
        return analytic_power
    if power_solver == "dinkelbach":
        return dinkelbach_power
    raise ValueError(f"unknown power_solver {power_solver!r}")


def solve_joint(problem: WirelessFLProblem, *, eps: float = 1e-7,
                max_iters: int = 50, power_solver: str = "dinkelbach",
                faithful_eq13_typo: bool = False, per_round: bool = True,
                init=None) -> JointSolution:
    """Run Algorithm 2 to convergence for the whole fleet: at most
    ``max_iters`` steps, ``n_iters`` the number taken."""
    shape = _solution_shape(problem, per_round)
    a0, _ = _init_state(problem, shape)
    step = functools.partial(_alternating_step,
                             solver=_power_solver(power_solver, init),
                             faithful_eq13_typo=faithful_eq13_typo)
    a, p, inner = step(problem, a0)
    obj, obj_prev, it = problem.objective(a), problem.objective(a0), 1
    while it < max_iters and not _converged(obj, obj_prev, eps):
        a, p, k = step(problem, a)
        obj_prev, obj = obj, problem.objective(a)
        it += 1
        inner += k
    return JointSolution(a=a, power=p, objective=obj, n_iters=it,
                         converged=_converged(obj, obj_prev, eps),
                         inner_iters=inner)


def solve_joint_trace(problem: WirelessFLProblem, *, eps: float = 1e-7,
                      max_iters: int = 50, power_solver: str = "dinkelbach",
                      faithful_eq13_typo: bool = False, init=None
                      ) -> tuple[JointSolution, list[float]]:
    """``solve_joint`` recording the objective after every step; the trace
    length and ``n_iters`` match ``solve_joint`` step for step."""
    shape = _solution_shape(problem, per_round=True)
    a, p = _init_state(problem, shape)
    step = functools.partial(_alternating_step,
                             solver=_power_solver(power_solver, init),
                             faithful_eq13_typo=faithful_eq13_typo)
    obj_prev = problem.objective(a)
    trace = [float(obj_prev)]
    converged = False
    it = 0
    inner = 0
    for it in range(1, max_iters + 1):  # noqa: B007 - read after the loop
        a, p, k = step(problem, a)
        inner += k
        obj = problem.objective(a)
        trace.append(float(obj))
        if _converged(obj, obj_prev, eps):
            converged = True
            break
        obj_prev = obj
    res = JointSolution(a=a, power=p,
                        objective=torch.tensor(trace[-1], device=problem.device),
                        n_iters=it, converged=converged, inner_iters=inner)
    return res, trace


# --------------------------------------------- fused single-level solver

class FleetElements(NamedTuple):
    """Constraint data of the separable elements, all of one shape."""

    pg: torch.Tensor      # path gain g / (d^2 sigma^2)
    bw: torch.Tensor      # bandwidth B_i
    emax: torch.Tensor    # per-round energy budget E^max_i
    ec: torch.Tensor      # computation energy E^c_i
    # effective payload S_i = S b_i / 32 per element; None => ``s_bits``
    sbits: Optional[torch.Tensor] = None


# padding for chunk alignment: a zero energy budget self-deselects
# (a* = 0, P* = 0) without producing NaN/inf in any update
_ELEMENT_PAD = dict(pg=1.0, bw=1.0, emax=0.0, ec=1.0)


def problem_elements(problem: WirelessFLProblem,
                     per_round: bool = True) -> FleetElements:
    """Broadcast one problem's constraint data to the element set."""
    shape = _solution_shape(problem, per_round)

    def b(x):
        return torch.broadcast_to(x[:, None] if x.ndim < len(shape) else x,
                                  shape)

    return FleetElements(pg=b(problem.path_gain()),
                         bw=b(problem.bandwidth_hz),
                         emax=b(problem.energy_budget_j),
                         ec=b(problem.compute_energy()),
                         sbits=None if problem.bits is None
                         else b(problem.payload_bits(len(shape))))


def _fused_step(a: torch.Tensor, el: FleetElements, *, s_bits: float,
                tau: float, p_max: float, power_solver: str,
                faithful_eq13_typo: bool, lam0: float = 1e-3,
                batch_dims: int = 0):
    """One fused alternation on raw elements: power + gate + eq. 13.
    Returns ``(a_new, power, inner_iters)``; ``batch_dims`` as in
    ``dinkelbach_power_elements``."""
    if el.sbits is not None:
        s_bits = el.sbits
    if power_solver == "analytic":
        p, lam, feasible = analytic_power_elements(
            a, el.pg, el.bw, s_bits=s_bits, tau=tau, p_max=p_max)
        inner = 0
    elif power_solver == "dinkelbach":
        p, lam, inner, feasible = dinkelbach_power_elements(
            a, el.pg, el.bw, s_bits=s_bits, tau=tau, p_max=p_max, lam0=lam0,
            batch_dims=batch_dims)
    else:
        raise ValueError(f"unknown power_solver {power_solver!r}")
    ok = energy_gate_elements(a, lam, el.emax, el.ec) & feasible
    t = element_tx_time(p, el.pg, el.bw, s_bits=s_bits)
    a_new = selection_update_elements(p, t, el.emax, el.ec, tau=tau,
                                      s_bits=s_bits,
                                      faithful_eq13_typo=faithful_eq13_typo)
    return torch.where(ok, a_new, a), p, inner


def fused_init(el: FleetElements, *, s_bits: float, tau: float,
               p_max: float, faithful_eq13_typo: bool = False):
    """Feasible (a^0, P^0) on raw elements: transmit at P^max, a^0 from
    eq. (13)."""
    if el.sbits is not None:
        s_bits = el.sbits
    p0 = torch.full(el.pg.shape, p_max, device=el.pg.device)
    t0 = element_tx_time(p0, el.pg, el.bw, s_bits=s_bits)
    a0 = selection_update_elements(p0, t0, el.emax, el.ec, tau=tau,
                                   s_bits=s_bits,
                                   faithful_eq13_typo=faithful_eq13_typo)
    return a0, p0


def _menu_payloads(el: FleetElements, *, s_bits: float, bit_menu):
    """Candidate effective payloads ``S b / 32`` for each menu width, in
    descending width; a problem-level ``bits`` cap (``el.sbits``)
    composes by elementwise minimum.  The descending order makes exact
    ties resolve to the widest entry in :func:`select_best_bits`."""
    menu = tuple(sorted({float(b) for b in bit_menu}, reverse=True))
    if not menu or menu[0] > 32.0 or menu[-1] <= 0.0:
        raise ValueError(f"bit_menu entries must lie in (0, 32], got {bit_menu!r}")
    payloads = []
    for b in menu:
        s_b = s_bits * (b / 32.0)
        if el.sbits is not None:
            s_b = torch.clamp(el.sbits, max=s_b)
        payloads.append(s_b)
    return menu, payloads


def select_best_bits(a_m: torch.Tensor, p_m: torch.Tensor,
                     sbits_m: torch.Tensor, *, s_bits: float,
                     atol: float = 1e-6):
    """Closed-form bit allocation: argmax over per-element candidates.

    ``a_m``/``p_m``/``sbits_m`` stack one converged candidate per menu
    entry on a leading axis, in descending width.  Per element the chosen
    entry is the first (widest) whose selection probability is within
    ``atol`` of the best.  Returns ``(a, power, bits)`` with ``bits = 32
    sbits / S``, the chosen effective width.
    """
    amax = torch.amax(a_m, dim=0)
    # argmax of an integer mask: the first maximal index, the widest
    near = (a_m >= amax[None] - atol).to(torch.int32)
    idx = torch.argmax(near, dim=0)[None]

    def take(x):
        return torch.take_along_dim(x, idx, dim=0)[0]

    return take(a_m), take(p_m), take(sbits_m) * (32.0 / s_bits)


def fused_fixed_point(el: FleetElements, *, s_bits: float, tau: float,
                      p_max: float, eps: float = 1e-7, max_iters: int = 50,
                      power_solver: str = "analytic",
                      faithful_eq13_typo: bool = False, init=None,
                      bit_menu: Optional[tuple] = None):
    """The flat convergence-masked alternating solve.

    Step ``n`` applies ``_fused_step`` to every element; the loop exits
    when every element moved less than ``eps``, or after ``max_iters``
    steps counted like ``solve_joint``.  Returns ``(a, power, n_iters,
    converged, inner_iters)`` with ``converged`` per element.

    ``bit_menu`` (widths in (0, 32]) expands the elements with a leading
    candidate axis, one slice per width, runs every candidate to its own
    fixed point in the one loop, and reduces the axis with
    :func:`select_best_bits`; the return value gains a trailing ``bits``.
    """
    if init is not None:
        _not_in_this_slice("init= (warm starts)", "the serving slice")
    if bit_menu is not None:
        _, payloads = _menu_payloads(el, s_bits=s_bits, bit_menu=bit_menu)
        m, shape = len(payloads), el.pg.shape

        def expand(x):
            return torch.broadcast_to(x[None], (m,) + tuple(shape))

        sb = torch.stack([torch.broadcast_to(
            torch.as_tensor(s_b, dtype=torch.float32, device=el.pg.device),
            shape) for s_b in payloads])
        el_m = FleetElements(pg=expand(el.pg), bw=expand(el.bw),
                             emax=expand(el.emax), ec=expand(el.ec), sbits=sb)
        a_m, p_m, iters, conv_m, inner = fused_fixed_point(
            el_m, s_bits=s_bits, tau=tau, p_max=p_max, eps=eps,
            max_iters=max_iters, power_solver=power_solver,
            faithful_eq13_typo=faithful_eq13_typo)
        a, p, bits = select_best_bits(a_m, p_m, sb, s_bits=s_bits)
        return a, p, iters, torch.all(conv_m, dim=0), inner, bits
    a0, _ = fused_init(el, s_bits=s_bits, tau=tau, p_max=p_max,
                       faithful_eq13_typo=faithful_eq13_typo)
    step = functools.partial(_fused_step, el=el, s_bits=s_bits, tau=tau,
                             p_max=p_max, power_solver=power_solver,
                             faithful_eq13_typo=faithful_eq13_typo)
    a, p, inner = step(a0)
    delta, it = torch.abs(a - a0), 1
    while it < max_iters and bool(torch.any(delta >= eps)):
        a_new, p, k = step(a)
        delta, a = torch.abs(a_new - a), a_new
        it += 1
        inner += k
    return a, p, it, delta < eps, inner


def _pad_flat(x: torch.Tensor, multiple: int, fill: float) -> torch.Tensor:
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                    device=x.device)])


def fused_fixed_point_flat(el: FleetElements, *, s_bits: float, tau: float,
                           p_max: float, eps: float = 1e-7,
                           max_iters: int = 50,
                           power_solver: str = "analytic",
                           faithful_eq13_typo: bool = False,
                           chunk_elements: Optional[int] = None,
                           mesh=None, shard: bool = True, init=None,
                           bit_menu: Optional[tuple] = None):
    """Chunked solve over a flat ``[E]`` element set.

    ``chunk_elements`` bounds the working set: the element axis is padded
    to whole chunks (padding self-deselects) and solved chunk by chunk,
    each chunk with its own stopping rule.  ``n_iters`` is the largest
    chunk's count and ``inner_iters`` the sum.  ``mesh`` is refused (one
    device); ``shard`` is a no-op on one device.  With a ``bit_menu`` the
    return value gains a trailing flat ``bits``.
    """
    if el.pg.ndim != 1:
        raise ValueError("fused_fixed_point_flat takes flat [E] elements")
    if mesh is not None:
        raise ValueError("the port runs on one device; mesh must be None")
    kw = dict(s_bits=s_bits, tau=tau, p_max=p_max, eps=eps,
              max_iters=max_iters, power_solver=power_solver,
              faithful_eq13_typo=faithful_eq13_typo, init=init,
              bit_menu=bit_menu)
    e = el.pg.shape[0]
    if chunk_elements is None:
        return fused_fixed_point(el, **kw)
    padded = {f: _pad_flat(getattr(el, f), chunk_elements, _ELEMENT_PAD[f])
              for f in _ELEMENT_PAD}
    if el.sbits is not None:
        padded["sbits"] = _pad_flat(el.sbits, chunk_elements, 1.0)
    outs = []
    for lo in range(0, padded["pg"].shape[0], chunk_elements):
        chunk = FleetElements(**{f: x[lo:lo + chunk_elements]
                                 for f, x in padded.items()})
        outs.append(fused_fixed_point(chunk, **kw))
    a, p, iters, conv, inner, *bits = zip(*outs)
    out = (torch.cat(a)[:e], torch.cat(p)[:e], max(iters),
           torch.cat(conv)[:e], sum(inner))
    return out if bit_menu is None else out + (torch.cat(bits[0])[:e],)


def solve_joint_fused(problem: WirelessFLProblem, *, eps: float = 1e-7,
                      max_iters: int = 50, power_solver: str = "analytic",
                      faithful_eq13_typo: bool = False, per_round: bool = True,
                      chunk_elements: Optional[int] = None, mesh=None,
                      shard: bool = False, sanitize: bool = False,
                      init=None, bit_menu: Optional[tuple] = None
                      ) -> JointSolution:
    """Fused single-level Algorithm 2 for one problem.

    Matches ``solve_joint`` to solver tolerance (<= 1e-5 on a*, P* and
    the objective).  ``chunk_elements``/``mesh``/``shard`` go to
    :func:`fused_fixed_point_flat`.  ``bit_menu`` (e.g. ``(8, 16, 32)``)
    adds the bit-allocation step, and ``JointSolution.bits`` carries the
    chosen widths; ``None`` runs the solve without it, ``bits=None``.
    """
    if sanitize:
        _not_in_this_slice("sanitize=True", "the fault-handling slice")
    el = problem_elements(problem, per_round)
    shape = el.pg.shape
    kw = dict(s_bits=problem.grad_size_bits, tau=problem.tau_th,
              p_max=problem.p_max, eps=eps, max_iters=max_iters,
              power_solver=power_solver,
              faithful_eq13_typo=faithful_eq13_typo, init=init,
              bit_menu=bit_menu)
    if chunk_elements is None and not shard and mesh is None:
        a, p, iters, conv, inner, *bits = fused_fixed_point(el, **kw)
    else:
        flat = FleetElements(*(None if x is None else x.reshape(-1)
                               for x in el))
        a, p, iters, conv, inner, *bits = fused_fixed_point_flat(
            flat, chunk_elements=chunk_elements, mesh=mesh, shard=shard, **kw)
        a, p, conv = a.reshape(shape), p.reshape(shape), conv.reshape(shape)
        bits = [b.reshape(shape) for b in bits]
    return JointSolution(a=a, power=p, objective=problem.objective(a),
                         n_iters=iters, converged=bool(torch.all(conv)),
                         inner_iters=inner, bits=bits[0] if bits else None)
