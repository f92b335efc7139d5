"""Multi-cell metro control plane: C coupled cells, one fused solve per tick.

As ``repro.core.multicell``: a :class:`MultiCellProblem` stacks the
per-cell problems into one :class:`core.batch.ProblemBatch` and adds the
metro-level coupling, ``coupling[c, c']`` the aggregate interference gain
from cell c' transmissions into cell c's base station (zero diagonal)
and ``backhaul_bits`` the shared per-round uplink budget.

:func:`solve_coupled` resolves both couplings by dual decomposition: fix
the interference estimate ``I`` and the backhaul price ``mu``, solve the
union (cell, device) element set in one ``solve_joint_batch(method=
"fused")`` call on the device, then update ``(I, mu)`` on the host from
the solution and repeat until the coupled-KKT residual converges.  The
price step is an exact continuous knapsack (:func:`_knapsack_round`), so
complementary slackness holds exactly at every outer iteration.  The
outer updates are float64 numpy on the host, copied from the reference:
each outer step reads the batch's ``a`` and ``power`` back once.

With zero coupling and no backhaul budget the zero interference estimate
is elided (the problem keeps ``interference=None``) and the solver's
arrays are kept untouched, so the one outer iteration is exactly the
uncoupled ``solve_joint_batch(cells, method="fused")``, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.alternating import WarmStart, solve_joint_fused
from repro_torch.core.batch import (
    BatchSolution,
    ProblemBatch,
    _host,
    pad_batch,
    solve_joint_batch,
    stack_problems,
)
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


def pad_metro(mc: MultiCellProblem, *, n_cells: Optional[int] = None,
              n_max: Optional[int] = None) -> MultiCellProblem:
    """Pad a metro to fixed ``(n_cells, n_max)`` slot shapes (the serving
    path's buckets; :func:`core.batch.pad_batch` underneath).  Padded
    cells get zero coupling rows and columns and the neutral device
    fills, so they select nothing, radiate nothing and load no backhaul.
    """
    cells = pad_batch(mc.cells, batch_size=n_cells, n_max=n_max)
    c0, c1 = mc.n_cells, cells.batch_size
    if c1 == c0 and cells is mc.cells:
        return mc
    g = mc.coupling.new_zeros((c1, c1))
    g[:c0, :c0] = mc.coupling
    return MultiCellProblem(cells=cells, coupling=g,
                            backhaul_bits=mc.backhaul_bits)


class CoupledDuals(NamedTuple):
    """Warm-start state carried across metro ticks (``.resume``)."""

    interference: np.ndarray          # [C] (or [C, K]) last I estimate, W
    mu: np.ndarray                    # scalar (or [K]) backhaul price
    warm: Optional[WarmStart] = None  # element warm start for the inner solve


class MultiCellSolution(NamedTuple):
    """Converged coupled solve: the union solution plus the dual state."""

    batch: BatchSolution       # per-cell (a*, P*), padded [C, N_max(, K)]
    interference: np.ndarray   # [C] or [C, K] consistent with batch
    mu: np.ndarray             # scalar or [K] backhaul price (weight / unit a)
    backhaul_load: np.ndarray  # scalar or [K] expected metro uplink bits
    outer_iters: int           # dual-decomposition iterations run
    residual: float            # final coupled-KKT residual
    converged: bool            # residual <= outer_tol within the budget
    # True when the outer loop ran out of iterations: the state returned
    # is then the best-residual iterate seen, not the last step's
    hit_iter_cap: bool = False

    @property
    def resume(self) -> CoupledDuals:
        """Dual and warm state seeding the next tick's :func:`solve_coupled`."""
        return CoupledDuals(interference=self.interference, mu=self.mu,
                            warm=WarmStart(a=self.batch.a,
                                           power=self.batch.power))


def cell_interference(coupling: np.ndarray, a: np.ndarray,
                      power: np.ndarray) -> np.ndarray:
    """I_c = sum_{c'} G[c, c'] sum_i a_{c'i} P_{c'i}: the interference
    power each base station receives from the fleet's expected transmit
    powers.  ``a``/``power`` are ``[C, N]`` or ``[C, N, K]`` host arrays
    (padded slots carry a = 0); returns ``[C]`` or ``[C, K]``."""
    tx = np.asarray(a, np.float64) * np.asarray(power, np.float64)
    per_cell = tx.sum(axis=1)                  # [C] or [C, K]
    return np.asarray(coupling, np.float64) @ per_cell


def _knapsack_round(caps: np.ndarray, w: np.ndarray, s_bits: float,
                    budget: float) -> tuple[np.ndarray, float, float]:
    """Exact budget projection for one round: maximise ``sum w a`` over
    ``0 <= a <= caps`` s.t. ``sum a * s_bits <= budget``.

    Continuous knapsack with uniform per-unit cost: fill by decreasing
    weight, one fractional marginal element.  Returns ``(a, mu, load)``
    where ``mu`` is the marginal element's weight, the exact dual price
    of the budget (0 when it does not bind), so ``mu * (load - budget)
    == 0`` holds by construction.
    """
    caps = np.asarray(caps, np.float64).ravel()
    w = np.asarray(w, np.float64).ravel()
    total = caps.sum() * s_bits
    if total <= budget:
        return caps, 0.0, total
    order = np.argsort(-w, kind="stable")
    bits = caps[order] * s_bits
    csum = np.cumsum(bits)
    j = int(np.searchsorted(csum, budget, side="left"))
    a = np.zeros_like(caps)
    a[order[:j]] = caps[order[:j]]
    spent = csum[j - 1] if j > 0 else 0.0
    a[order[j]] = (budget - spent) / s_bits
    return a, float(w[order[j]]), float(budget)


def _backhaul_project(a_cap: np.ndarray, w: np.ndarray, s_bits: float,
                      budget: Optional[float]
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Apply the knapsack per round.  ``a_cap`` is ``[C, N]`` or
    ``[C, N, K]``; the budget applies to each round independently.
    Returns ``(a, mu, load)`` with ``mu``/``load`` scalar or ``[K]``.
    """
    a_cap = np.asarray(a_cap, np.float64)
    if budget is None:
        load = a_cap.sum(axis=(0, 1)) * s_bits    # scalar-0d or [K]
        return a_cap, np.zeros_like(load), load
    if a_cap.ndim == 2:
        a, mu, load = _knapsack_round(a_cap, w, s_bits, budget)
        return a.reshape(a_cap.shape), np.float64(mu), np.float64(load)
    k_rounds = a_cap.shape[-1]
    a = np.empty_like(a_cap)
    mu = np.zeros(k_rounds)
    load = np.zeros(k_rounds)
    for k in range(k_rounds):
        ak, mu[k], load[k] = _knapsack_round(a_cap[:, :, k], w, s_bits,
                                             budget)
        a[:, :, k] = ak.reshape(a_cap.shape[:2])
    return a, mu, load


def _with_interference(cells: ProblemBatch,
                       interference: np.ndarray) -> ProblemBatch:
    """``cells`` with per-cell interference ``[C]``/``[C, K]`` broadcast
    to every device slot, cast from float64 to float32 once.  An
    all-zero estimate is elided (the problem keeps its own
    ``interference`` leaf, ``None`` for a plain metro), so the
    zero-coupling path runs exactly the uncoupled solve."""
    interference = np.asarray(interference)
    if not interference.any():
        return cells
    c, n_max = cells.batch_size, cells.n_max
    if interference.ndim == 1:
        arr = np.broadcast_to(interference[:, None], (c, n_max))
    else:
        arr = np.broadcast_to(interference[:, None, :],
                              (c, n_max, interference.shape[-1]))
    base = cells.problem.interference
    if base is not None:                       # exogenous interference adds
        arr = arr + _host(base)
    leaf = torch.from_numpy(np.asarray(arr, np.float32)).to(cells.device)
    prob = dataclasses.replace(cells.problem, interference=leaf)
    return dataclasses.replace(cells, problem=prob)


def _relative_delta(old: np.ndarray, new: np.ndarray) -> float:
    scale = max(float(np.max(np.abs(old), initial=0.0)),
                float(np.max(np.abs(new), initial=0.0)), 1e-30)
    return float(np.max(np.abs(new - old), initial=0.0)) / scale


def _masked_weights(cells: ProblemBatch) -> np.ndarray:
    w = _host(cells.problem.weights).astype(np.float64)
    return np.where(_host(cells.mask), w, 0.0)


def _dual_shapes(cells: ProblemBatch):
    """``(I shape, K or None)``: ``[C]``, or ``[C, K]`` with fading."""
    fading = cells.problem.fading
    if fading is None:
        return (cells.batch_size,), None
    return (cells.batch_size, fading.shape[-1]), fading.shape[-1]


def solve_coupled(mc: MultiCellProblem,
                  *,
                  outer_iters: int = 25,
                  outer_tol: float = 1e-3,
                  damping: float = 0.5,
                  method: str = "fused",
                  power_solver: Optional[str] = None,
                  eps: float = 1e-7,
                  max_iters: int = 50,
                  chunk_elements: Optional[int] = None,
                  mesh=None,
                  shard: bool = True,
                  warm_start: bool = True,
                  sanitize: bool = False,
                  init: Optional[CoupledDuals] = None) -> MultiCellSolution:
    """Dual-decomposition solve of a coupled metro tick.

    Each outer iteration: (1) solve the union (cell, device) element set
    with the interference estimate ``I`` in the ``interference`` leaf,
    one ``solve_joint_batch`` call on the cells' device; (2) project the
    per-element caps ``a*`` onto the shared backhaul budget with the
    exact knapsack price ``mu``; (3) recompute ``I`` from the projected
    solution and relax it with ``damping`` (1.0: the undamped fixed
    point).  Stops when the coupled-KKT residual (the larger of the
    relative interference change and the relative price change) drops
    to ``outer_tol``, or after ``outer_iters``.

    ``init`` (a :class:`CoupledDuals`, typically ``prev.resume``)
    warm-starts ``(I, mu)`` and the element iterates; state of another
    shape is ignored (a cold start).  ``sanitize=True`` goes to
    ``solve_joint_batch``.  If the loop exhausts ``outer_iters`` the
    solution returned is the best-residual iterate seen, with
    ``hit_iter_cap=True``.
    """
    cells = mc.cells
    if damping <= 0.0 or damping > 1.0:
        raise ValueError(f"damping must be in (0, 1], got {damping}")
    if outer_iters < 1:
        raise ValueError(f"outer_iters must be >= 1, got {outer_iters}")
    coupling = _host(mc.coupling).astype(np.float64)
    i_shape, k_rounds = _dual_shapes(cells)
    per_round = k_rounds is not None
    s_bits = cells.problem.grad_size_bits
    w = _masked_weights(cells)

    interference = np.zeros(i_shape)
    mu = np.zeros(k_rounds) if per_round else np.float64(0.0)
    warm = None
    if init is not None:
        if np.shape(init.interference) == i_shape:
            interference = np.asarray(init.interference, np.float64)
        if np.shape(init.mu) == np.shape(mu):
            mu = np.asarray(init.mu, np.float64)
        if warm_start and init.warm is not None:
            sol_shape = i_shape[:1] + (cells.n_max,) + i_shape[1:]
            if tuple(init.warm.a.shape) == sol_shape:
                warm = init.warm

    bs = None
    a_proj = None
    load = np.zeros(k_rounds) if per_round else np.float64(0.0)
    residual, converged, t = float("inf"), False, 0
    best = None   # best-residual iterate: (residual, bs, a_proj, mu, load, I)
    for t in range(1, outer_iters + 1):  # noqa: B007 - read after the loop
        bs = solve_joint_batch(
            _with_interference(cells, interference), method=method,
            power_solver=power_solver, eps=eps, max_iters=max_iters,
            chunk_elements=chunk_elements, mesh=mesh, shard=shard,
            sanitize=sanitize, init=warm if warm_start else None)
        # one read of the solution back to the host per outer step
        a_np, p_np = torch.stack([bs.a, bs.power]).cpu().numpy()
        if mc.backhaul_bits is None:
            # no projection: the solver's arrays stay untouched, so the
            # zero-coupling path equals the uncoupled solve bit for bit
            a_proj = bs.a
            mu_new = np.zeros_like(mu)
            load = a_np.astype(np.float64).sum(axis=(0, 1)) * s_bits
            i_src = a_np.astype(np.float64)
        else:
            a_proj, mu_new, load = _backhaul_project(a_np, w, s_bits,
                                                     mc.backhaul_bits)
            i_src = a_proj
        i_new = cell_interference(coupling, i_src, p_np)
        residual = max(_relative_delta(interference, i_new),
                       _relative_delta(np.atleast_1d(mu),
                                       np.atleast_1d(mu_new)))
        converged = residual <= outer_tol
        if best is None or residual < best[0]:
            best = (residual, bs, a_proj, mu_new, load, i_new)
        interference = i_new if converged or damping >= 1.0 \
            else interference + damping * (i_new - interference)
        mu = mu_new
        if warm_start:
            warm = bs.resume
        if converged:
            break

    hit_iter_cap = not converged
    if hit_iter_cap:
        # the iteration cap: hand back the best-residual iterate seen,
        # not whatever the last (possibly oscillating) step produced
        residual, bs, a_proj, mu, load, interference = best

    if mc.backhaul_bits is None:
        final = bs
    else:
        w_b = w if a_proj.ndim == 2 else w[:, :, None]
        objective = np.sum(a_proj * w_b, axis=tuple(range(1, a_proj.ndim)))
        final = bs._replace(
            a=torch.from_numpy(a_proj.astype(np.float32)).to(cells.device),
            objective=torch.from_numpy(objective.astype(np.float32)).to(
                cells.device))
    return MultiCellSolution(batch=final, interference=interference, mu=mu,
                             backhaul_load=load, outer_iters=t,
                             residual=residual, converged=converged,
                             hit_iter_cap=hit_iter_cap)


def solve_coupled_loop(mc: MultiCellProblem,
                       *,
                       outer_iters: int = 25,
                       outer_tol: float = 1e-3,
                       damping: float = 0.5,
                       power_solver: Optional[str] = None,
                       eps: float = 1e-7,
                       max_iters: int = 50) -> MultiCellSolution:
    """Reference implementation: the same dual decomposition with a
    python loop of per-cell ``solve_joint_fused`` calls per outer
    iteration instead of one union solve; the agreement oracle of
    :func:`solve_coupled`."""
    cells = mc.cells
    if outer_iters < 1:
        raise ValueError(f"outer_iters must be >= 1, got {outer_iters}")
    power_solver = power_solver or "analytic"
    problems = cells.unstack()
    coupling = _host(mc.coupling).astype(np.float64)
    i_shape, k_rounds = _dual_shapes(cells)
    per_round = k_rounds is not None
    s_bits = cells.problem.grad_size_bits
    w = _masked_weights(cells)
    n_max = cells.n_max

    def pad(x, n):
        pad_width = [(0, n_max - n)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(_host(x).astype(np.float64), pad_width)

    interference = np.zeros(i_shape)
    mu = np.zeros(k_rounds) if per_round else np.float64(0.0)
    a_pad = np.zeros(i_shape[:1] + (n_max,) + i_shape[1:])
    p_pad = np.zeros_like(a_pad)
    residual, converged, t = float("inf"), False, 0
    conv_all = True
    for t in range(1, outer_iters + 1):  # noqa: B007 - read after the loop
        sols = []
        for c, prob in enumerate(problems):
            i_c = interference[c]
            if np.any(i_c):
                shape = (prob.n_devices,) if not per_round \
                    else (prob.n_devices, k_rounds)
                leaf = np.broadcast_to(np.reshape(i_c, (1,) + i_c.shape),
                                       shape).astype(np.float32)
                prob = dataclasses.replace(
                    prob, interference=torch.from_numpy(leaf).to(cells.device))
            sols.append(solve_joint_fused(prob, power_solver=power_solver,
                                          eps=eps, max_iters=max_iters))
        a_pad = np.stack([pad(s.a, p.n_devices)
                          for s, p in zip(sols, problems)])
        p_pad = np.stack([pad(s.power, p.n_devices)
                          for s, p in zip(sols, problems)])
        conv_all = all(s.converged for s in sols)
        a_proj, mu_new, load = _backhaul_project(a_pad, w, s_bits,
                                                 mc.backhaul_bits)
        i_new = cell_interference(coupling, a_proj, p_pad)
        residual = max(_relative_delta(interference, i_new),
                       _relative_delta(np.atleast_1d(mu),
                                       np.atleast_1d(mu_new)))
        converged = residual <= outer_tol
        interference = i_new if converged or damping >= 1.0 \
            else interference + damping * (i_new - interference)
        mu = mu_new
        a_pad = a_proj
        if converged:
            break

    dev = cells.device
    w_b = w if a_pad.ndim == 2 else w[:, :, None]
    objective = np.sum(a_pad * w_b, axis=tuple(range(1, a_pad.ndim)))
    batch = BatchSolution(
        a=torch.from_numpy(a_pad.astype(np.float32)).to(dev),
        power=torch.from_numpy(p_pad.astype(np.float32)).to(dev),
        objective=torch.from_numpy(objective.astype(np.float32)).to(dev),
        n_iters=torch.full((mc.n_cells,), t, dtype=torch.int64, device=dev),
        converged=torch.full((mc.n_cells,), conv_all, dtype=torch.bool,
                             device=dev),
        mask=cells.mask)
    return MultiCellSolution(batch=batch, interference=interference, mu=mu,
                             backhaul_load=load, outer_iters=t,
                             residual=residual, converged=converged,
                             hit_iter_cap=not converged)
