"""Batched multi-scenario fleet solve: many problem (7) instances at once.

As ``repro.core.batch``:

* ``ProblemBatch`` holds ``WirelessFLProblem`` leaves stacked to
  ``[B, N_max]`` (``[B, N_max, K]`` with fading), ragged fleet sizes
  padded with :data:`core.problem.NEUTRAL_FILLS` and marked by a
  ``[B, N_max]`` validity ``mask``.  A padded slot has a zero energy
  budget, so every solver deselects it (a* = 0) with no change.
* ``stack_problems`` / ``ProblemBatch.unstack`` build and split a batch.
  Stacking runs in numpy on the host and copies each field to the device
  once: on the serving path B x fields small device copies would cost
  far more than the copy of one stacked array.
* ``solve_joint_batch`` solves every instance, by one of five methods.

The reference maps the per-instance solvers over the batch axis with
``jax.vmap``.  Here the batch axis is written out.  The per-instance
methods of ``WirelessFLProblem`` choose their broadcasting by rank, so
they never see a stacked leaf: a ``[B, N]`` leaf would read as one
``[N, K]`` fading problem.  What is per device (the path gain) is
computed on the union of the batch's device slots, where a ``[B, N]``
leaf becomes ``[B * N]`` and keeps its rank's meaning; what is per
instance (objectives, stopping rules, iteration counts) reduces over the
batch axis here.

``alternating`` runs Algorithm 2 on every instance in lockstep, each
instance frozen once its own stopping rule holds, so each keeps its own
``n_iters``, ``converged`` and inner (Dinkelbach) count, as under
``vmap``; ``fused`` runs one convergence-masked loop over the whole
flattened element set, with one shared count.  The port runs on one
device: ``mesh`` is refused and ``shard`` changes nothing.  Warm starts
(``init=``) and ``sanitize=True`` come with the serving slice and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.alternating import (
    FleetElements,
    JointSolution,
    _fused_step,
    _not_in_this_slice,
    fused_fixed_point_flat,
    fused_init,
)
from repro_torch.core.optimal import N_BISECT, optimal_elements
from repro_torch.core.problem import (
    _BITS_FILL,
    _FADING_FILL,
    _INTERFERENCE_FILL,
    _TENSOR_FIELDS,
    NEUTRAL_FILLS,
    WirelessFLProblem,
)
from repro_torch.device import resolve_device

# static (non-tensor) fields, shared batch-wide
_STATIC_FIELDS = ("grad_size_bits", "noise_power", "p_max", "tau_th",
                  "kappa", "n_rounds")
# the fill of every tensor leaf's padded slots
_FILLS = dict(NEUTRAL_FILLS, fading=_FADING_FILL,
              interference=_INTERFERENCE_FILL, bits=_BITS_FILL)


class BatchSolution(NamedTuple):
    """Stacked per-instance solutions; every tensor leads with the batch
    axis."""

    a: torch.Tensor           # [B, N_max] (or [B, N_max, K])
    power: torch.Tensor       # same shape as a
    objective: torch.Tensor   # [B]
    n_iters: torch.Tensor     # [B] int
    converged: torch.Tensor   # [B] bool
    mask: torch.Tensor        # [B, N_max] bool: the real device slots
    # summed inner power-solver iterations: [B], or one int for the fused
    # method's shared loop (0 in the closed-form modes)
    inner_iters: torch.Tensor | int = 0
    # chosen uplink widths (method="fused" with a bit_menu), else None
    bits: Optional[torch.Tensor] = None

    def instance(self, b: int) -> JointSolution:
        """Instance ``b``'s ``JointSolution``, padding stripped."""
        n = int(self.mask[b].sum())
        inner = self.inner_iters
        return JointSolution(
            a=self.a[b, :n], power=self.power[b, :n],
            objective=self.objective[b], n_iters=int(self.n_iters[b]),
            converged=bool(self.converged[b]),
            inner_iters=int(inner[b]) if isinstance(inner, torch.Tensor)
            else int(inner),
            bits=None if self.bits is None else self.bits[b, :n])


@dataclasses.dataclass(frozen=True)
class ProblemBatch:
    """B stacked ``WirelessFLProblem`` instances, padded to a common N_max.

    ``problem`` holds the stacked leaves; its constants are the batch's
    shared ones.  ``mask[b, i]`` is True iff slot ``i`` of instance ``b``
    is a real device; ``fleet_sizes[b]`` is instance ``b``'s own N.
    """

    problem: WirelessFLProblem
    mask: torch.Tensor          # [B, N_max] bool
    fleet_sizes: torch.Tensor   # [B] int32

    @property
    def batch_size(self) -> int:
        return int(self.mask.shape[0])

    @property
    def n_max(self) -> int:
        return int(self.mask.shape[1])

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def unstack(self) -> list[WirelessFLProblem]:
        """The per-instance problems, padding stripped (views)."""
        out = []
        for b, n in enumerate(self.fleet_sizes.tolist()):
            leaves = {f: getattr(self.problem, f)[b, :n] for f in _TENSOR_FIELDS
                      if getattr(self.problem, f) is not None}
            out.append(dataclasses.replace(self.problem, **leaves))
        return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pad_tail(x, n_max: int, fill: float) -> np.ndarray:
    x = _host(x)
    pad = [(0, n_max - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def _all_or_none(problems, leaf: str, hint: str) -> None:
    n = sum(getattr(p, leaf) is not None for p in problems)
    if 0 < n < len(problems):
        raise ValueError(
            f"{n}/{len(problems)} instances carry {leaf}; {leaf} must be "
            f"all-or-none per batch ({hint})")
    if n and len({getattr(p, leaf).ndim for p in problems}) > 1:
        raise ValueError(f"{leaf} rank ([N] vs [N, K]) must be uniform "
                         "across the batch")


def stack_problems(problems: Sequence[WirelessFLProblem], *,
                   device=None) -> ProblemBatch:
    """Stack instances into a ProblemBatch on ``device`` (default: the
    card), padding ragged fleet sizes.

    All instances must share the constants (``p_max``, ``tau_th``,
    ``grad_size_bits``, ``noise_power``, ``kappa``, ``n_rounds``); they may
    differ in fleet size and in every per-device tensor.  Fading,
    interference and bits are each all-or-none, of one rank: a non-fading
    instance solves one [N] round, a fading one [N, K], so mixing them
    would silently change the former's objective.  Give a static-channel
    instance explicit unit fading (a quiet cell zero interference, a
    full-precision instance bits 32) to mix it in.
    """
    if not problems:
        raise ValueError("stack_problems needs at least one problem")
    ref = problems[0]
    for p in problems[1:]:
        for f in _STATIC_FIELDS:
            if getattr(p, f) != getattr(ref, f):
                raise ValueError(
                    f"static field {f!r} differs across the batch "
                    f"({getattr(p, f)} vs {getattr(ref, f)}); solve instances "
                    "with differing statics in separate batches")
    _all_or_none(problems, "fading", "give static-channel instances "
                 "explicit unit fading to mix them in")
    _all_or_none(problems, "interference", "give quiet cells explicit zero "
                 "interference to mix them in")
    _all_or_none(problems, "bits", "give full-precision instances explicit "
                 "bits=32 to mix them in")

    dev = resolve_device(device)
    n_max = max(p.n_devices for p in problems)
    leaves = {}
    for name in _TENSOR_FIELDS:
        if getattr(ref, name) is not None:
            stacked = np.stack([_pad_tail(getattr(p, name), n_max, _FILLS[name])
                                for p in problems])
            leaves[name] = torch.from_numpy(stacked).to(dev)
    sizes = np.array([p.n_devices for p in problems], np.int32)
    mask = np.arange(n_max)[None, :] < sizes[:, None]
    return ProblemBatch(problem=dataclasses.replace(ref, **leaves),
                        mask=torch.from_numpy(mask).to(dev),
                        fleet_sizes=torch.from_numpy(sizes).to(dev))


def _pad_rows(x: torch.Tensor, rows: int, cols: int, fill) -> torch.Tensor:
    out = x.new_full((rows, cols) + tuple(x.shape[2:]), fill)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def pad_batch(batch: ProblemBatch, *, batch_size: Optional[int] = None,
              n_max: Optional[int] = None) -> ProblemBatch:
    """Pad a batch to fixed ``(batch_size, n_max)`` slot shapes.

    Padded instance rows take the neutral fills (every solver deselects
    them), an all-False mask row and fleet size 0;
    ``BatchSolution.instance`` never exposes them.  Shrinking is refused.
    """
    b0, n0 = batch.batch_size, batch.n_max
    bsz = b0 if batch_size is None else batch_size
    nmx = n0 if n_max is None else n_max
    if bsz < b0 or nmx < n0:
        raise ValueError(f"pad_batch cannot shrink ({b0}, {n0}) -> "
                         f"({bsz}, {nmx})")
    if (bsz, nmx) == (b0, n0):
        return batch
    leaves = {f: _pad_rows(getattr(batch.problem, f), bsz, nmx, _FILLS[f])
              for f in _TENSOR_FIELDS if getattr(batch.problem, f) is not None}
    sizes = batch.fleet_sizes.new_zeros(bsz)
    sizes[:b0] = batch.fleet_sizes
    return ProblemBatch(problem=dataclasses.replace(batch.problem, **leaves),
                        mask=_pad_rows(batch.mask, bsz, nmx, False),
                        fleet_sizes=sizes)


# ----------------------------------------------------------------- solver

def _union(problem: WirelessFLProblem) -> WirelessFLProblem:
    """The batch's instances as one problem over the union of their device
    slots: every ``[B, N(, K)]`` leaf becomes ``[B * N(, K)]``."""
    return dataclasses.replace(problem, **{
        f: getattr(problem, f).flatten(0, 1) for f in _TENSOR_FIELDS
        if getattr(problem, f) is not None})


def batch_objectives(weights: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Objective (7a) of each instance: ``[B]`` sums of ``a * w``."""
    w = weights if a.ndim == weights.ndim else weights[..., None]
    return (a * w).flatten(1).sum(dim=1)


def batch_elements(batch: ProblemBatch) -> FleetElements:
    """Stacked per-element constraint data, ``[B, N_max]`` or
    ``[B, N_max, K]``."""
    problem = batch.problem
    pg = _union(problem).path_gain().unflatten(0, (batch.batch_size,
                                                   batch.n_max))

    def b(x):
        return torch.broadcast_to(x[..., None] if x.ndim < pg.ndim else x,
                                  pg.shape)

    return FleetElements(pg=pg, bw=b(problem.bandwidth_hz),
                         emax=b(problem.energy_budget_j),
                         ec=b(problem.compute_energy()),
                         sbits=None if problem.bits is None
                         else b(problem.grad_size_bits * problem.bits / 32.0))


def _mask_solution(sol: JointSolution, mask: torch.Tensor) -> BatchSolution:
    m = mask if sol.a.ndim == mask.ndim else mask[..., None]
    return BatchSolution(a=torch.where(m, sol.a, 0.0),
                         power=torch.where(m, sol.power, 0.0),
                         objective=sol.objective, n_iters=sol.n_iters,
                         converged=sol.converged, mask=mask,
                         inner_iters=sol.inner_iters,
                         bits=None if sol.bits is None
                         else torch.where(m, sol.bits, 32.0))


def _constants(problem: WirelessFLProblem) -> dict:
    return dict(s_bits=problem.grad_size_bits, tau=problem.tau_th,
                p_max=problem.p_max)


def _solve_alternating(batch: ProblemBatch, *, power_solver: str,
                       faithful_eq13_typo: bool, eps: float,
                       max_iters: int) -> JointSolution:
    """Algorithm 2 on every instance in lockstep: ``solve_joint``'s steps
    and stopping rule, each instance frozen once its own rule holds."""
    el = batch_elements(batch)
    w = batch.problem.weights
    # solve_joint's a^0 is the corrected eq. (13) whatever the steps use
    a0, _ = fused_init(el, **_constants(batch.problem))
    kw = dict(_constants(batch.problem), faithful_eq13_typo=faithful_eq13_typo)
    a, p, inner = _fused_step(a0, el, power_solver=power_solver,
                              batch_dims=1, **kw)
    b = batch.batch_size
    inner = torch.zeros(b, dtype=torch.int64, device=a.device) + inner
    iters = torch.ones(b, dtype=torch.int64, device=a.device)
    obj, obj_prev = batch_objectives(w, a), batch_objectives(w, a0)

    def converged():
        return torch.abs(obj - obj_prev) < eps

    active = (iters < max_iters) & ~converged()
    while bool(active.any()):
        a_new, p_new, k = _fused_step(a, el, power_solver=power_solver,
                                      batch_dims=1, **kw)
        on = active.view((b,) + (1,) * (a.ndim - 1))
        a, p = torch.where(on, a_new, a), torch.where(on, p_new, p)
        obj_prev = torch.where(active, obj, obj_prev)
        obj = torch.where(active, batch_objectives(w, a), obj)
        iters += active
        inner += k * active
        active = (iters < max_iters) & ~converged()
    return JointSolution(a=a, power=p, objective=obj, n_iters=iters,
                         converged=converged(), inner_iters=inner)


def fixed_steps_solution(batch: ProblemBatch, a: torch.Tensor,
                         power: torch.Tensor, steps: int) -> BatchSolution:
    """The BatchSolution of a solver that runs ``steps`` steps on every
    element (the bisection, the kernels): every instance converged."""
    b = batch.batch_size
    sol = JointSolution(
        a=a, power=power, objective=batch_objectives(batch.problem.weights, a),
        n_iters=torch.full((b,), steps, dtype=torch.int64, device=a.device),
        converged=torch.ones(b, dtype=torch.bool, device=a.device))
    return _mask_solution(sol, batch.mask)


def _solve_fused(batch: ProblemBatch, *, power_solver: str,
                 faithful_eq13_typo: bool, eps: float, max_iters: int,
                 chunk_elements: Optional[int], shard: bool,
                 bit_menu: Optional[tuple]) -> JointSolution:
    """The fused flat path: one convergence-masked loop over the whole
    ``[B * N_max (* K)]`` element set, optionally chunked."""
    el = batch_elements(batch)
    shape = el.pg.shape
    flat = FleetElements(*(None if x is None else x.reshape(-1) for x in el))
    a, p, iters, conv, inner, *bits = fused_fixed_point_flat(
        flat, eps=eps, max_iters=max_iters, power_solver=power_solver,
        faithful_eq13_typo=faithful_eq13_typo, chunk_elements=chunk_elements,
        shard=shard, bit_menu=bit_menu, **_constants(batch.problem))
    a, p = a.reshape(shape), p.reshape(shape)
    b = batch.batch_size
    return JointSolution(
        a=a, power=p, objective=batch_objectives(batch.problem.weights, a),
        n_iters=torch.full((b,), iters, dtype=torch.int64, device=a.device),
        converged=conv.reshape(b, -1).all(dim=1), inner_iters=inner,
        bits=bits[0].reshape(shape) if bits else None)


def solve_joint_batch(batch: ProblemBatch,
                      *,
                      method: str = "alternating",
                      power_solver: Optional[str] = None,
                      faithful_eq13_typo: bool = False,
                      eps: float = 1e-7,
                      max_iters: int = 50,
                      shard: bool = True,
                      mesh=None,
                      chunk_elements: Optional[int] = None,
                      sanitize: bool = False,
                      init=None,
                      bit_menu: Optional[tuple] = None) -> BatchSolution:
    """Solve every instance of ``batch`` on its device.

    method:
      * ``"alternating"``  — Algorithm 2 (``solve_joint``) per instance,
        each with its own stopping rule and counts.
      * ``"fused"``        — the fused single-level solver
        (``fused_fixed_point_flat``) over the flattened element set: the
        same fixed point as ``"alternating"`` (<= 1e-5 elementwise), one
        shared count; honours ``chunk_elements``.
      * ``"optimal"``      — the exact bisection optimum
        (``solve_joint_optimal``) per instance.
      * ``"kernel"``       — the ``selection_solve`` kernel, one launch
        over the flattened ``[B * N_max (* K)]`` element set: the same
        problem as ``"optimal"``.
      * ``"fused_kernel"`` — the ``fused_solve`` kernel, one launch: the
        fused fixed point, ``max_iters`` steps per element.

    ``power_solver`` (default ``"dinkelbach"`` for ``"alternating"``,
    ``"analytic"`` for the fused methods), ``faithful_eq13_typo``, ``eps``
    and ``max_iters`` are Algorithm-2 knobs; the typo with a method that
    has no eq.-13 step is an error, as is ``power_solver="dinkelbach"``
    with ``"fused_kernel"`` and ``chunk_elements`` with anything but
    ``"fused"``.  Padded device slots come back with ``a = power = 0`` and
    weigh 0 in every objective.  ``bit_menu`` (``"fused"`` only) runs the
    joint bit/power/selection solve and fills ``BatchSolution.bits``.
    """
    if method not in ("alternating", "fused", "optimal", "kernel",
                      "fused_kernel"):
        raise ValueError(f"unknown method {method!r}")
    if mesh is not None:
        raise ValueError("the port runs on one device; mesh must be None")
    if bit_menu is not None and method != "fused":
        raise ValueError(
            f"bit_menu is implemented by the fused single-level solver "
            f"only; method={method!r} would silently ignore it")
    if method in ("kernel", "fused_kernel") and batch.problem.bits is not None:
        raise ValueError(
            "the kernel methods take a single static payload and would "
            "silently ignore the per-device bits leaf; use method='fused' "
            "(or 'alternating'/'optimal') for bit-scaled problems")
    if sanitize:
        _not_in_this_slice("sanitize=True", "the fault-handling slice")
    if init is not None:
        _not_in_this_slice("init= (warm starts)", "the serving slice")
    if method not in ("alternating", "fused", "fused_kernel") and faithful_eq13_typo:
        raise ValueError(
            f"faithful_eq13_typo only applies to the Algorithm-2 methods "
            f"('alternating'/'fused'/'fused_kernel'); method={method!r} "
            "computes the exact per-element optimum and has no eq. (13) step")
    if chunk_elements is not None and method != "fused":
        raise ValueError(
            f"chunk_elements is a method='fused' memory bound; "
            f"method={method!r} would silently ignore it")
    if power_solver is None:
        power_solver = ("analytic" if method in ("fused", "fused_kernel")
                        else "dinkelbach")
    if method == "fused_kernel" and power_solver != "analytic":
        raise ValueError(
            f"method='fused_kernel' only implements the analytic "
            f"(closed-form) power update; power_solver={power_solver!r} "
            "would be silently ignored — use method='fused' for the "
            "Dinkelbach reference mode")
    if method == "kernel":
        from repro_torch.kernels.selection_solve.ops import solve_joint_kernel_batch
        return solve_joint_kernel_batch(batch)
    if method == "fused_kernel":
        from repro_torch.kernels.selection_solve.ops import (
            solve_joint_fused_kernel_batch)
        # the kernel runs its whole budget: max_iters steps, no eps exit
        return solve_joint_fused_kernel_batch(
            batch, n_iters=max_iters, faithful_eq13_typo=faithful_eq13_typo)
    if method == "fused":
        sol = _solve_fused(batch, power_solver=power_solver,
                           faithful_eq13_typo=faithful_eq13_typo, eps=eps,
                           max_iters=max_iters, chunk_elements=chunk_elements,
                           shard=shard, bit_menu=bit_menu)
    elif method == "optimal":
        a, p = optimal_elements(batch_elements(batch), n_bisect=N_BISECT,
                                **_constants(batch.problem))
        return fixed_steps_solution(batch, a, p, N_BISECT)
    else:
        sol = _solve_alternating(batch, power_solver=power_solver,
                                 faithful_eq13_typo=faithful_eq13_typo,
                                 eps=eps, max_iters=max_iters)
    return _mask_solution(sol, batch.mask)
