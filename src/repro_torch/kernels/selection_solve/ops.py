"""Wrappers for the selection_solve kernels and their drop-in solvers.

``fused_solve`` and ``selection_solve`` take the four element operands of
any one shape.  For CPU tensors they run the plain versions of ``ref.py``;
for CUDA tensors they launch the kernels of ``csrc/selection_solve.cu``
on the current stream, or raise.

``solve_joint_fused_kernel`` (drop-in for ``core.alternating.solve_joint``
and ``solve_joint_fused``) and ``solve_joint_kernel`` (drop-in for
``core.optimal.solve_joint_optimal``) take one problem and return a
``JointSolution``.  The ``*_batch`` variants take a ``core.batch.ProblemBatch``
and return a ``BatchSolution``: problem (7) is separable per (instance,
device, round), so a whole batch is one launch over its flattened
``[B * N_max (* K)]`` elements.  Padded slots go through the kernel and
deselect themselves (a zero energy budget gives a* = 0).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alternating import JointSolution
from repro_torch.core.batch import (BatchSolution, ProblemBatch, batch_elements,
                                    fixed_steps_solution)
from repro_torch.core.problem import WirelessFLProblem
from repro_torch.kernels.cuda_lib import LAUNCHES, check_operands, launch
from repro_torch.kernels.selection_solve.ref import (N_ALT, N_BISECT,
                                                     fused_solve_ref,
                                                     selection_solve_ref)


def _outputs(pg, bw, emax, ec):
    check_operands(pg, bw, emax, ec, shape=pg.shape)
    return torch.empty_like(pg), torch.empty_like(pg)


def fused_solve(pg, bw, emax, ec, *, s_bits: float, tau: float,
                p_max: float, n_iters: int = N_ALT,
                faithful_eq13_typo: bool = False):
    """``(a*, P*)`` of the fused fixed point after ``n_iters`` steps."""
    if pg.device.type == "cpu":
        return fused_solve_ref(pg, bw, emax, ec, s_bits=s_bits, tau=tau,
                               p_max=p_max, n_iters=n_iters,
                               faithful_eq13_typo=faithful_eq13_typo)
    a, p = _outputs(pg, bw, emax, ec)
    p_feasible = float(np.float32(p_max * (1 + 1e-6)))
    launch("repro_fused_solve", pg.data_ptr(), bw.data_ptr(), emax.data_ptr(),
           ec.data_ptr(), a.data_ptr(), p.data_ptr(), pg.numel(),
           s_bits, tau, p_max, p_feasible, int(n_iters),
           int(bool(faithful_eq13_typo)))
    LAUNCHES["fused_solve"] += 1
    return a, p


def selection_solve(pg, bw, emax, ec, *, s_bits: float, tau: float,
                    p_max: float):
    """``(a*, P*)``: the exact per-element optimum by bisection."""
    if pg.device.type == "cpu":
        return selection_solve_ref(pg, bw, emax, ec, s_bits=s_bits, tau=tau,
                                   p_max=p_max)
    a, p = _outputs(pg, bw, emax, ec)
    launch("repro_selection_solve", pg.data_ptr(), bw.data_ptr(),
           emax.data_ptr(), ec.data_ptr(), a.data_ptr(), p.data_ptr(),
           pg.numel(), s_bits, tau, p_max)
    LAUNCHES["selection_solve"] += 1
    return a, p


def _refuse_bits(problem: WirelessFLProblem) -> None:
    if problem.bits is not None:
        raise ValueError(
            "the kernel solvers take the problem's single payload "
            "grad_size_bits; a bits leaf needs solve_joint_fused "
            "(or solve_joint / solve_joint_optimal)")


def _solve_elements(problem: WirelessFLProblem, solve, **kw):
    """Run ``solve`` over every element of the problem's path gain,
    flattened, and return ``(a*, P*)`` in the path gain's shape."""
    _refuse_bits(problem)
    pg = problem.path_gain()

    def flat(x):
        x = x if x.ndim == pg.ndim else x[:, None]
        return torch.broadcast_to(x, pg.shape).to(torch.float32).reshape(-1).contiguous()

    ops = [flat(x) for x in (pg, problem.bandwidth_hz,
                             problem.energy_budget_j,
                             problem.compute_energy())]
    a, p = solve(*ops, s_bits=problem.grad_size_bits, tau=problem.tau_th,
                 p_max=problem.p_max, **kw)
    return a.reshape(pg.shape), p.reshape(pg.shape)


def solve_joint_kernel(problem: WirelessFLProblem) -> JointSolution:
    """The exact optimum of (7) through the selection_solve kernel."""
    a, p = _solve_elements(problem, selection_solve)
    return JointSolution(a=a, power=p, objective=problem.objective(a),
                         n_iters=N_BISECT, converged=True)


def solve_joint_fused_kernel(problem: WirelessFLProblem, n_iters: int = N_ALT,
                             faithful_eq13_typo: bool = False) -> JointSolution:
    """Algorithm 2 through the fused_solve kernel (agreement with
    ``solve_joint`` <= 1e-5)."""
    a, p = _solve_elements(problem, fused_solve, n_iters=n_iters,
                           faithful_eq13_typo=faithful_eq13_typo)
    return JointSolution(a=a, power=p, objective=problem.objective(a),
                         n_iters=n_iters, converged=True)


def _solve_batch(batch: ProblemBatch, solve, steps: int,
                 **kw) -> BatchSolution:
    """One launch of ``solve`` over the batch's flattened element set."""
    _refuse_bits(batch.problem)
    el = batch_elements(batch)
    shape = el.pg.shape
    ops = [x.reshape(-1).contiguous() for x in (el.pg, el.bw, el.emax, el.ec)]
    a, p = solve(*ops, s_bits=batch.problem.grad_size_bits,
                 tau=batch.problem.tau_th, p_max=batch.problem.p_max, **kw)
    return fixed_steps_solution(batch, a.reshape(shape), p.reshape(shape), steps)


def solve_joint_kernel_batch(batch: ProblemBatch) -> BatchSolution:
    """``core.batch.solve_joint_batch(method="kernel")``: the exact
    per-element optimum of every instance, one selection_solve launch."""
    return _solve_batch(batch, selection_solve, N_BISECT)


def solve_joint_fused_kernel_batch(batch: ProblemBatch, n_iters: int = N_ALT,
                                   faithful_eq13_typo: bool = False
                                   ) -> BatchSolution:
    """``core.batch.solve_joint_batch(method="fused_kernel")``: Algorithm 2's
    fused fixed point on every instance, one fused_solve launch."""
    return _solve_batch(batch, fused_solve, n_iters, n_iters=n_iters,
                        faithful_eq13_typo=faithful_eq13_typo)
