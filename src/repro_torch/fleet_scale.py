"""Fleet-scale solves on the scenario registry, on the card.

The port's counterpart of ``examples/fleet_scale.py``, with its flags and
its rows.  Two axes of scale, both far beyond the paper's single
100-device instance:

1. **One fleet** (``--n``): the fused chunked solve against the fused
   flat solve, Algorithm 2, the bisection optimum and the two kernel
   solvers on one N-device draw of ``--scenario``.
2. **Many scenarios at once** (``--batch``): a ``ProblemBatch`` of i.i.d.
   draws at the scenario's registered fleet size, solved by
   ``solve_joint_batch`` with ``method="fused"``, the per-instance
   ``"alternating"``, the two kernel methods, and a per-instance loop of
   ``solve_joint``.

Each row prints the objective (a batch: the mean over its instances),
E[participants] (a batch: per instance), the time of one warm solve and
elements per second, ``feasible=`` (every element of every instance
within ``constraints_satisfied(rtol=1e-3)``) and the device.

    PYTHONPATH=src python -m repro_torch.fleet_scale --n 1000000
    PYTHONPATH=src python -m repro_torch.fleet_scale --scenario mega_fleet_100k --n 100000
    PYTHONPATH=src python -m repro_torch.fleet_scale --scenario rayleigh_fading --batch 64
    PYTHONPATH=src python -m repro_torch.fleet_scale --device cpu --n 2000 --batch 4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.alternating import solve_joint, solve_joint_fused
from repro_torch.core.batch import solve_joint_batch
from repro_torch.core.multicell import MultiCellProblem
from repro_torch.core.optimal import solve_joint_optimal
from repro_torch.core.scenarios import SCENARIOS, make_batch, make_problem
from repro_torch.device import resolve_device
from repro_torch.kernels.selection_solve.ops import (solve_joint_fused_kernel,
                                                     solve_joint_kernel)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _bench(fn, dev: torch.device):
    """One warm-up call, then one timed call ending in a synchronise."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    sol = fn()
    _sync(dev)
    return sol, time.perf_counter() - t0


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _row(label, objective, participants, dt, n_elements, feasible, dev):
    print(f"{label:30s}: objective={objective:.6f} "
          f"E[participants]={participants:9.1f} {dt * 1e3:9.2f} ms "
          f"{n_elements / dt:14.0f} elements/s feasible={feasible} "
          f"[{device_name(dev)}]", flush=True)


def bench_single_fleet(scenario: str, n: int, chunk: int, dev) -> None:
    prob = make_problem(scenario, seed=0, n_devices=n, device=dev)
    if isinstance(prob, MultiCellProblem):
        raise SystemExit(f"{scenario!r} builds a coupled metro, not one fleet")
    n_elements = n * (prob.n_rounds if prob.fading is not None else 1)
    print(f"--- one {n}-device '{scenario}' fleet ({n_elements} elements) ---")
    solvers = [
        ("fused chunked (mega-fleet)",
         lambda: solve_joint_fused(prob, chunk_elements=chunk, shard=True)),
        ("fused flat (single launch)", lambda: solve_joint_fused(prob)),
        ("alternating (paper Alg 2)", lambda: solve_joint(prob)),
        ("bisection optimum (ours)", lambda: solve_joint_optimal(prob)),
        ("kernel (selection_solve)", lambda: solve_joint_kernel(prob)),
        ("fused kernel (fused_solve)", lambda: solve_joint_fused_kernel(prob)),
    ]
    for label, fn in solvers:
        sol, dt = _bench(fn, dev)
        feas = bool(prob.constraints_satisfied(sol.a, sol.power,
                                               rtol=1e-3).all())
        _row(label, float(sol.objective), float(sol.a.sum()), dt, n_elements,
             feas, dev)


def bench_scenario_batch(scenario: str, batch_size: int, dev) -> None:
    t0 = time.perf_counter()
    batch = make_batch(scenario, batch_size, seed=0, device=dev)
    _sync(dev)
    t_make = time.perf_counter() - t0
    problems = batch.unstack()
    rounds = batch.problem.n_rounds if batch.problem.fading is not None else 1
    n_elements = int(batch.fleet_sizes.sum()) * rounds
    print(f"--- {batch_size} x {SCENARIOS[scenario].n_devices}-device "
          f"'{scenario}' instances ({n_elements} elements; drawn and stacked "
          f"in {t_make * 1e3:.1f} ms) ---")

    def batch_row(label, method):
        sol, dt = _bench(lambda: solve_joint_batch(batch, method=method), dev)
        feas = all(bool(p.constraints_satisfied(
            sol.instance(b).a, sol.instance(b).power, rtol=1e-3).all())
            for b, p in enumerate(problems))
        _row(label, float(sol.objective.mean()), float(sol.a.sum()) / batch_size,
             dt, n_elements, feas, dev)
        return dt

    dt_fused = batch_row("fused (flat element set)", "fused")
    dt_alt = batch_row("alternating (per instance)", "alternating")
    batch_row("kernel (one launch)", "kernel")
    batch_row("fused kernel (one launch)", "fused_kernel")

    def loop():
        return [solve_joint(p) for p in problems]

    sols, dt_loop = _bench(loop, dev)
    feas = all(bool(p.constraints_satisfied(s.a, s.power, rtol=1e-3).all())
               for p, s in zip(problems, sols))
    _row("per-instance python loop", sum(float(s.objective) for s in sols)
         / batch_size, sum(float(s.a.sum()) for s in sols) / batch_size,
         dt_loop, n_elements, feas, dev)
    print(f"fused speedup: {dt_alt / dt_fused:.1f}x vs batched alternating, "
          f"{dt_loop / dt_fused:.1f}x vs loop")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000,
                    help="fleet size for the single-fleet comparison")
    ap.add_argument("--scenario", default="paper_static",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--batch", type=int, default=32,
                    help="number of stacked scenario instances")
    ap.add_argument("--chunk-elements", type=int, default=16_384,
                    help="fused mega-fleet memory bound (elements per chunk)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bench_single_fleet(args.scenario, args.n, args.chunk_elements, dev)
    bench_scenario_batch(args.scenario, args.batch, dev)


if __name__ == "__main__":
    main()
