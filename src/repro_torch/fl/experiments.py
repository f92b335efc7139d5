"""Paper experiment reproduction: Figures 1-2 and Tables I-IV.

Two scenarios (Sec. V-A):
  * highly biased:  Dirichlet beta = 0.1, tau^th = 0.08 s
  * mildly biased:  Dirichlet beta = 0.3, tau^th = 0.5 s

Four strategies; probabilistic/uniform results averaged over ``n_runs``
seeds.  Accuracy targets are re-anchored to the synthetic dataset, as in
``repro.fl.experiments``.

Two engines drive the grid (``engine=``): ``"loop"`` runs ``run_fl`` per
(strategy, seed); ``"scan"`` advances every trajectory of the grid
together (``repro_torch.fl.scan_engine``), fusing scenarios whose shapes
agree into one sweep.

The grid trains with the stacked eq.-4 path, whose server sum is the
``masked_aggregate`` wrapper: the kernel on the card, its plain version
on the CPU.  Beside the reference's solvers, ``ScenarioSpec.solver``
takes the selection_solve kernels' drop-in solves, ``"fused_kernel"``
(Algorithm 2's fixed point at a fixed trip count) and ``"kernel"`` (the
exact optimum), for the probabilistic and uniform strategies; their
solution is the state the engines plan with.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.problem import sample_problem
from repro_torch.core.alternating import JointSolution
from repro_torch.core.schedulers import ProbabilisticScheduler, make_scheduler
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl.engine import FLConfig, FLHistory, run_fl
from repro_torch.kernels.selection_solve.ops import (solve_joint_fused_kernel,
                                                    solve_joint_kernel)

STRATEGIES = ("probabilistic", "deterministic", "uniform", "equally_weighted")
_STOCHASTIC = ("probabilistic", "uniform")


@dataclasses.dataclass
class ScenarioSpec:
    name: str
    beta: float
    tau_th: float
    targets: tuple[float, float]
    n_devices: int = 100
    n_train: int = 12_000
    n_test: int = 2_000
    n_rounds: int = 400
    n_runs: int = 3
    lr: float = 0.1
    batch_per_client: int = 8
    eval_every: int = 10
    solver: str = "alternating"     # paper Algorithm 2; "fused"; "optimal"
                                    # = exact; "fused_kernel", "kernel"


HIGH_BIAS = ScenarioSpec("highly_biased", beta=0.1, tau_th=0.08,
                         targets=(0.50, 0.75))
MILD_BIAS = ScenarioSpec("mildly_biased", beta=0.3, tau_th=0.5,
                         targets=(0.60, 0.85))


def make_problem_and_data(spec: ScenarioSpec, seed: int, device=None):
    """The scenario's problem (on ``device``), datasets and partition."""
    train, test = make_mnist_like(spec.n_train, spec.n_test, seed=seed)
    parts = dirichlet_partition(train, spec.n_devices, spec.beta, seed=seed + 1)
    sizes = np.array([len(p) for p in parts])
    problem = sample_problem(seed + 2, spec.n_devices, tau_th=spec.tau_th,
                             dirichlet_sizes=sizes, device=device)
    return problem, train, parts, test


KERNEL_SOLVERS = {"fused_kernel": solve_joint_fused_kernel,
                  "kernel": solve_joint_kernel}


@dataclasses.dataclass(frozen=True)
class _KernelSolved(ProbabilisticScheduler):
    """The probabilistic strategy with its joint solve on a selection_solve
    kernel, named by ``solver`` in ``KERNEL_SOLVERS``."""

    def solve(self, problem) -> JointSolution:
        return KERNEL_SOLVERS[self.solver](problem)


def _probabilistic(spec: ScenarioSpec) -> ProbabilisticScheduler:
    if spec.solver in KERNEL_SOLVERS:
        return _KernelSolved(solver=spec.solver)
    return ProbabilisticScheduler(solver=spec.solver)


def _scheduler(name: str, problem, spec: ScenarioSpec):
    if name == "uniform":
        st = _probabilistic(spec).precompute(problem)
        m = max(1, int(round(float(st.a.sum()))))
        return make_scheduler("uniform", m=m)
    if name == "probabilistic":
        return _probabilistic(spec)
    return make_scheduler(name)


def _run_config(spec: ScenarioSpec, seed0: int, run: int) -> FLConfig:
    return FLConfig(n_rounds=spec.n_rounds, lr=spec.lr,
                    batch_per_client=spec.batch_per_client,
                    eval_every=spec.eval_every, aggregate="stacked",
                    seed=seed0 + 101 * run)


def run_scenario(spec: ScenarioSpec, seed0: int = 0,
                 strategies=STRATEGIES, verbose: bool = True,
                 engine: str = "loop", *, device=None) -> dict:
    """Returns {"spec": ..., "strategies": {strategy: summary}}."""
    if engine == "scan":
        return run_grid([spec], seed0, strategies, verbose, engine="scan",
                        device=device)[spec.name]
    if engine != "loop":
        raise ValueError(f"unknown engine {engine!r}; use 'loop' or 'scan'")
    dev = resolve_device(device)
    out: dict = {"spec": dataclasses.asdict(spec), "strategies": {}}
    for strat in strategies:
        runs = []
        n_runs = spec.n_runs if strat in _STOCHASTIC else 1
        for r in range(n_runs):
            problem, train, parts, test = make_problem_and_data(spec, seed0, dev)
            sch = _scheduler(strat, problem, spec)
            cfg = _run_config(spec, seed0, r)
            res = run_fl(problem, sch, train, parts, test, cfg, device=dev)
            runs.append(res.history)
            if verbose:
                _print_run(spec.name, strat, r, res.history)
        out["strategies"][strat] = _summarise(runs, spec.targets)
    return out


def _print_run(spec_name: str, strat: str, r: int, h: FLHistory) -> None:
    print(f"  {spec_name}/{strat} run{r}: final_acc={h.eval_acc[-1]:.3f} "
          f"time={h.sim_time[-1]:.0f}s energy={h.energy[-1]:.0f}J",
          flush=True)


# ------------------------------------------------------ sweep engine

def build_scenario_plans(spec: ScenarioSpec, seed0: int = 0,
                         strategies=STRATEGIES, dataset_id: int = 0,
                         device=None):
    """The scenario's (strategy x seed) grid as trajectory plans, one
    scheduler solve per strategy shared across its seeds.  Returns
    ``(plans, labels, configs, train, test)``."""
    from repro_torch.fl.scan_engine import plan_trajectory

    problem, train, parts, test = make_problem_and_data(spec, seed0, device)
    plans, labels, configs = [], [], []
    for strat in strategies:
        sch = _scheduler(strat, problem, spec)
        state = sch.precompute(problem)
        n_runs = spec.n_runs if strat in _STOCHASTIC else 1
        for r in range(n_runs):
            cfg = _run_config(spec, seed0, r)
            plans.append(plan_trajectory(problem, sch, parts, cfg,
                                         state=state, dataset_id=dataset_id))
            labels.append(strat)
            configs.append(cfg)
    return plans, labels, configs, train, test


def _group_summaries(histories, labels, targets, spec_name, verbose) -> dict:
    out: dict = {}
    for strat in dict.fromkeys(labels):
        runs = [h for h, s in zip(histories, labels) if s == strat]
        if verbose:
            for r, h in enumerate(runs):
                _print_run(spec_name, strat, r, h)
        out[strat] = _summarise(runs, targets)
    return out


def _scan_compatible(specs) -> bool:
    keys = [(s.n_rounds, s.eval_every, s.batch_per_client, s.n_devices,
             s.n_train, s.n_test) for s in specs]
    return all(k == keys[0] for k in keys)


def run_grid(specs, seed0: int = 0, strategies=STRATEGIES,
             verbose: bool = True, engine: str = "scan", *,
             device=None) -> dict:
    """The full (seed x strategy x scenario) grid, scenario-keyed results.

    With ``engine="scan"`` and shape-compatible specs (the paper's two
    scenarios qualify) every trajectory of every scenario is one row of a
    single sweep; otherwise one call per scenario.
    """
    if engine == "loop" or (engine == "scan" and not _scan_compatible(specs)):
        return {spec.name: run_scenario(spec, seed0, strategies, verbose,
                                        engine=engine, device=device)
                for spec in specs}
    if engine != "scan":
        raise ValueError(f"unknown engine {engine!r}; use 'loop' or 'scan'")

    from repro_torch.fl.scan_engine import (init_sweep_params, run_fl_sweep,
                                            stack_plans)

    dev = resolve_device(device)
    plans, labels, configs, trains, tests, spans = [], [], [], [], [], []
    for i, spec in enumerate(specs):
        p, lab, cfg, train, test = build_scenario_plans(
            spec, seed0, strategies, dataset_id=i, device=dev)
        spans.append((len(plans), len(plans) + len(p)))
        plans += p
        labels += lab
        configs += cfg
        trains.append(train)
        tests.append(test)

    sweep = run_fl_sweep(stack_plans(plans), trains, tests, configs[0],
                         init_sweep_params(configs, device=dev), device=dev)
    out = {}
    for spec, (lo, hi) in zip(specs, spans):
        out[spec.name] = {
            "spec": dataclasses.asdict(spec), "engine": "scan",
            "strategies": _group_summaries(sweep.histories[lo:hi],
                                           labels[lo:hi], spec.targets,
                                           spec.name, verbose)}
    return out


def _summarise(runs: list[FLHistory], targets) -> dict:
    lo, hi = targets
    t_lo = [h.time_to_accuracy(lo) for h in runs]
    t_hi = [h.time_to_accuracy(hi) for h in runs]
    e_lo = [h.energy_to_accuracy(lo) for h in runs]
    e_hi = [h.energy_to_accuracy(hi) for h in runs]

    def agg(vals):
        vals = np.asarray(vals, float)
        if np.all(np.isnan(vals)):
            return None
        return float(np.nanmean(vals))

    return {
        "curves": [{"time": h.eval_time.tolist(),
                    "acc": h.eval_acc.tolist()} for h in runs],
        "final_acc": float(np.mean([h.eval_acc[-1] for h in runs])),
        "mean_participants": float(np.mean([h.participants.mean() for h in runs])),
        "total_time_s": float(np.mean([h.sim_time[-1] for h in runs])),
        "total_energy_j": float(np.mean([h.energy[-1] for h in runs])),
        "table": {
            "time_to_low": agg(t_lo), "time_to_high": agg(t_hi),
            "energy_to_low": agg(e_lo), "energy_to_high": agg(e_hi),
        },
    }


def format_tables(result: dict, spec: ScenarioSpec) -> str:
    lo, hi = spec.targets
    lines = [f"\n=== {spec.name}: time/energy to accuracy "
             f"({lo:.0%} / {hi:.0%}) — paper Tables "
             f"{'I-II' if spec.beta < 0.2 else 'III-IV'} analogue ==="]
    lines.append(f"{'strategy':20s} {'t@lo (s)':>10} {'t@hi (s)':>10} "
                 f"{'E@lo (J)':>10} {'E@hi (J)':>10}")

    def fmt(v):
        return "NA".rjust(10) if v is None else f"{v:10.0f}"

    for strat, res in result["strategies"].items():
        t = res["table"]
        lines.append(f"{strat:20s} {fmt(t['time_to_low'])} "
                     f"{fmt(t['time_to_high'])} {fmt(t['energy_to_low'])} "
                     f"{fmt(t['energy_to_high'])}")
    return "\n".join(lines)
