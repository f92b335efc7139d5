"""Drift-aware closed-loop FL: online control plane -> sweep training.

The paper's Sec. V comparison under Gauss-Markov channel drift, as
``repro.fl.closed_loop``:

1. **per-round control** — round k's channel is ``slice_round(problem,
   k)`` of a drifting ([N, K]) trajectory.  Each round's selection
   probabilities and powers come from a warm-started
   :class:`~repro_torch.serve.FleetControlService` solve on that round's
   channel alone: the service's cell cache seeds round k's solve from
   round k-1's answer.  The answers come back to the host once a round.
2. **strategy layer** — the per-round solutions (and the raw channel)
   feed the benchmark strategies: the proposed probabilistic scheme,
   per-round deterministic top-k, uniform at P^max, channel-aware greedy,
   the Lyapunov virtual-queue scheduler, and the joint bit/power/
   selection scheme (``joint_bits``).
3. **training + accounting** — every strategy's plan becomes a
   :class:`~repro_torch.fl.scan_engine.TrajectoryPlan`, and every
   (strategy x seed) trajectory of the full-precision strategies runs in
   one sweep; ``joint_bits`` trains in a second, quantised sweep
   (``aggregate="stacked"``), whose server sum is the
   ``quantized_masked_aggregate`` kernel on the card.

The problem lives on the host, where a cell's channel report arrives;
the service solves on its device, and planning and both sweeps run on
``device`` (default: the service's, else the card).

Typical use::

    from repro_torch.fl.closed_loop import ClosedLoopConfig, run_closed_loop_grid
    out = run_closed_loop_grid(ClosedLoopConfig(n_devices=32, n_rounds=10))
    print(format_closed_loop_table(out))
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.core.alternating import WarmStart, solve_joint_fused
from repro_torch.core.problem import WirelessFLProblem
from repro_torch.core.scenarios import make_problem, slice_round
from repro_torch.core.schedulers import (
    DeterministicScheduler,
    GreedyChannelScheduler,
    LyapunovScheduler,
    ProbabilisticScheduler,
    SchedulerState,
    UniformScheduler,
    _data_weights,
    _round_preserving_count,
)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl.engine import FLConfig, FLHistory
from repro_torch.fl.scan_engine import (
    init_sweep_params,
    plan_trajectory,
    run_fl_sweep,
    stack_plans,
)
from repro_torch.serve.faults import FaultPlan, corrupt_problem, dropout_mask
from repro_torch.serve.fleet_service import FleetControlService, ServiceConfig

#: the paper-style comparison suite (Sec. V benchmarks, the two
#: stochastic-scheduling baselines, and the joint bit/power/selection
#: scheme)
CLOSED_LOOP_STRATEGIES = ("probabilistic", "deterministic", "uniform",
                          "greedy_channel", "lyapunov", "joint_bits")

#: strategies whose plans carry an uplink bit-width table: they train in
#: a separate quantised (stacked-aggregation) sweep
QUANTIZED_STRATEGIES = ("joint_bits",)


@dataclasses.dataclass(frozen=True)
class ClosedLoopConfig:
    """One closed-loop experiment: scenario, control plane, training."""

    scenario: str = "drifting_metro"
    n_devices: int = 32
    n_rounds: int = 10
    coherence: float = 0.9
    seed: int = 0
    n_seeds: int = 1              # FL seeds per strategy (shared control)
    # --- control plane ---------------------------------------------------
    service: ServiceConfig = ServiceConfig()
    uniform_m: Optional[int] = None   # None => expected count of a*
    greedy_m: Optional[int] = None    # None => expected count of a*
    lyapunov_v: float = 1e-4
    # uplink bit-width menu of the "joint_bits" strategy
    bit_menu: tuple = (8, 16, 32)
    # --- training --------------------------------------------------------
    n_train: int = 2048
    n_test: int = 512
    beta: float = 0.3             # Dirichlet label-skew
    lr: float = 0.1
    batch_per_client: int = 8
    eval_every: int = 5
    # Sec. II-C completion time: straggler tx time + local compute
    include_compute_time: bool = True
    tau_th: float = 0.5
    # --- fault tolerance ------------------------------------------------
    # channel corruption before the control pass (the service sanitises
    # it) plus per-trajectory upload drops in the sweep; None = the
    # pristine experiment
    fault_plan: Optional[FaultPlan] = None
    # every solved control round is checkpointed here, and a rerun
    # resumes after the last one; None = no checkpointing
    checkpoint_dir: Optional[str] = None


class ControlTrace:
    """Per-round control-plane outcome of one closed-loop run."""

    def __init__(self, a: torch.Tensor, power: torch.Tensor,
                 warm_rounds: int, inner_iters: int, outer_iters: int,
                 solve_seconds: float, service: FleetControlService):
        self.a = a                      # [N, K] solved probabilities (host)
        self.power = power              # [N, K] solved powers (host)
        self.warm_rounds = warm_rounds  # rounds whose solve was warm-started
        self.inner_iters = inner_iters
        self.outer_iters = outer_iters
        self.solve_seconds = solve_seconds
        self.service = service

    @property
    def n_rounds(self) -> int:
        return int(self.a.shape[1])


def solve_rounds(problem: WirelessFLProblem,
                 service: Optional[FleetControlService] = None,
                 *,
                 cell_id="cell-0",
                 checkpoint_dir: Optional[str] = None) -> ControlTrace:
    """Drive the online control plane over a drifting trajectory.

    Submits ``slice_round(problem, k)`` for k = 0..K-1 one round at a
    time and stitches the per-round ``[N, 1]`` answers into ``[N, K]``
    host tensors.  Round k > 0 warm-starts from round k-1's cached
    solution.  Without a ``service`` a fresh one solves on the card.

    ``checkpoint_dir`` makes the loop crash-safe at round granularity:
    every solved round is saved (``repro_torch.checkpoint``), and a rerun
    against a non-empty directory restores the completed columns,
    re-seeds the (fresh) service's warm caches from the last round's
    solution through :meth:`FleetControlService.seed_cell`, and continues
    at the next round.  Warm starts only shorten the iteration, so the
    resumed table equals the uninterrupted one bit for bit.
    """
    if problem.fading is None:
        raise ValueError("solve_rounds needs a fading ([N, K]) problem; "
                         "use a drifting scenario (e.g. 'drifting_metro')")
    if service is None:
        service = FleetControlService(ServiceConfig())
    k_rounds = problem.fading.shape[1]
    n = problem.n_devices
    a_cols, p_cols = [], []
    warm_rounds = inner = outer = 0
    t_solve = 0.0
    start_k = 0
    if checkpoint_dir is not None:
        step = checkpoint.latest_step(checkpoint_dir)
        if step is not None:
            tmpl = torch.zeros((n, step + 1), dtype=torch.float32)
            _, trees, _, extra = checkpoint.restore(
                checkpoint_dir, step,
                params_template={"a": tmpl, "power": tmpl})
            a_np, p_np = trees["a"].numpy(), trees["power"].numpy()
            a_cols = [a_np[:, k] for k in range(step + 1)]
            p_cols = [p_np[:, k] for k in range(step + 1)]
            warm_rounds = int(extra["warm_rounds"])
            inner = int(extra["inner_iters"])
            outer = int(extra["outer_iters"])
            t_solve = float(extra["solve_seconds"])
            # re-seed the warm caches as round ``step``'s solve left them
            service.seed_cell(cell_id, slice_round(problem, step),
                              WarmStart(a=trees["a"][:, step:],
                                        power=trees["power"][:, step:]))
            start_k = step + 1
    for k in range(start_k, k_rounds):
        resp, = service.run([(cell_id, slice_round(problem, k))])
        a_cols.append(np.asarray(resp.solution.a)[:, 0])
        p_cols.append(np.asarray(resp.solution.power)[:, 0])
        warm_rounds += bool(resp.warm_started)
        inner += int(resp.solution.inner_iters)
        outer += int(resp.solution.n_iters)
        t_solve += resp.latency_s
        if checkpoint_dir is not None:
            checkpoint.save(
                checkpoint_dir, k,
                {"a": np.stack(a_cols, axis=1).astype(np.float32),
                 "power": np.stack(p_cols, axis=1).astype(np.float32)},
                extra={"warm_rounds": warm_rounds, "inner_iters": inner,
                       "outer_iters": outer, "solve_seconds": t_solve})
    return ControlTrace(
        a=torch.from_numpy(np.stack(a_cols, axis=1).astype(np.float32)),
        power=torch.from_numpy(np.stack(p_cols, axis=1).astype(np.float32)),
        warm_rounds=warm_rounds, inner_iters=inner, outer_iters=outer,
        solve_seconds=t_solve, service=service)


def _expected_count(a: torch.Tensor) -> int:
    """round(mean over rounds of sum_i a_ik), >= 1: the M that makes the
    count-matched baselines (uniform, greedy) comparable to a*.  Summed
    on the host in numpy, as the reference sums."""
    return max(1, int(round(float(a.cpu().numpy().sum(axis=0).mean()))))


def joint_bits_state(problem: WirelessFLProblem, config: ClosedLoopConfig
                     ) -> tuple[object, SchedulerState, torch.Tensor]:
    """(scheduler, state, bits [N, K]) for the joint bit/power/selection
    scheme: one fused solve with the bit-allocation step over
    ``config.bit_menu``, on the problem's device.  Problem (7) stays
    separable per (i, k) with the bits variable, so the one-shot solve
    equals the per-round stream; what it adds is the per-device payload
    width b_ik the quantised sweep trains with."""
    sol = solve_joint_fused(problem, bit_menu=tuple(config.bit_menu))
    state = SchedulerState(a=sol.a, power=sol.power,
                           agg_weights=_data_weights(problem))
    return ProbabilisticScheduler(), state, sol.bits.to(torch.float32)


def strategy_state(name: str, problem: WirelessFLProblem,
                   control: ControlTrace, config: ClosedLoopConfig
                   ) -> tuple[object, SchedulerState]:
    """(scheduler, per-round SchedulerState) for one benchmark strategy.

    The proposed scheme and its deterministic rounding consume the
    control plane's per-round solutions; the baselines are count-matched
    (uniform, greedy) or budget-matched (Lyapunov) and ignore the solve.
    ``joint_bits`` re-solves with the bit-width menu (use
    :func:`joint_bits_state` when the bits table is needed too).
    """
    a = control.a.to(problem.device, torch.float32)          # [N, K]
    power = control.power.to(problem.device, torch.float32)
    alpha = _data_weights(problem)
    if name == "probabilistic":
        return (ProbabilisticScheduler(),
                SchedulerState(a=a, power=power, agg_weights=alpha))
    if name == "deterministic":
        a_bin = _round_preserving_count(a, per_round=True)
        return (DeterministicScheduler(per_round=True),
                SchedulerState(a=a_bin, power=power, agg_weights=alpha))
    if name == "uniform":
        m = config.uniform_m if config.uniform_m is not None \
            else _expected_count(control.a)
        sch = UniformScheduler(m=m)
        return sch, sch.precompute(problem)
    if name == "greedy_channel":
        m = config.greedy_m if config.greedy_m is not None \
            else _expected_count(control.a)
        sch = GreedyChannelScheduler(m=m)
        return sch, sch.precompute(problem)
    if name == "lyapunov":
        sch = LyapunovScheduler(v=config.lyapunov_v)
        return sch, sch.precompute(problem)
    if name == "joint_bits":
        sch, state, _ = joint_bits_state(problem, config)
        return sch, state
    raise KeyError(f"unknown closed-loop strategy {name!r}; "
                   f"choose from {CLOSED_LOOP_STRATEGIES}")


# ------------------------------------------------------------------ driver

def _fl_config(config: ClosedLoopConfig, run: int) -> FLConfig:
    return FLConfig(n_rounds=config.n_rounds, lr=config.lr,
                    batch_per_client=config.batch_per_client,
                    eval_every=config.eval_every,
                    include_compute_time=config.include_compute_time,
                    seed=config.seed + 101 * run)


def _summarise(history: FLHistory, state: SchedulerState,
               bits: Optional[torch.Tensor] = None) -> dict:
    a = state.a.cpu().numpy()
    exp_parts = float(a.sum(axis=0).mean()) if a.ndim == 2 \
        else float(a.sum())
    return {
        "expected_participants": exp_parts,
        "mean_participants": float(history.participants.mean()),
        # fleet-mean uplink payload width (32 = full-precision fp32)
        "mean_bits": 32.0 if bits is None
        else float(np.mean(bits.cpu().numpy())),
        "total_energy_j": float(history.energy[-1]),
        "completion_time_s": float(history.sim_time[-1]),
        "final_acc": float(history.eval_acc[-1]),
    }


def _faulted_problem(config: ClosedLoopConfig) -> WirelessFLProblem:
    """The config's drifting problem on the host, corrupted under its
    fault plan: one seeded pass per planned channel kind (the service's
    submit-time sanitiser is what is under test)."""
    problem = make_problem(config.scenario, seed=config.seed,
                           n_devices=config.n_devices,
                           n_rounds=config.n_rounds,
                           coherence=config.coherence,
                           tau_th=config.tau_th, device="cpu")
    plan = config.fault_plan
    if plan is not None:
        rng = np.random.default_rng(plan.seed)
        for kind in plan.channel_kinds:
            problem = corrupt_problem(problem, kind, rng=rng,
                                      device_rate=plan.device_rate,
                                      deep_fade_db=plan.deep_fade_db)
    return problem


def run_closed_loop_grid(config: Optional[ClosedLoopConfig] = None,
                         strategies: Sequence[str] = CLOSED_LOOP_STRATEGIES,
                         service: Optional[FleetControlService] = None,
                         *,
                         device=None,
                         **sweep_kw) -> dict:
    """The full closed-loop comparison on one drifting scenario.

    One warm-started control-plane pass over the trajectory (shared by
    the strategies that consume the solve), then every (strategy x seed)
    trajectory in one sweep per group (full precision, quantised).
    Returns ``{"config", "control", "strategies"}`` (and ``"faults"``
    under a fault plan), as the reference does, plus ``"seconds"``: the
    wall time of the control pass, the planning and each sweep.  Feed it
    to :func:`format_closed_loop_table` for the paper-style table.
    """
    config = config if config is not None else ClosedLoopConfig()
    dev = resolve_device(device if device is not None or service is None
                         else service.device)
    problem = _faulted_problem(config)
    plan = config.fault_plan
    train, test = make_mnist_like(config.n_train, config.n_test,
                                  seed=config.seed)
    parts = dirichlet_partition(train, config.n_devices, config.beta,
                                seed=config.seed + 1)

    if service is None:
        service = FleetControlService(config.service, device=dev)
    t0 = time.perf_counter()
    control = solve_rounds(problem, service,
                           checkpoint_dir=config.checkpoint_dir)
    t1 = time.perf_counter()

    # planning needs finite tx/energy tables even for corrupted devices
    # (health-blind baselines may still select them), so it consumes the
    # sanitised problem; identity when fault-free
    plan_problem = (problem if plan is None else problem.sanitize()[0]).to(dev)

    plans, labels, configs = [], [], []
    qplans, qlabels, qconfigs = [], [], []
    states: dict[str, SchedulerState] = {}
    bits_tables: dict[str, torch.Tensor] = {}
    n_plans = 0
    for name in strategies:
        quantized = name in QUANTIZED_STRATEGIES
        if quantized:
            sch, state, bits = joint_bits_state(plan_problem, config)
            bits_tables[name] = bits
            # the plan problem carries the solved widths, so the tx-time
            # and energy tables reflect the reduced payload (eq. 1)
            qprob = dataclasses.replace(plan_problem, bits=bits)
        else:
            sch, state = strategy_state(name, plan_problem, control, config)
        states[name] = state
        for run in range(max(config.n_seeds, 1)):
            cfg = _fl_config(config, run)
            drops = None if plan is None else dropout_mask(
                plan.seed + 31 * n_plans, config.n_rounds,
                config.n_devices, plan.drop_rate)
            n_plans += 1
            if quantized:
                cfg = dataclasses.replace(cfg, aggregate="stacked")
                qplans.append(plan_trajectory(qprob, sch, parts, cfg,
                                              state=state, drops=drops,
                                              bits=bits))
                qlabels.append(name)
                qconfigs.append(cfg)
            else:
                plans.append(plan_trajectory(plan_problem, sch, parts, cfg,
                                             state=state, drops=drops))
                labels.append(name)
                configs.append(cfg)
    t2 = time.perf_counter()

    histories: dict[str, list[FLHistory]] = {name: [] for name in strategies}
    sweep_s = {}
    for key, g_plans, g_labels, g_cfgs in (
            ("sweep", plans, labels, configs),
            ("quantized_sweep", qplans, qlabels, qconfigs)):
        t_g = time.perf_counter()
        if g_plans:
            sweep = run_fl_sweep(stack_plans(g_plans), train, test, g_cfgs[0],
                                 init_sweep_params(g_cfgs, device=dev),
                                 device=dev, **sweep_kw)
            for h, lbl in zip(sweep.histories, g_labels):
                histories[lbl].append(h)
        sweep_s[key] = time.perf_counter() - t_g

    # provenance: the service configuration actually used
    cfg_dict = dataclasses.asdict(config)
    cfg_dict["service"] = dataclasses.asdict(service.config)
    out: dict = {
        "config": cfg_dict,
        "control": {
            "warm_rounds": control.warm_rounds,
            "n_rounds": control.n_rounds,
            "inner_iters": control.inner_iters,
            "outer_iters": control.outer_iters,
            "solve_seconds": control.solve_seconds,
            "service": control.service.stats.summary(),
        },
        "strategies": {},
        "seconds": {"control": t1 - t0, "planning": t2 - t1, **sweep_s},
    }
    if plan is not None:
        health = problem.health_mask(xp=np)
        out["faults"] = {
            "plan": dataclasses.asdict(plan),
            "n_unhealthy_devices": int(health.size) - int(health.sum()),
            "drop_rate": plan.drop_rate,
        }
    for name in strategies:
        runs = [_summarise(h, states[name], bits=bits_tables.get(name))
                for h in histories[name]]
        out["strategies"][name] = {k: float(np.mean([r[k] for r in runs]))
                                   for k in runs[0]}
    return out


_COLUMNS = (("expected_participants", "E[|S|]", "{:8.2f}"),
            ("mean_participants", "mean|S|", "{:8.2f}"),
            ("mean_bits", "bits", "{:6.1f}"),
            ("total_energy_j", "energy(J)", "{:10.2f}"),
            ("completion_time_s", "time(s)", "{:9.2f}"),
            ("final_acc", "acc", "{:6.3f}"))


def format_closed_loop_table(result: dict) -> str:
    """The Sec.-V-style comparison table (cf. paper Tables I-IV)."""
    ctrl = result["control"]
    lines = [
        f"closed loop on {result['config']['scenario']} "
        f"(N={result['config']['n_devices']}, K={ctrl['n_rounds']}): "
        f"{ctrl['warm_rounds']}/{ctrl['n_rounds']} rounds warm-started, "
        f"{ctrl['inner_iters']} inner iters, "
        f"{ctrl['solve_seconds'] * 1e3:.1f} ms control plane",
        "strategy          " + " ".join(f"{h:>10}" for _, h, _ in _COLUMNS),
    ]
    for name, row in result["strategies"].items():
        cells = " ".join(f"{fmt.format(row[key]):>10}"
                         for key, _, fmt in _COLUMNS)
        lines.append(f"{name:<18}{cells}")
    return "\n".join(lines)
