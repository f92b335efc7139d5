"""Registered hot paths and their steady-state budgets.

The port's counterpart of ``repro.analysis.hotpaths``: the same five
production entry points, built from the reference builders' inputs and
sizes.  Each entry knows how to build a self-contained workload on a
device: a ``warmup()`` thunk that pays every first-call cost once (the
kernel library's build and load, the CUDA context, the allocator's
blocks), and a ``steady()`` thunk that re-runs the path on *fresh
same-shaped inputs* — the state a serving process lives in — and
returns its outputs, from which ``units`` reads the path's own count of
its work (outer iterations or rounds) after the measured scope.

``measure()`` wraps the warm-up in a :class:`~repro_torch.analysis.
recompile.BuildBudget` and the steady call in a ``BuildBudget`` and a
:class:`~repro_torch.analysis.recompile.HostSyncBudget`.  The steady
counts are compared against ``budgets.json`` beside this module by
:func:`check_budget` (``python -m repro_torch.analysis --gate``, the
tests and ``chip_smoke.py``):

* steady builds and loads: 0 for every path;
* host reads (a): an exact form ``fixed + per_unit x units``, plus
  ``to_host`` copies that only a path on a device other than the CPU
  makes (``recompile``'s docstring says why the CPU sees none);
* waits for the card (b): ``fixed + per_unit x units`` as measured on
  the card the entry names, checked where CUDA runs.

A count above its form fails the gate, and so does a read or wait at a
site that the entry's ``why`` does not name; the CPU tests hold (a)
equal to its form.

The sweep paths run ``aggregate="stacked"`` where the reference's
builders run its ``"fused"`` default: the stacked path is the one
``run_grid`` runs, and its eq.-4 sum is kernel 3 on the card.

Registering a new hot path::

    @register_hot_path("my_path", doc="one-line contract", unit="rounds")
    def _build_my_path(dev) -> HotPathRun:
        ...build inputs eagerly here (outside the measured scopes)...
        return HotPathRun(warmup=..., steady=..., units=...)

then give it an entry in ``budgets.json``: its builds and loads (0), the
forms of its reads and waits, and a ``why`` naming each read's site.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.analysis.recompile import BuildBudget, HostSyncBudget
from repro_torch.device import resolve_device
from repro_torch.kernels import cuda_lib

__all__ = [
    "HOT_PATHS",
    "HotPath",
    "HotPathRun",
    "check_budget",
    "default_budgets_path",
    "form_value",
    "load_budgets",
    "measure",
    "measure_all",
    "register_hot_path",
]


@dataclasses.dataclass
class HotPathRun:
    """Built workload: warmup pays the first-call costs, steady must not;
    ``units`` reads the path's count of its work from steady's outputs."""

    warmup: Callable[[], Any]
    steady: Callable[[], Any]
    units: Callable[[Any], int]


@dataclasses.dataclass(frozen=True)
class HotPath:
    name: str
    doc: str
    unit: str
    build: Callable[[torch.device], HotPathRun]


HOT_PATHS: dict[str, HotPath] = {}


def register_hot_path(name: str, *, doc: str, unit: str):
    """Decorator registering a hot-path builder under ``name``."""
    def wrap(build: Callable[[torch.device], HotPathRun]):
        HOT_PATHS[name] = HotPath(name=name, doc=doc, unit=unit, build=build)
        return build
    return wrap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(name: str, device=None, *, reps: int = 0) -> dict:
    """Build and run one hot path on ``device`` (default: the card).

    Returns the warm-up's and the steady call's builds and loads, the
    steady call's host reads (a) with their sites and kinds
    (``recompile.HostRead``), its waits
    for the card (b) with theirs (``None`` without CUDA), the kernel
    launches it made, and its units.  ``reps`` more steady calls, each
    ended by a synchronisation, give ``steady_ms`` (their median wall
    time; ``None`` without them).
    """
    dev = resolve_device(device)
    hp = HOT_PATHS[name]
    run = hp.build(dev)
    with BuildBudget(None, strict=False, name=f"{name}:warmup") as warm:
        run.warmup()
        _sync(dev)
    launches = dict(cuda_lib.LAUNCHES)
    with BuildBudget(None, strict=False, name=f"{name}:steady") as steady, \
            HostSyncBudget(None, strict=False, name=f"{name}:steady") as hs:
        out = run.steady()
    launched = {k: v - launches[k] for k, v in cuda_lib.LAUNCHES.items()
                if v != launches[k]}
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run.steady()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    kinds: dict[str, int] = {}
    for r in hs.reads:
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
    return {
        "doc": hp.doc,
        "device": str(dev),
        "unit": hp.unit,
        "units": int(run.units(out)),
        "warmup_builds": warm.builds,
        "warmup_loads": warm.loads,
        "steady_builds": steady.builds,
        "steady_loads": steady.loads,
        "steady_reads": hs.count,
        "steady_read_kinds": kinds,
        "steady_read_sites": hs.sites(),
        "steady_syncs": hs.syncs,
        "steady_sync_sites": hs.sites(hs.sync_reads) if hs.syncs is not None
        else None,
        "steady_launches": launched,
        "steady_ms": statistics.median(times) if times else None,
    }


def measure_all(names: Optional[list[str]] = None,
                device=None) -> dict[str, dict]:
    return {name: measure(name, device)
            for name in (names or sorted(HOT_PATHS))}


def default_budgets_path() -> Path:
    """``budgets.json`` beside this module."""
    return Path(__file__).resolve().parent / "budgets.json"


def load_budgets(path: Optional[Path] = None) -> dict[str, dict]:
    with open(path or default_budgets_path()) as fh:
        return json.load(fh)["hot_paths"]


def form_value(form: dict, units: int, on_card: bool = False) -> int:
    """``fixed + per_unit x units``, plus ``to_host`` on the card."""
    extra = form.get("to_host", 0) if on_card else 0
    return form["fixed"] + form["per_unit"] * units + extra


def _unnamed(sites: dict, why: str) -> list[str]:
    """The sites (``repro_torch/`` dropped) that ``why`` does not name."""
    return [site for site in sorted(sites)
            if not re.search(re.escape(site.removeprefix("repro_torch/"))
                             + r"(?!\d)", why)]


def check_budget(name: str, result: dict, entry: dict) -> list[str]:
    """The gate's failures for one measured hot path against its entry:
    a steady build or load above its budget, a read or wait count above
    its form, or a site of either that the entry's ``why`` does not
    name."""
    failures = []
    for what in ("builds", "loads"):
        got = result[f"steady_{what}"]
        if got > entry[what]:
            failures.append(f"{name}: {got} steady {what}, budget "
                            f"{entry[what]}")
    on_card = result["device"].startswith("cuda")
    units = result["units"]
    want = form_value(entry["reads"], units, on_card)
    if result["steady_reads"] > want:
        failures.append(
            f"{name}: {result['steady_reads']} steady host reads over "
            f"{units} {result['unit']}, form {want}; sites "
            f"{result['steady_read_sites']}")
    if result["steady_syncs"] is not None and on_card:
        want = form_value(entry["syncs"], units)
        if result["steady_syncs"] > want:
            failures.append(
                f"{name}: {result['steady_syncs']} steady waits for the "
                f"card over {units} {result['unit']}, form {want} (measured "
                f"on {entry['syncs']['measured_on']}); sites "
                f"{result['steady_sync_sites']}")
    for site in _unnamed({**result["steady_read_sites"],
                          **(result["steady_sync_sites"] or {})},
                         entry["why"]):
        failures.append(f"{name}: the budget's why does not name the read "
                        f"site {site}")
    return failures


# --------------------------------------------------------------------------
# the registered production hot paths
# --------------------------------------------------------------------------

def _two_problems(n: int, dev):
    from repro_torch.core.problem import sample_problem
    return sample_problem(0, n, device=dev), sample_problem(1, n, device=dev)


@register_hot_path(
    "solve_joint_fused",
    doc="fused Algorithm-2 solve; no build or load across fresh "
        "same-shaped problems, one convergence read per outer step",
    unit="outer iterations")
def _build_solve_joint_fused(dev) -> HotPathRun:
    from repro_torch.core.alternating import solve_joint_fused

    prob_a, prob_b = _two_problems(32, dev)

    def warmup():
        return solve_joint_fused(prob_a, eps=1e-6, max_iters=40)

    def steady():
        return solve_joint_fused(prob_b, eps=1e-6, max_iters=40)

    return HotPathRun(warmup=warmup, steady=steady,
                      units=lambda sol: sol.n_iters)


@register_hot_path(
    "solve_joint_batch",
    doc="batched fused solve (the service's _solve payload) for a fixed "
        "(batch, bucket) signature",
    unit="outer iterations")
def _build_solve_joint_batch(dev) -> HotPathRun:
    from repro_torch.core.batch import pad_batch, solve_joint_batch, stack_problems
    from repro_torch.core.problem import sample_problem

    def batch(seed0: int):
        probs = [sample_problem(seed0 + i, 16 + 4 * i, device="cpu")
                 for i in range(3)]
        return pad_batch(stack_problems(probs, device=dev), batch_size=4,
                         n_max=32)

    batch_a, batch_b = batch(0), batch(10)

    def warmup():
        return solve_joint_batch(batch_a, method="fused")

    def steady():
        return solve_joint_batch(batch_b, method="fused")

    return HotPathRun(warmup=warmup, steady=steady,
                      units=lambda sol: int(sol.n_iters.max()))


@register_hot_path(
    "fleet_service_step",
    doc="FleetControlService.step after warmup(): two rounds of three "
        "cells, the second warm-started from the first",
    unit="outer iterations over the steady batches")
def _build_fleet_service_step(dev) -> HotPathRun:
    from repro_torch.core.problem import sample_problem
    from repro_torch.serve.fleet_service import FleetControlService, ServiceConfig

    service = FleetControlService(ServiceConfig(cost_smoothing=0.0),
                                  device=dev)
    # requests arrive as host data, which the service queues on the host
    template = sample_problem(0, 24, device="cpu")
    rounds = [[sample_problem(100 * r + c, 24, device="cpu")
               for c in range(3)] for r in range(2)]

    def warmup():
        return service.warmup(template, max_devices=24)

    def steady():
        now, served = 0.0, []
        for round_problems in rounds:
            for c, prob in enumerate(round_problems):
                now += 1e-4
                service.submit(f"cell-{c}", prob, now=now)
            served.append(service.step(now=now))
        return served

    def units(served) -> int:
        return sum(max(r.n_iters for r in batch) for batch in served)

    return HotPathRun(warmup=warmup, steady=steady, units=units)


def _build_sweep_inputs(dev, *, uplink_bits: Optional[int], seeds: list[int],
                        aggregate: str):
    """Stacked plans + datasets + params for a tiny scan-engine sweep."""
    from repro_torch.core.problem import sample_problem
    from repro_torch.core.schedulers import UniformScheduler
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.fl.engine import FLConfig
    from repro_torch.fl.scan_engine import init_sweep_params, plan_trajectory, stack_plans

    n, n_rounds = 6, 3
    problem = sample_problem(0, n, device=dev)
    scheduler = UniformScheduler(m=2)
    train = make_dataset(48, seed=0)
    test = make_dataset(16, seed=1)
    parts = np.array_split(np.arange(48), n)
    configs = [FLConfig(n_rounds=n_rounds, batch_per_client=2, eval_every=2,
                        aggregate=aggregate, uplink_bits=uplink_bits,
                        seed=s) for s in seeds]
    plans = stack_plans([plan_trajectory(problem, scheduler, parts, c)
                         for c in configs])
    params = init_sweep_params(configs, device=dev)
    return plans, train, test, configs[0], params


def _rounds(result) -> int:
    return len(result.histories[0].rounds)


@register_hot_path(
    "scan_engine_sweep",
    doc="stacked-trajectory FL sweep (two trajectories in lockstep, the "
        "eq.-4 sum through kernel 3 on the card); no read inside a round",
    unit="rounds")
def _build_scan_engine_sweep(dev) -> HotPathRun:
    from repro_torch.fl.scan_engine import run_fl_sweep

    plans_a, train, test, config, params = _build_sweep_inputs(
        dev, uplink_bits=None, seeds=[0, 1], aggregate="stacked")
    plans_b, _, _, _, params_b = _build_sweep_inputs(
        dev, uplink_bits=None, seeds=[2, 3], aggregate="stacked")

    def warmup():
        return run_fl_sweep(plans_a, train, test, config, params, shard=False,
                            device=dev)

    def steady():
        return run_fl_sweep(plans_b, train, test, config, params_b,
                            shard=False, device=dev)

    return HotPathRun(warmup=warmup, steady=steady, units=_rounds)


@register_hot_path(
    "scan_engine_strategies",
    doc="scheduler strategy is plan data: bernoulli / fixed / uniform "
        "trajectories run the one sweep path",
    unit="rounds over the two sweeps")
def _build_scan_engine_strategies(dev) -> HotPathRun:
    from repro_torch.core.problem import sample_problem
    from repro_torch.core.schedulers import (DeterministicScheduler,
                                             ProbabilisticScheduler,
                                             UniformScheduler)
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.fl.engine import FLConfig
    from repro_torch.fl.scan_engine import (init_sweep_params, plan_trajectory,
                                            run_fl_sweep, stack_plans)

    n, n_rounds = 6, 3
    problem = sample_problem(0, n, device=dev)
    train = make_dataset(48, seed=0)
    test = make_dataset(16, seed=1)
    parts = np.array_split(np.arange(48), n)
    config = FLConfig(n_rounds=n_rounds, batch_per_client=2, eval_every=2,
                      aggregate="stacked")

    def stacked(scheduler):
        plan = plan_trajectory(problem, scheduler, parts, config)
        return stack_plans([plan]), init_sweep_params([config], device=dev)

    warm_inputs = stacked(UniformScheduler(m=2))
    steady_inputs = [stacked(s) for s in (ProbabilisticScheduler(),
                                          DeterministicScheduler())]

    def sweep(plans, params):
        return run_fl_sweep(plans, train, test, config, params, shard=False,
                            device=dev)

    def warmup():
        return sweep(*warm_inputs)

    def steady():
        return [sweep(*inputs) for inputs in steady_inputs]

    return HotPathRun(warmup=warmup, steady=steady,
                      units=lambda results: sum(map(_rounds, results)))
