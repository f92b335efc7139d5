"""Seeded deterministic chaos harness for the fleet control plane.

As ``repro.serve.faults``: faults are injected on the host, before
``submit``, into the traffic ``serve.load_gen`` makes, and the harness
checks that nothing downstream of the boundary sees them.

* :class:`FaultPlan` — a frozen, seeded description of which fault kinds
  fire, how often and how hard; the same plan replays the same faults.
* :func:`corrupt_problem` — one problem, one fault kind.
* :func:`corrupt_trace` — a seeded pass corrupting a ``fault_rate``
  fraction of a trace's arrivals.
* :func:`dropout_mask` — the FL-side fault: a seeded ``[K, N]`` mask of
  lost uploads.
* :func:`chaos_drive` — drive a service through a corrupted trace and
  report what leaked.

The draws are the reference's numpy streams, so a plan corrupts the same
entries in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batch import _host
from repro_torch.core.problem import WirelessFLProblem
from repro_torch.serve.fleet_service import FleetControlService
from repro_torch.serve.load_gen import Arrival, DriveReport, drive

# fault kinds understood by corrupt_problem / FaultPlan.kinds
NAN_CHANNEL = "nan_channel"      # estimator emits NaN gains
INF_CHANNEL = "inf_channel"      # estimator emits +inf gains
ZERO_GAIN = "zero_gain"          # deep fade all the way to zero
DEEP_FADE = "deep_fade"          # finite fade: gain * 10^(-db/10)
DEVICE_DROPOUT = "device_dropout"  # device unreachable (all rounds)
COST_SPIKE = "cost_spike"        # BucketCostModel estimate excursion

#: the channel-corruption kinds (appliable per problem)
CHANNEL_KINDS = (NAN_CHANNEL, INF_CHANNEL, ZERO_GAIN, DEEP_FADE,
                 DEVICE_DROPOUT)
FAULT_KINDS = CHANNEL_KINDS + (COST_SPIKE,)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded chaos scenario: which faults, how often, how hard.

    ``kinds`` are drawn uniformly per faulted arrival from the plan's
    channel kinds; ``cost_spike`` (if listed) fires once at drive start
    (:func:`chaos_drive`).
    """

    kinds: tuple = CHANNEL_KINDS
    seed: int = 0
    fault_rate: float = 0.1       # fraction of arrivals corrupted
    device_rate: float = 0.1      # fraction of devices hit per fault
    deep_fade_db: float = 80.0    # power-domain fade depth
    cost_spike_factor: float = 50.0  # BucketCostModel.scale argument
    drop_rate: float = 0.1        # FL upload-dropout rate (dropout_mask)

    @property
    def channel_kinds(self) -> tuple:
        return tuple(k for k in self.kinds if k in CHANNEL_KINDS)


def corrupt_problem(problem: WirelessFLProblem, kind: str, *,
                    rng: np.random.Generator,
                    device_rate: float = 0.1,
                    deep_fade_db: float = 80.0) -> WirelessFLProblem:
    """One corrupted copy of ``problem`` (the input is untouched).

    Faults land on the fading table when the problem has one (random
    (device, round) entries; ``device_dropout`` zeroes whole device
    rows), else on ``distance_m``.  Draws consume ``rng``.
    """
    if kind not in CHANNEL_KINDS:
        raise ValueError(f"unknown channel fault kind {kind!r}; "
                         f"choose from {CHANNEL_KINDS}")
    n = problem.n_devices
    k = max(1, int(round(device_rate * n)))
    idx = rng.choice(n, size=k, replace=False)
    if problem.fading is not None:
        arr = np.array(_host(problem.fading), np.float32)
        col = rng.integers(arr.shape[1], size=k)
        if kind == NAN_CHANNEL:
            arr[idx, col] = np.nan
        elif kind == INF_CHANNEL:
            arr[idx, col] = np.inf
        elif kind == ZERO_GAIN:
            arr[idx, col] = 0.0
        elif kind == DEEP_FADE:
            arr[idx, col] *= np.float32(10.0 ** (-deep_fade_db / 10.0))
        else:                                   # DEVICE_DROPOUT
            arr[idx, :] = 0.0
        return dataclasses.replace(
            problem, fading=torch.from_numpy(arr).to(problem.device))
    arr = np.array(_host(problem.distance_m), np.float64)
    if kind == NAN_CHANNEL:
        arr[idx] = np.nan
    elif kind == INF_CHANNEL:
        arr[idx] = np.inf
    elif kind == DEEP_FADE:
        # path gain ~ d^-2: d * 10^(db/20) fades the gain by 10^(-db/10)
        arr[idx] *= 10.0 ** (deep_fade_db / 20.0)
    else:                                       # ZERO_GAIN / DEVICE_DROPOUT
        arr[idx] = np.inf
    return dataclasses.replace(problem, distance_m=torch.from_numpy(
        arr.astype(np.float32)).to(problem.device))


def corrupt_trace(trace: Sequence[Arrival],
                  plan: FaultPlan) -> tuple[list[Arrival], int]:
    """A seeded corrupted copy of a ``load_gen`` trace: each arrival is
    faulted with probability ``plan.fault_rate`` by one uniformly drawn
    channel kind.  Returns ``(trace, n_faulted)``."""
    kinds = plan.channel_kinds
    if not kinds:
        return list(trace), 0
    rng = np.random.default_rng(plan.seed)
    out, n_faulted = [], 0
    for arr in trace:
        if rng.random() < plan.fault_rate:
            kind = kinds[int(rng.integers(len(kinds)))]
            out.append(arr._replace(problem=corrupt_problem(
                arr.problem, kind, rng=rng,
                device_rate=plan.device_rate,
                deep_fade_db=plan.deep_fade_db)))
            n_faulted += 1
        else:
            out.append(arr)
    return out, n_faulted


def dropout_mask(seed: int, n_rounds: int, n_devices: int,
                 rate: float) -> np.ndarray:
    """Seeded ``[K, N]`` bool mask, True where device i's round-k upload
    is lost."""
    rng = np.random.default_rng(seed)
    return rng.random((n_rounds, n_devices)) < rate


@dataclasses.dataclass
class ChaosReport:
    """What leaked through one chaos drive (``nan_escapes`` must be 0)."""

    report: DriveReport
    n_faulted: int                # arrivals corrupted by the plan
    nan_escapes: int              # responses with non-finite a / power
    n_unconverged: int
    n_shed: int
    n_unhealthy_devices: int
    counters: dict                # service counter snapshot


def count_nonfinite(responses) -> int:
    """Responses whose solution carries any non-finite a or power."""
    bad = 0
    for r in responses:
        a = _host(r.solution.a)
        p = _host(r.solution.power)
        bad += not (np.isfinite(a).all() and np.isfinite(p).all())
    return bad


def chaos_drive(service: FleetControlService, trace: Sequence[Arrival],
                plan: FaultPlan, *, clock: str = "virtual",
                tick_s: float = 1e-3,
                reset_stats_after: Optional[int] = None) -> ChaosReport:
    """Drive ``service`` through a ``plan``-corrupted copy of ``trace``.

    ``cost_spike`` (if planned) scales the service's cost model once
    before the first arrival; the rest is :func:`load_gen.drive`.
    """
    faulted, n_faulted = corrupt_trace(trace, plan)
    if COST_SPIKE in plan.kinds:
        service._cost.scale(plan.cost_spike_factor)
    report = drive(service, faulted, clock=clock, tick_s=tick_s,
                   reset_stats_after=reset_stats_after)
    stats = service.stats
    return ChaosReport(
        report=report, n_faulted=n_faulted,
        nan_escapes=count_nonfinite(report.responses),
        n_unconverged=stats.n_unconverged, n_shed=stats.n_shed,
        n_unhealthy_devices=stats.n_unhealthy_devices,
        counters=stats.counter_summary())
