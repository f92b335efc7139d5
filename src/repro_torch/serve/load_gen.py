"""Seeded open-loop arrival generation and the driver for the fleet service.

As ``repro.serve.load_gen``:

* :func:`make_cells` — a metro area as per-cell drifting trajectories;
* :func:`poisson_trace` — memoryless arrivals at a fixed offered rate;
* :func:`bursty_trace` — ON/OFF bursts separated by idle gaps;
* :func:`drive` — the open-loop driver: submits each arrival at its trace
  time (wall clock, or a deterministic virtual clock) and pumps
  :meth:`FleetControlService.poll` between arrivals;
* :func:`measure_capacity` — the service's sustained full-batch rate.

The traces draw from the same numpy streams in the same order as the
reference's, so one seed gives the same arrival times, cells and rounds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.problem import WirelessFLProblem
from repro_torch.core.scenarios import make_problem, slice_round
from repro_torch.serve.fleet_service import FleetControlService, SolveResponse


class Arrival(NamedTuple):
    """One scheduled request: cell ``cell_id``'s drift round ``round_k``
    arriving ``t`` seconds after the trace starts."""

    t: float
    cell_id: int
    round_k: int
    problem: WirelessFLProblem
    deadline_s: Optional[float] = None


def make_cells(n_cells: int, *, n_devices: int = 64, n_rounds: int = 8,
               scenario: str = "drifting_metro", seed: int = 0,
               device=None, **overrides) -> list[WirelessFLProblem]:
    """A metro area: per-cell drifting trajectories (seeded), on
    ``device`` (default: the card)."""
    return [make_problem(scenario, seed=seed + c, n_devices=n_devices,
                         n_rounds=n_rounds, device=device, **overrides)
            for c in range(n_cells)]


def _slices(cells: Sequence[WirelessFLProblem]) -> list[list]:
    # every (cell, round) problem sliced once; traces reference them
    return [[slice_round(c, k) for k in range(c.fading.shape[1])]
            for c in cells]


def poisson_trace(cells: Sequence[WirelessFLProblem], *, rate_hz: float,
                  n_requests: int, seed: int = 0,
                  deadline_s: Optional[float] = None) -> list[Arrival]:
    """Open-loop Poisson arrivals at offered rate ``rate_hz``: i.i.d.
    exponential gaps; each arrival picks a uniformly random cell and takes
    that cell's next drift round (wrapping at the trajectory length)."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.exponential(1.0 / rate_hz, n_requests))
    sl = _slices(cells)
    counters = [0] * len(cells)
    trace = []
    for t in times:
        c = int(rng.integers(len(cells)))
        k = counters[c] % len(sl[c])
        counters[c] += 1
        trace.append(Arrival(t=float(t), cell_id=c, round_k=k,
                             problem=sl[c][k], deadline_s=deadline_s))
    return trace


def bursty_trace(cells: Sequence[WirelessFLProblem], *,
                 burst_rate_hz: float, burst_len: int, n_bursts: int,
                 idle_s: float, seed: int = 0,
                 deadline_s: Optional[float] = None) -> list[Arrival]:
    """ON/OFF arrivals: ``n_bursts`` bursts of ``burst_len`` requests,
    Poisson at ``burst_rate_hz`` within a burst, separated by ``idle_s``
    idle gaps; cells drawn uniformly, each advancing its own round."""
    rng = np.random.default_rng(seed)
    sl = _slices(cells)
    counters = [0] * len(cells)
    trace = []
    t = 0.0
    for _ in range(n_bursts):
        for _ in range(burst_len):
            t += float(rng.exponential(1.0 / burst_rate_hz))
            c = int(rng.integers(len(cells)))
            k = counters[c] % len(sl[c])
            counters[c] += 1
            trace.append(Arrival(t=t, cell_id=c, round_k=k,
                                 problem=sl[c][k], deadline_s=deadline_s))
        t += idle_s
    return trace


@dataclasses.dataclass
class DriveReport:
    """What one open-loop run produced (stats live on ``service.stats``)."""

    responses: list[SolveResponse]
    wall_s: float                 # driver wall time (submit -> drained)
    offered_rate_hz: float        # arrivals / trace span
    sustained_rate_hz: float      # completions / wall time


def drive(service: FleetControlService, trace: Sequence[Arrival], *,
          clock: str = "wall", tick_s: float = 1e-3,
          reset_stats_after: Optional[int] = None) -> DriveReport:
    """Open-loop driver: arrivals fire at their trace times whatever the
    service's progress, with ``service.poll`` pumped in between.

    ``clock="wall"`` maps trace offsets onto ``perf_counter`` time and
    stamps each submission with its scheduled arrival time;
    ``clock="virtual"`` advances time only through the trace stamps and
    fixed ``tick_s`` steps while draining, so with
    ``ServiceConfig.cost_smoothing=0`` the run is a deterministic
    function of the trace.  ``reset_stats_after`` resets
    ``service.stats`` once that many responses have completed.  The
    queue is drained on exit.
    """
    if clock not in ("wall", "virtual"):
        raise ValueError(f"clock must be 'wall' or 'virtual', got {clock!r}")
    virtual = clock == "virtual"
    responses: list[SolveResponse] = []
    did_reset = reset_stats_after is None
    t_wall0 = time.perf_counter()

    def pump(now):
        nonlocal did_reset
        while True:
            out = service.poll(now if virtual else None)
            if not out:
                return
            responses.extend(out)
            if not did_reset and len(responses) >= reset_stats_after:
                service.stats.reset()
                did_reset = True

    i, now = 0, 0.0
    while i < len(trace):
        if virtual:
            now = trace[i].t
        else:
            # busy-wait to the scheduled arrival, polling meanwhile
            while time.perf_counter() - t_wall0 < trace[i].t:
                pump(None)
            now = time.perf_counter() - t_wall0
        # submit every arrival that is due before polling again, so a
        # backlog enters the queue as one burst
        while i < len(trace) and trace[i].t <= now:
            arr = trace[i]
            service.submit(arr.cell_id, arr.problem,
                           deadline_s=arr.deadline_s,
                           now=(arr.t if virtual else t_wall0 + arr.t))
            i += 1
        pump(now)
    # drain: keep advancing the clock so deadline/linger closes fire
    while service.pending:
        if virtual:
            now += tick_s
        pump(now)
    wall_s = time.perf_counter() - t_wall0
    span = max(trace[-1].t, 1e-9) if trace else 1e-9
    return DriveReport(
        responses=responses, wall_s=wall_s,
        offered_rate_hz=len(trace) / span,
        sustained_rate_hz=len(responses) / max(wall_s, 1e-9))


def measure_capacity(service: FleetControlService,
                     problems: Sequence[WirelessFLProblem], *,
                     repeats: int = 3) -> float:
    """Sustained full-batch capacity of the (warmed) service in solves
    per second: the best of ``repeats`` forced full-batch steps over
    ``problems`` (cycled to ``max_batch``).  Changes ``service.stats``
    and the warm caches: reset the stats after it."""
    bsz = service.config.max_batch
    best = float("inf")
    for r in range(repeats):
        for i in range(bsz):
            service.submit(("capacity", r, i), problems[i % len(problems)])
        t0 = time.perf_counter()
        while service.pending:
            service.step()
        best = min(best, time.perf_counter() - t0)
    return bsz / best
