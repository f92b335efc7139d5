"""Open-loop fleet control plane: deadlines, continuous batching, warmup.

A control plane serving many base-station cells receives a stream of
per-cell solve requests ("here is my cell's channel and energy state,
give me (a*, P*) for the next round").  A round's solution is worthless
once the channel decorrelates, so each request carries a latency
budget; the batched solvers (``core.batch``) are at their best on big
padded batches; and successive requests of one cell on a coherent
channel are nearly identical, so warm starts skip most of the work.

:class:`FleetControlService` is ``repro.serve.fleet_service``'s service
on torch, decision for decision:

* **arrival queue and deadlines** — ``submit`` stamps each request with
  its arrival time and an absolute deadline;
* **continuous batching** — requests accumulate until
  :func:`batch_close_reason` closes the micro-batch (full, deadline,
  linger); ``poll`` applies the policy, ``step`` forces a close, ``run``
  drains the queue;
* **priority lanes** — a cell whose cached state no longer matches its
  quantised feature key has drifted and jumps the queue;
* **micro-batching** — compatible requests are stacked into a padded
  :class:`~repro_torch.core.batch.ProblemBatch` of ``max_batch``
  instance slots and a power-of-two device bucket;
* **warm starts** — each answer is cached, keyed on quantised problem
  features (:func:`quantized_problem_key`) and per cell, and fed back as
  ``init`` on the cell's next solve;
* **fault tolerance** — unhealthy devices are sanitised at submit, an
  unconverged batch is retried once through the reference path, and a
  per-bucket circuit breaker sheds batches after repeated failures;
* **accounting** — :class:`ServiceStats`.

The solves run on the service's ``device`` (default: the card).  The
request path works on the host, as the reference's numpy intake does:
``submit`` keeps each request's problem on the host (one copy per leaf
if it arrives on the device), where the health mask, the cache key and
the stacking read it, and each micro-batch goes to the device once per
field.  Every solve ends in a synchronise before the clock stops, so
``latency_s``, the cost model and the percentiles measure the solve and
not its launch.  Responses carry host (numpy) answers: two copies per
micro-batch.

Clock domains: without a ``now`` argument everything runs on
``time.perf_counter()``.  Explicit ``now`` stamps run the service on a
virtual clock; with ``cost_smoothing=0`` the batch composition and every
counter are then a deterministic function of the arrival trace.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Hashable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.alternating import JointSolution, WarmStart
from repro_torch.core.batch import (
    _STATIC_FIELDS,
    _host,
    pad_batch,
    solve_joint_batch,
    stack_problems,
)
from repro_torch.core.multicell import (
    CoupledDuals,
    MultiCellProblem,
    MultiCellSolution,
    pad_metro,
)
from repro_torch.core.multicell import solve_coupled as solve_coupled_core
from repro_torch.core.problem import _TENSOR_FIELDS, WirelessFLProblem
from repro_torch.device import resolve_device

_INF = float("inf")

# close reasons reported by the batch-close policy / ServiceStats
CLOSE_FULL = "full"          # the bucket's instance slots are exhausted
CLOSE_DEADLINE = "deadline"  # tightest budget ~ the bucket's solve cost
CLOSE_LINGER = "linger"      # oldest request hit the linger latency bound
CLOSE_FORCED = "forced"      # explicit step()/run() drain


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Knobs of the fleet control plane (the reference's, one for one)."""

    max_batch: int = 16           # micro-batch instance slots
    min_device_bucket: int = 8    # smallest padded device-axis bucket
    method: str = "fused"         # "fused" | "alternating"
    power_solver: Optional[str] = None   # None => the method's default
    eps: float = 1e-7
    max_iters: int = 50
    warm_start: bool = True       # feed cached solutions back as init
    cache_size: int = 4096        # LRU entries (feature-keyed + per-cell)
    quant_decimals: int = 2       # log10 rounding of the cache key
    latency_window: int = 8192    # latencies kept for the percentiles
    # ---- open-loop control (continuous batching) -----------------------
    default_deadline_s: Optional[float] = None  # per-request budget; None
    #                                            = unbounded (linger rules)
    close_safety: float = 1.5     # close when budget <= safety * est cost
    max_linger_s: float = 5e-3    # universal max wait of the oldest request
    prior_solve_s: float = 5e-3   # cost-model prior before measurements
    cost_smoothing: float = 0.3   # EWMA weight of new measurements; 0
    #                               freezes the prior (deterministic
    #                               close decisions under a virtual clock)
    record_batches: bool = False  # keep a BatchRecord log
    # ---- fault tolerance -----------------------------------------------
    sanitize: bool = True         # degrade unhealthy devices at submit
    retry_unconverged: bool = True  # re-solve an unconverged batch once
    #                                 through the reference path
    retry_max_iters: int = 200    # outer-iteration budget of the retry
    retry_backoff_s: float = 1e-3  # base of the exponential backoff
    #                                accounted per consecutive failure
    #                                (never slept)
    breaker_threshold: int = 3    # consecutive failed batches per bucket
    #                               before the circuit breaker opens
    breaker_cooldown: int = 8     # batches shed while the breaker is open


class SolveRequest(NamedTuple):
    cell_id: Hashable
    problem: WirelessFLProblem
    t_submit: float
    t_deadline: float = _INF      # absolute, same clock domain as t_submit
    priority: bool = False        # routed through the priority lane
    fkey: Optional[bytes] = None  # quantised feature key (warm_start only)
    ckey: Optional[tuple] = None  # static-compatibility key (micro-batching)
    seq: int = 0                  # submission order, unique per service
    n_unhealthy: int = 0          # devices degraded to no-ops at submit


class SolveResponse(NamedTuple):
    cell_id: Hashable
    # padding stripped, numpy on the host.  With the fused method the
    # solver reports one inner-iteration count for the whole flattened
    # element set, so ``solution.inner_iters`` is the micro-batch total
    # shared by every response of the batch; the alternating method
    # attributes it per instance.
    solution: JointSolution
    warm_started: bool            # solve was seeded from cached state
    cache_hit: bool               # the feature-keyed LRU supplied the seed
    latency_s: float              # submit -> response time (request clock)
    deadline_missed: bool = False  # completed after the request's deadline
    seq: int = 0                  # the request's submission sequence number
    converged: bool = True        # the solver converged on this instance
    n_iters: int = 0              # outer iterations attributed to it
    n_unhealthy: int = 0          # devices sanitised to no-ops at submit
    retried: bool = False         # re-solved through the reference path
    shed: bool = False            # served cached-or-zero by an open breaker


class CoupledResponse(NamedTuple):
    """One served metro tick (:meth:`FleetControlService.solve_coupled`).

    ``solution`` keeps the bucket-padded shapes; ``n_cells`` is the
    metro's own cell count (``solution.batch.instance(c)`` for ``c <
    n_cells``).
    """

    metro_id: Hashable
    solution: MultiCellSolution
    n_cells: int                  # true (unpadded) cell count
    warm_started: bool            # duals seeded from the previous tick
    latency_s: float              # submit -> response time


class BatchRecord(NamedTuple):
    """One served micro-batch (``ServiceConfig.record_batches``): enough
    to rebuild the same padded batch offline."""

    seqs: tuple[int, ...]         # request seqs, slot order
    cell_ids: tuple               # matching cell ids
    n_bucket: int                 # padded device-axis bucket
    reason: str                   # CLOSE_* that closed the batch
    priority: bool                # served from the priority lane


class ServiceStats:
    """Steady-state throughput/latency counters (host-side, cheap)."""

    def __init__(self, latency_window: int = 8192):
        self._window = latency_window
        self.reset()

    def reset(self) -> None:
        """Zero every counter: call after warm-up so first calls do not
        pollute the steady-state figures."""
        self.n_requests = 0
        self.n_solved = 0
        self.n_batches = 0
        self.n_warm = 0
        self.n_cache_hits = 0
        self.n_priority = 0
        self.n_deadline_misses = 0
        self.n_preemptions = 0
        self.closes = collections.Counter()
        self.solve_seconds = 0.0
        self.outer_iters = 0
        self.inner_iters = 0
        self.n_metro_ticks = 0        # coupled multi-cell ticks served
        self.metro_outer_iters = 0    # dual-decomposition iterations
        self.n_metro_warm = 0         # ticks seeded from cached duals
        self.n_metro_caps = 0         # ticks returning best-so-far at cap
        self.n_unconverged = 0        # responses delivered unconverged
        self.n_retries = 0            # batches re-solved via reference path
        self.n_shed = 0               # responses shed by an open breaker
        self.n_unhealthy_devices = 0  # devices sanitised to no-ops
        self.breaker_opens = 0        # circuit-breaker open transitions
        self.retry_backoff_s = 0.0    # accounted (not slept) backoff
        self.latencies = collections.deque(maxlen=self._window)

    def record_batch(self, responses, solve_s: float, outer: int,
                     inner: int, reason: str = CLOSE_FORCED,
                     preempted: bool = False,
                     retried: bool = False) -> None:
        self.n_batches += 1
        self.n_solved += len(responses)
        self.solve_seconds += solve_s
        self.outer_iters += outer
        self.inner_iters += inner
        self.closes[reason] += 1
        self.n_preemptions += bool(preempted)
        self.n_retries += bool(retried)
        for r in responses:
            self.n_warm += bool(r.warm_started)
            self.n_cache_hits += bool(r.cache_hit)
            self.n_deadline_misses += bool(r.deadline_missed)
            self.n_unconverged += not r.converged
            self.n_shed += bool(r.shed)
            self.n_unhealthy_devices += int(r.n_unhealthy)
            self.latencies.append(r.latency_s)

    def record_metro(self, solve_s: float, outer: int,
                     warm: bool, hit_cap: bool = False) -> None:
        """Account one coupled metro tick (a single synchronous call, no
        per-request latency)."""
        self.n_metro_ticks += 1
        self.metro_outer_iters += outer
        self.n_metro_warm += bool(warm)
        self.n_metro_caps += bool(hit_cap)
        self.solve_seconds += solve_s

    @property
    def solves_per_sec(self) -> float:
        return self.n_solved / self.solve_seconds if self.solve_seconds else 0.0

    def latency_percentile(self, q: float) -> float:
        """Latency percentile (seconds) over the sliding window: ``nan``
        when empty, else numpy's linear interpolation."""
        if not self.latencies:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies), q))

    @property
    def warm_fraction(self) -> float:
        return self.n_warm / self.n_solved if self.n_solved else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        return self.n_deadline_misses / self.n_solved if self.n_solved else 0.0

    @property
    def mean_inner_iters(self) -> float:
        """Mean inner (Algorithm-1) iterations per micro-batch solve —
        the figure warm starts collapse (0.0 in analytic mode)."""
        return self.inner_iters / self.n_batches if self.n_batches else 0.0

    def counter_summary(self) -> dict:
        """The integer counters only, no wall-clock-derived field: under a
        virtual clock a deterministic function of the arrival trace."""
        return {
            "requests": self.n_requests,
            "solved": self.n_solved,
            "batches": self.n_batches,
            "warm": self.n_warm,
            "cache_hits": self.n_cache_hits,
            "priority": self.n_priority,
            "deadline_misses": self.n_deadline_misses,
            "preemptions": self.n_preemptions,
            "closes": dict(self.closes),
            "outer_iters": self.outer_iters,
            "inner_iters": self.inner_iters,
            "metro_ticks": self.n_metro_ticks,
            "metro_outer_iters": self.metro_outer_iters,
            "metro_warm": self.n_metro_warm,
            "metro_caps": self.n_metro_caps,
            "unconverged": self.n_unconverged,
            "retries": self.n_retries,
            "shed": self.n_shed,
            "unhealthy_devices": self.n_unhealthy_devices,
            "breaker_opens": self.breaker_opens,
        }

    def summary(self) -> dict:
        return {
            "requests": self.n_requests,
            "solved": self.n_solved,
            "batches": self.n_batches,
            "solves_per_sec": self.solves_per_sec,
            "p50_latency_s": self.latency_percentile(50),
            "p99_latency_s": self.latency_percentile(99),
            "warm_fraction": self.warm_fraction,
            "cache_hit_fraction": (self.n_cache_hits / self.n_solved
                                   if self.n_solved else 0.0),
            "deadline_miss_rate": self.deadline_miss_rate,
            "preemptions": self.n_preemptions,
            "priority_fraction": (self.n_priority / self.n_requests
                                  if self.n_requests else 0.0),
            "closes": dict(self.closes),
            "mean_outer_iters": (self.outer_iters / self.n_batches
                                 if self.n_batches else 0.0),
            "mean_inner_iters": self.mean_inner_iters,
            "metro_ticks": self.n_metro_ticks,
            "mean_metro_outer_iters": (self.metro_outer_iters
                                       / self.n_metro_ticks
                                       if self.n_metro_ticks else 0.0),
            "metro_warm_fraction": (self.n_metro_warm / self.n_metro_ticks
                                    if self.n_metro_ticks else 0.0),
            "metro_caps": self.n_metro_caps,
            "unconverged": self.n_unconverged,
            "retries": self.n_retries,
            "shed": self.n_shed,
            "unhealthy_devices": self.n_unhealthy_devices,
            "breaker_opens": self.breaker_opens,
            "retry_backoff_s": self.retry_backoff_s,
        }


# the per-device leaves that discriminate problems; fading is appended
# when present
_KEY_FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j",
               "dataset_size", "cycles_per_sample", "cpu_hz", "weights")


def _quantize(arr: np.ndarray, decimals: int) -> np.ndarray:
    return np.round(np.log10(np.maximum(np.abs(arr), 1e-300)), decimals)


def quantized_problem_key(problem: WirelessFLProblem,
                          decimals: int = 2) -> bytes:
    """Cache key: the problem's constraint data, log-quantised.

    Two problems share a key iff every per-device feature rounds to the
    same ``decimals`` digits in log10 and the constants match exactly.
    The leaves come to the host as float32 and widen to float64 there,
    as the reference's do, so the same problem gives the reference's
    bytes.
    """
    h = hashlib.sha1()
    h.update(repr([(f, getattr(problem, f))
                   for f in _STATIC_FIELDS]).encode())
    feats = [_host(getattr(problem, f)) for f in _KEY_FIELDS]
    if problem.fading is not None:
        feats.append(_host(problem.fading))
    if problem.interference is not None:
        # offset by sigma^2 so the quantisation stays relative to the
        # total noise; the shape marker separates a zero leaf from None
        feats.append(_host(problem.interference).astype(np.float64)
                     + problem.noise_power)
        h.update(repr(tuple(problem.interference.shape)).encode())
    if problem.bits is not None:
        feats.append(_host(problem.bits).astype(np.float64))
        h.update(repr(tuple(problem.bits.shape)).encode())
    for x in feats:
        q = _quantize(np.asarray(x, np.float64), decimals)
        h.update(repr(q.shape).encode())
        h.update(np.ascontiguousarray(q).tobytes())
    return h.digest()


def _compat_key(problem: WirelessFLProblem) -> tuple:
    """Requests sharing this key can be stacked into one ProblemBatch."""
    return (tuple(getattr(problem, f) for f in _STATIC_FIELDS),
            problem.fading is not None,
            None if problem.fading is None else problem.fading.shape[1],
            None if problem.interference is None
            else problem.interference.ndim,
            None if problem.bits is None else problem.bits.ndim)


def _next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= ``max(n, floor, 1)`` (the floor itself is
    rounded up to a power of two)."""
    return 1 << (max(n, floor, 1) - 1).bit_length()


def batch_close_reason(batch: Sequence[SolveRequest], now: float,
                       est_cost_s: float,
                       config: ServiceConfig) -> Optional[str]:
    """The adaptive batch-close policy (continuous batching).

    Given the candidate micro-batch (the FIFO head-compatible prefix of
    one lane), close it now with :data:`CLOSE_FULL` when all
    ``max_batch`` slots are taken, :data:`CLOSE_DEADLINE` when the
    tightest remaining budget has dropped to ``close_safety`` times the
    bucket's estimated solve cost, or :data:`CLOSE_LINGER` when the
    oldest request has waited ``max_linger_s``; else return ``None`` and
    keep accumulating.
    """
    if not batch:
        return None
    if len(batch) >= config.max_batch:
        return CLOSE_FULL
    budget = min(r.t_deadline for r in batch) - now
    if budget <= est_cost_s * config.close_safety:
        return CLOSE_DEADLINE
    if now - batch[0].t_submit >= config.max_linger_s:
        return CLOSE_LINGER
    return None


class BucketCostModel:
    """EWMA of measured per-bucket solve wall time (seconds).

    Estimates start at ``prior_s`` and track measurements with weight
    ``alpha``; ``alpha=0`` freezes the prior, so close decisions depend
    on the arrival trace alone.
    """

    def __init__(self, prior_s: float, alpha: float):
        self.prior_s = float(prior_s)
        self.alpha = float(alpha)
        self._est: dict[int, float] = {}

    def estimate(self, bucket: int) -> float:
        return self._est.get(bucket, self.prior_s)

    def observe(self, bucket: int, seconds: float) -> None:
        if self.alpha <= 0.0:
            return
        prev = self._est.get(bucket)
        self._est[bucket] = seconds if prev is None else \
            (1.0 - self.alpha) * prev + self.alpha * seconds

    def scale(self, factor: float) -> None:
        """Multiply the prior and every estimate by ``factor``: the chaos
        harness's cost-spike hook (``serve.faults``)."""
        self.prior_s *= float(factor)
        for bucket in self._est:
            self._est[bucket] *= float(factor)


class _LRU:
    """Tiny ordered-dict LRU (host-side)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: collections.OrderedDict = collections.OrderedDict()

    def get(self, key):
        if key not in self._d:
            return None
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


def _resize_problem(problem: WirelessFLProblem,
                    n: int) -> WirelessFLProblem:
    """A copy of ``problem`` with exactly ``n`` devices (leaves truncated
    or cyclically tiled): ``warmup``'s dummy instance, whose values only
    pin shapes, never answers."""
    kw = {}
    for f in _TENSOR_FIELDS:
        v = getattr(problem, f)
        if v is not None:
            v = _host(v)
            kw[f] = torch.from_numpy(np.resize(v, (n,) + v.shape[1:]))
    return dataclasses.replace(problem, **kw)


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work: where the solve clock stops."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class FleetControlService:
    """The open-loop, continuously-batching, warm-starting control plane,
    solving on ``device`` (default: the card)."""

    def __init__(self, config: Optional[ServiceConfig] = None, *,
                 device=None):
        self.config = config = config if config is not None else ServiceConfig()
        self.device = resolve_device(device)
        self.stats = ServiceStats(config.latency_window)
        # two arrival lanes; the priority lane preempts the normal one
        self._queue: collections.deque[SolveRequest] = collections.deque()
        self._prio: collections.deque[SolveRequest] = collections.deque()
        # feature-keyed LRU: quantised problem -> WarmStart (unpadded)
        self._feature_cache = _LRU(config.cache_size)
        # per-cell last solution: the fallback seed once the channel
        # drifted past the quantisation step (new feature key)
        self._cell_cache = _LRU(config.cache_size)
        # per-cell last feature key: the drift detector of the priority lane
        self._cell_fkey = _LRU(config.cache_size)
        self._cost = BucketCostModel(config.prior_solve_s,
                                     config.cost_smoothing)
        # per-metro dual/warm state of the last tick (padded shapes)
        self._metro_duals = _LRU(config.cache_size)
        self.warmed_buckets: set[int] = set()   # buckets run by warmup()
        self.buckets_used: set[int] = set()     # buckets served so far
        self.batch_log: list[BatchRecord] = []  # when record_batches
        self._seq = 0
        # per-bucket circuit breaker: consecutive unconverged batches,
        # and remaining shed batches while the breaker is open
        self._fail_streak: dict[int, int] = {}
        self._breaker_open: dict[int, int] = {}

    # ------------------------------------------------------------- warmup
    def warmup(self, template: WirelessFLProblem, *,
               max_devices: Optional[int] = None,
               warm: Optional[bool] = None) -> dict[int, float]:
        """Run one dummy padded solve per power-of-two device bucket, cold
        and (with warm starts) warm, from ``min_device_bucket`` up to
        ``_next_pow2(max_devices)`` (default: the template's fleet size).

        The reference compiles one XLA program per bucket here.  Eager
        PyTorch has no program to compile, so the same dummy solves warm
        what a first request would otherwise pay for: the CUDA context,
        the lazy loading of the kernels' modules, and the caching
        allocator's blocks at each bucket's shapes.  No CUDA graph is
        captured: the solve loops read a convergence flag each step.

        ``stats`` and the caches are untouched.  Returns ``{bucket:
        seconds}``, each ending in a synchronise.
        """
        cfg = self.config
        hi = _next_pow2(max(max_devices or 0, template.n_devices),
                        cfg.min_device_bucket)
        warm = cfg.warm_start if warm is None else warm
        timings: dict[int, float] = {}
        b = _next_pow2(1, cfg.min_device_bucket)
        while b <= hi:
            prob = _resize_problem(template, b)
            batch = pad_batch(stack_problems([prob], device=self.device),
                              batch_size=cfg.max_batch, n_max=b)
            t0 = time.perf_counter()
            self._solve(batch, init=None)
            if warm:
                z = torch.zeros(self._sol_shape(batch), device=self.device)
                self._solve(batch, init=WarmStart(a=z, power=z))
            _sync(self.device)
            timings[b] = time.perf_counter() - t0
            self.warmed_buckets.add(b)
            b *= 2
        return timings

    # ------------------------------------------------------------- intake
    def submit(self, cell_id: Hashable, problem: WirelessFLProblem, *,
               deadline_s: Optional[float] = None,
               priority: Optional[bool] = None,
               now: Optional[float] = None) -> SolveRequest:
        """Queue one per-cell solve request.

        ``deadline_s`` is the request's latency budget (default
        ``ServiceConfig.default_deadline_s``; ``None``: unbounded).
        ``priority=None`` auto-routes a drifted cell (cached state whose
        feature key no longer matches) to the priority lane.  ``now`` pins
        the arrival stamp on a virtual clock.  With
        ``ServiceConfig.sanitize`` unhealthy devices are degraded to
        self-deselecting no-ops here.  The queued request holds the
        problem on the host.
        """
        now = time.perf_counter() if now is None else now
        cfg = self.config
        problem = problem.to("cpu")
        n_unhealthy = 0
        if cfg.sanitize:
            health = problem.health_mask(xp=np)
            if not health.all():
                n_unhealthy = int(health.size) - int(health.sum())
                problem, _ = problem.sanitize(health=health)
        fkey = quantized_problem_key(problem, cfg.quant_decimals) \
            if cfg.warm_start else None
        if priority is None:
            last = self._cell_fkey.get(cell_id) if fkey is not None else None
            priority = last is not None and last != fkey
        if deadline_s is None:
            deadline_s = cfg.default_deadline_s
        self._seq += 1
        req = SolveRequest(
            cell_id=cell_id, problem=problem, t_submit=now,
            t_deadline=_INF if deadline_s is None else now + deadline_s,
            priority=bool(priority), fkey=fkey,
            ckey=_compat_key(problem), seq=self._seq,
            n_unhealthy=n_unhealthy)
        self.stats.n_requests += 1
        self.stats.n_priority += bool(req.priority)
        (self._prio if req.priority else self._queue).append(req)
        return req

    @property
    def pending(self) -> int:
        return len(self._prio) + len(self._queue)

    # ------------------------------------------------------------ serving
    def _eligible(self, lane) -> list[SolveRequest]:
        """The micro-batch that would close: the first ``max_batch``
        requests of ``lane`` stackable with its head, without popping."""
        if not lane:
            return []
        key = lane[0].ckey
        out = []
        for req in lane:
            if req.ckey == key:
                out.append(req)
                if len(out) >= self.config.max_batch:
                    break
        return out

    def _take_micro_batch(self, lane) -> list[SolveRequest]:
        """Pop the ``_eligible`` requests; later incompatible requests
        keep their lane order."""
        if not lane:
            return []
        key = lane[0].ckey
        taken: list[SolveRequest] = []
        kept: collections.deque = collections.deque()
        while lane and len(taken) < self.config.max_batch:
            req = lane.popleft()
            (taken if req.ckey == key else kept).append(req)
        kept.extend(lane)
        lane.clear()
        lane.extend(kept)
        return taken

    def poll(self, now: Optional[float] = None) -> list[SolveResponse]:
        """The open-loop heartbeat: serve at most one micro-batch iff a
        lane's close condition holds (priority lane first), else return
        ``[]`` at once."""
        t = time.perf_counter() if now is None else now
        for lane, is_prio in ((self._prio, True), (self._queue, False)):
            elig = self._eligible(lane)
            if not elig:
                continue
            bucket = _next_pow2(max(r.problem.n_devices for r in elig),
                                self.config.min_device_bucket)
            reason = batch_close_reason(elig, t, self._cost.estimate(bucket),
                                        self.config)
            if reason is not None:
                return self._serve(self._take_micro_batch(lane), reason,
                                   priority_lane=is_prio, now=now)
        return []

    def step(self, now: Optional[float] = None) -> list[SolveResponse]:
        """Force-close one micro-batch (priority lane first) regardless of
        the close policy (:data:`CLOSE_FORCED`)."""
        lane, is_prio = (self._prio, True) if self._prio \
            else (self._queue, False)
        reqs = self._take_micro_batch(lane)
        if not reqs:
            return []
        return self._serve(reqs, CLOSE_FORCED, priority_lane=is_prio,
                           now=now)

    def run(self, requests=None) -> list[SolveResponse]:
        """Submit ``requests`` (``(cell_id, problem)`` pairs, optional)
        and drain the queue with forced closes."""
        for cell_id, problem in (requests or []):
            self.submit(cell_id, problem)
        out = []
        while self.pending:
            out.extend(self.step())
        return out

    # ------------------------------------------------------------ resume
    def seed_cell(self, cell_id: Hashable, problem: WirelessFLProblem,
                  solution) -> None:
        """Re-seed the warm caches from an externally held solution
        (anything with ``.a`` / ``.power``): a fresh service re-seeded
        with round k's problem and solution warm-starts round k+1 as the
        uninterrupted service would.  No-op without warm starts."""
        if not self.config.warm_start:
            return
        problem = problem.to("cpu")
        if self.config.sanitize:
            # as submit(): the caches are keyed on the sanitised problem
            health = problem.health_mask(xp=np)
            if not health.all():
                problem, _ = problem.sanitize(health=health)
        fkey = quantized_problem_key(problem, self.config.quant_decimals)
        state = WarmStart(a=_host(solution.a), power=_host(solution.power))
        self._feature_cache.put(fkey, state)
        self._cell_cache.put(cell_id, state)
        self._cell_fkey.put(cell_id, fkey)

    # ---------------------------------------------------- coupled metros
    def solve_coupled(self, metro_id: Hashable, metro: MultiCellProblem, *,
                      outer_iters: int = 25, outer_tol: float = 1e-3,
                      damping: float = 0.5) -> CoupledResponse:
        """Serve one coupled metro tick (``core.multicell.solve_coupled``).

        A tick bypasses the request queue and solves on the metro's own
        device: the metro is padded to power-of-two (cell, device)
        buckets (:func:`pad_metro`), its
        converged duals and element iterates are cached per ``metro_id``
        and seed the next tick (a resized metro runs cold), and
        ``stats`` counts it.
        """
        cfg = self.config
        t0 = time.perf_counter()
        n_cells = metro.n_cells
        bucket_c = _next_pow2(n_cells)
        bucket_n = _next_pow2(metro.cells.n_max, cfg.min_device_bucket)
        padded = pad_metro(metro, n_cells=bucket_c, n_max=bucket_n)
        per_round = padded.cells.problem.fading is not None
        i_shape = (bucket_c, padded.cells.problem.fading.shape[-1]) \
            if per_round else (bucket_c,)
        init: Optional[CoupledDuals] = \
            self._metro_duals.get(metro_id) if cfg.warm_start else None
        if init is not None and np.shape(init.interference) != i_shape:
            init = None               # metro resized: run cold
        sol = solve_coupled_core(
            padded, outer_iters=outer_iters, outer_tol=outer_tol,
            damping=damping, method=cfg.method,
            power_solver=cfg.power_solver, eps=cfg.eps,
            max_iters=cfg.max_iters, warm_start=cfg.warm_start, init=init,
            sanitize=cfg.sanitize)
        _sync(padded.cells.device)
        t1 = time.perf_counter()
        if cfg.warm_start:
            self._metro_duals.put(metro_id, sol.resume)
        self.buckets_used.add(bucket_n)
        self.stats.record_metro(t1 - t0, sol.outer_iters,
                                warm=init is not None,
                                hit_cap=sol.hit_iter_cap)
        return CoupledResponse(metro_id=metro_id, solution=sol,
                               n_cells=n_cells,
                               warm_started=init is not None,
                               latency_s=t1 - t0)

    # ------------------------------------------------------------- solve
    def _sol_shape(self, batch) -> tuple:
        return tuple(batch.mask.shape) if batch.problem.fading is None \
            else tuple(batch.mask.shape) + (batch.problem.fading.shape[-1],)

    def _solve(self, batch, init):
        cfg = self.config
        return solve_joint_batch(batch, method=cfg.method,
                                 power_solver=cfg.power_solver,
                                 eps=cfg.eps, max_iters=cfg.max_iters,
                                 init=init)

    def _lookup_seed(self, cell_id, fkey: bytes,
                     shape) -> tuple[Optional[WarmStart], bool]:
        """(seed, from_feature_cache) for one request, shape-checked."""
        seed = self._feature_cache.get(fkey)
        if seed is not None and seed.a.shape == shape:
            return seed, True
        seed = self._cell_cache.get(cell_id)
        if seed is not None and seed.a.shape == shape:
            return seed, False
        return None, False

    def _shed(self, reqs: list[SolveRequest], reason: str, bucket: int, *,
              priority_lane: bool,
              now: Optional[float] = None) -> list[SolveResponse]:
        """Degraded service while the bucket's breaker is open: the
        per-cell cached answer where one of the right shape exists, zeros
        (total self-deselection) otherwise, never a solve.  Every
        response carries ``shed=True`` and ``converged=False``."""
        t_done = time.perf_counter() if now is None else now
        responses = []
        for req in reqs:
            n = req.problem.n_devices
            shape = (n,) if req.problem.fading is None \
                else (n, req.problem.fading.shape[1])
            seed = self._cell_cache.get(req.cell_id)
            cached = seed is not None and seed.a.shape == shape
            a = seed.a if cached else np.zeros(shape, np.float32)
            p = seed.power if cached else np.zeros(shape, np.float32)
            inst = JointSolution(a=a, power=p, objective=np.float32(0.0),
                                 n_iters=0, converged=False, inner_iters=0)
            responses.append(SolveResponse(
                cell_id=req.cell_id, solution=inst, warm_started=cached,
                cache_hit=False, latency_s=t_done - req.t_submit,
                deadline_missed=t_done > req.t_deadline, seq=req.seq,
                converged=False, n_iters=0, n_unhealthy=req.n_unhealthy,
                retried=False, shed=True))
        if self.config.record_batches:
            self.batch_log.append(BatchRecord(
                seqs=tuple(r.seq for r in reqs),
                cell_ids=tuple(r.cell_id for r in reqs),
                n_bucket=bucket, reason=reason, priority=priority_lane))
        self.stats.record_batch(responses, 0.0, 0, 0, reason=reason,
                                preempted=False)
        return responses

    def _serve(self, reqs: list[SolveRequest], reason: str, *,
               priority_lane: bool,
               now: Optional[float] = None) -> list[SolveResponse]:
        """Pack one micro-batch, warm-start, solve, account."""
        cfg = self.config
        virtual = now is not None
        # a priority batch preempts whenever normal traffic is left waiting
        preempted = priority_lane and bool(self._queue)
        bucket = _next_pow2(max(r.problem.n_devices for r in reqs),
                            cfg.min_device_bucket)
        # open circuit breaker: shed this batch, burn one cooldown tick;
        # at zero the next batch is the half-open probe (a real solve)
        if self._breaker_open.get(bucket, 0) > 0:
            self._breaker_open[bucket] -= 1
            return self._shed(reqs, reason, bucket,
                              priority_lane=priority_lane, now=now)
        t0 = time.perf_counter()

        batch = stack_problems([r.problem for r in reqs], device=self.device)
        batch = pad_batch(batch, batch_size=cfg.max_batch, n_max=bucket)
        sizes = [r.problem.n_devices for r in reqs]

        # per-request warm seeds packed to the padded slot shape (zero
        # rows: no previous state, which element_warm_lambda runs cold)
        sol_shape = self._sol_shape(batch)
        per_round = (len(sol_shape) == 3)
        init = None
        warm_flags = [False] * len(reqs)
        hit_flags = [False] * len(reqs)
        if cfg.warm_start:
            a0 = np.zeros(sol_shape, np.float32)
            p0 = np.zeros(sol_shape, np.float32)
            for i, req in enumerate(reqs):
                shape = (sizes[i], sol_shape[-1]) if per_round \
                    else (sizes[i],)
                seed, hit = self._lookup_seed(req.cell_id, req.fkey, shape)
                if seed is None:
                    continue
                warm_flags[i], hit_flags[i] = True, hit
                a0[i, :shape[0]] = seed.a
                p0[i, :shape[0]] = seed.power
            if any(warm_flags):
                init = WarmStart(a=torch.from_numpy(a0).to(self.device),
                                 power=torch.from_numpy(p0).to(self.device))

        sol = self._solve(batch, init=init)
        _sync(self.device)

        # an unconverged batch gets ONE retry through the reference path
        # (alternating + Dinkelbach) with a larger iteration budget; its
        # result is taken wholesale.  Reading ``converged`` synchronises.
        retried = False
        conv_real = sol.converged.cpu().numpy()[:len(reqs)]
        if cfg.retry_unconverged and not conv_real.all():
            retried = True
            sol = solve_joint_batch(batch, method="alternating",
                                    power_solver="dinkelbach",
                                    eps=cfg.eps,
                                    max_iters=cfg.retry_max_iters,
                                    init=init)
            _sync(self.device)
            conv_real = sol.converged.cpu().numpy()[:len(reqs)]

        # per-bucket circuit breaker: consecutive still-unconverged
        # batches accumulate exponential backoff (accounted, never slept)
        # and eventually open the breaker
        if conv_real.all():
            self._fail_streak[bucket] = 0
        else:
            streak = self._fail_streak.get(bucket, 0) + 1
            self._fail_streak[bucket] = streak
            self.stats.retry_backoff_s += \
                cfg.retry_backoff_s * (2.0 ** (min(streak, 24) - 1))
            if streak >= cfg.breaker_threshold:
                self._breaker_open[bucket] = cfg.breaker_cooldown
                self.stats.breaker_opens += 1

        t1 = time.perf_counter()
        self._cost.observe(bucket, t1 - t0)
        self.buckets_used.add(bucket)
        t_done = now if virtual else t1

        # the result to the host in two copies: the [B, ...] answers and
        # the [B] per-instance fields (float64 holds each value exactly)
        a_np, p_np = torch.stack([sol.a, sol.power]).cpu().numpy()
        # the fused method counts inner iterations once for the batch
        inner_shared = not isinstance(sol.inner_iters, torch.Tensor)
        fields = [sol.objective, sol.converged, sol.n_iters]
        if not inner_shared:
            fields.append(sol.inner_iters)
        per_inst = torch.stack([f.double() for f in fields]).cpu().numpy()
        obj_np = per_inst[0].astype(np.float32)
        conv_np = per_inst[1].astype(bool)
        outer_np = per_inst[2].astype(np.int64)
        inner_np = np.full(len(obj_np), sol.inner_iters, np.int64) \
            if inner_shared else per_inst[3].astype(np.int64)

        responses = []
        outer = int(np.max(outer_np))
        inner = int(inner_np[0]) if inner_shared else int(np.sum(inner_np))
        for i, req in enumerate(reqs):
            n = sizes[i]
            inst = JointSolution(
                a=a_np[i, :n], power=p_np[i, :n], objective=obj_np[i],
                n_iters=int(outer_np[i]), converged=bool(conv_np[i]),
                inner_iters=int(inner_np[i]))
            if cfg.warm_start:
                state = inst.resume
                self._feature_cache.put(req.fkey, state)
                self._cell_cache.put(req.cell_id, state)
                self._cell_fkey.put(req.cell_id, req.fkey)
            responses.append(SolveResponse(
                cell_id=req.cell_id, solution=inst,
                warm_started=warm_flags[i], cache_hit=hit_flags[i],
                latency_s=t_done - req.t_submit,
                deadline_missed=t_done > req.t_deadline, seq=req.seq,
                converged=bool(conv_np[i]), n_iters=int(outer_np[i]),
                n_unhealthy=req.n_unhealthy, retried=retried))
        if cfg.record_batches:
            self.batch_log.append(BatchRecord(
                seqs=tuple(r.seq for r in reqs),
                cell_ids=tuple(r.cell_id for r in reqs),
                n_bucket=bucket, reason=reason, priority=priority_lane))
        self.stats.record_batch(responses, t1 - t0, outer, inner,
                                reason=reason, preempted=preempted,
                                retried=retried)
        return responses

