"""Scenario registry: named wireless-FL problem generators.

As ``repro.core.scenarios``: one API from which the benchmarks, the
entry points, the tests and the FL engine draw their scenarios, the
paper's simulation setup plus beyond-paper workloads (fading ensembles,
heterogeneous bandwidth, fleets of 1k to 1M devices, energy- and
bandwidth-starved fleets).  Each registered :class:`Scenario`'s
``build(seed, **overrides)`` returns one ``WirelessFLProblem`` draw;
``make_batch`` stacks many draws into a
:class:`repro_torch.core.batch.ProblemBatch`.  The multi-cell entries
(``metro_coupled``, ``interference_grid``) build a
:class:`repro_torch.core.multicell.MultiCellProblem` instead.

    from repro_torch.core.scenarios import make_problem, make_batch

    prob  = make_problem("paper_static", seed=0)           # on the card
    batch = make_batch("rayleigh_fading", 64, seed=0, device="cpu")

Every draw consumes the reference's numpy streams in the reference's
order (``sample_problem(seed, ...)``, ``seed + 7_919`` for the Dirichlet
bandwidth split, ``seed + 104_729`` for the Gauss-Markov drift,
``seed + 7_001 c`` for cell c), so a draw equals the reference's bit for
bit.  ``device=`` (an override every builder takes) places it; batches
are drawn on the host and copied to their device once per field.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.batch import ProblemBatch, stack_problems
from repro_torch.core.multicell import MultiCellProblem, grid_coupling, make_multicell
from repro_torch.core.problem import WirelessFLProblem, _f32, sample_problem


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded generator of WirelessFLProblem instances."""

    name: str
    description: str
    paper_ref: str          # paper figure/section, or "beyond-paper"
    n_devices: int          # default fleet size of one draw
    build: Callable[..., WirelessFLProblem]   # (seed, **overrides) -> problem

    def __call__(self, seed: int = 0, **overrides) -> WirelessFLProblem:
        return self.build(seed, **overrides)


SCENARIOS: dict[str, Scenario] = {}


def register(name: str, description: str, paper_ref: str, n_devices: int):
    """Decorator: add a builder ``fn(seed, **overrides)`` to the registry."""
    def deco(fn):
        if name in SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        SCENARIOS[name] = Scenario(name=name, description=description,
                                   paper_ref=paper_ref, n_devices=n_devices,
                                   build=fn)
        return fn
    return deco


def make_problem(name: str, seed: int = 0, **overrides) -> WirelessFLProblem:
    """One draw of a registered scenario."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(SCENARIOS)}")
    return SCENARIOS[name](seed, **overrides)


def make_batch(name: str, n_instances: int, seed: int = 0, *,
               device=None, **overrides) -> ProblemBatch:
    """Stack ``n_instances`` i.i.d. draws (seeds ``seed .. seed+B-1``) on
    ``device`` (default: the card)."""
    draws = [make_problem(name, seed + i, device="cpu", **overrides)
             for i in range(n_instances)]
    if any(isinstance(d, MultiCellProblem) for d in draws):
        raise ValueError(
            f"scenario {name!r} builds a coupled MultiCellProblem; solve "
            "it as one coupled metro instead of batching (its .cells is "
            "already a ProblemBatch)")
    return stack_problems(draws, device=device)


def make_mixed_batch(names: Sequence[str], seed: int = 0, *, device=None,
                     **overrides) -> ProblemBatch:
    """One draw of each named scenario (seeds ``seed + i``) stacked into a
    single ragged batch on ``device``.

    All named scenarios must share static metadata (``tau_th``, ``p_max``,
    ...); fleet sizes may differ freely (padded + masked).
    """
    return stack_problems([make_problem(n, seed + i, device="cpu", **overrides)
                           for i, n in enumerate(names)], device=device)


# ----------------------------------------- time-correlated channel drift

def gauss_markov_fading(rng: np.random.Generator | int, n_devices: int,
                        n_rounds: int, coherence: float = 0.9) -> np.ndarray:
    """Time-correlated Rayleigh fading power gains, shape ``[N, K]``.

    First-order Gauss–Markov (AR(1)) evolution of the complex channel —
    the discrete-time Jakes/Clarke surrogate used throughout the wireless
    FL literature (cf. Perazzone et al., arXiv:2201.07912; Yang et al.'s
    per-round re-solving):

        h_0 ~ CN(0, 1),    h_k = rho h_{k-1} + sqrt(1 - rho^2) w_k

    with ``rho = coherence`` in [0, 1) and w_k ~ CN(0, 1) i.i.d.  Power
    gains ``g_k = |h_k|^2`` are marginally Exp(1) — exactly the
    ``rayleigh_fading`` scenario's distribution — but successive rounds
    correlate as ``corr(g_k, g_{k+1}) = rho^2``, so successive per-round
    solves are near-identical: the regime that warm-started serving
    exploits.  ``coherence=0`` recovers i.i.d. block
    fading; ``coherence -> 1`` approaches a static channel.
    """
    if not 0.0 <= coherence < 1.0:
        raise ValueError(f"coherence must be in [0, 1), got {coherence}")
    rng = np.random.default_rng(rng) if not isinstance(
        rng, np.random.Generator) else rng

    def cn(size):
        return (rng.standard_normal(size) + 1j * rng.standard_normal(size)) \
            / np.sqrt(2.0)

    h = cn(n_devices)
    cols = [np.abs(h) ** 2]
    for _ in range(n_rounds - 1):
        h = coherence * h + np.sqrt(1.0 - coherence ** 2) * cn(n_devices)
        cols.append(np.abs(h) ** 2)
    return np.stack(cols, axis=1)


def slice_round(problem: WirelessFLProblem, k: int) -> WirelessFLProblem:
    """Round ``k`` of a fading problem as a standalone 1-round problem.

    The per-request unit of the serving path: a ``[N, K]`` drifting
    scenario becomes a stream of K single-round problems whose channels
    drift between successive requests.  Solutions have shape ``[N, 1]``.
    """
    if problem.fading is None:
        raise ValueError("slice_round needs a fading ([N, K]) problem")
    bits = problem.bits
    if bits is not None and bits.ndim == 2:
        bits = bits[:, k:k + 1]
    return dataclasses.replace(problem,
                               fading=problem.fading[:, k:k + 1],
                               bits=bits,
                               n_rounds=1)


# ------------------------------------------------------------ registry


@register("paper_static",
          "The paper's simulation setup (Sec. V-A): 100 devices uniform in "
          "1 km^2, static channel, B = 10 MHz shared equally, per-round "
          "energy budgets log-uniform in [1e-3, 100] J.",
          "Sec. V-A, Tables I-IV", n_devices=100)
def _paper_static(seed, *, n_devices: int = 100, **kw) -> WirelessFLProblem:
    return sample_problem(seed, n_devices, **kw)


@register("rayleigh_fading",
          "Paper setup with i.i.d. Rayleigh block fading per round "
          "(exponential power gain, unit mean) — the per-(i, k) separable "
          "closed forms solve each round's draw jointly.",
          "beyond-paper (cf. Perazzone et al., arXiv:2201.07912)",
          n_devices=100)
def _rayleigh_fading(seed, *, n_devices: int = 100, n_rounds: int = 10,
                     **kw) -> WirelessFLProblem:
    return sample_problem(seed, n_devices, with_fading=True,
                          n_rounds=n_rounds, **kw)


@register("hetero_bandwidth",
          "Unequal OFDMA bandwidth split: the 10 MHz total is divided by a "
          "Dirichlet(1) draw instead of equally, modelling heterogeneous "
          "subcarrier grants.",
          "beyond-paper (cf. Guo et al., arXiv:2205.09306)", n_devices=100)
def _hetero_bandwidth(seed, *, n_devices: int = 100,
                      total_bandwidth_hz: float = 10e6,
                      **kw) -> WirelessFLProblem:
    prob = sample_problem(seed, n_devices,
                          total_bandwidth_hz=total_bandwidth_hz, **kw)
    rng = np.random.default_rng(seed + 7_919)
    shares = rng.dirichlet(np.ones(n_devices))
    # floor each share at 1% of the equal split so no device is starved to
    # a numerically-degenerate rate
    shares = np.maximum(shares, 0.01 / n_devices)
    shares = shares / shares.sum()
    return dataclasses.replace(
        prob, bandwidth_hz=_f32(shares * total_bandwidth_hz, prob.device))


@register("dense_1k",
          "Dense metropolitan fleet: 1000 devices in 1 km^2 sharing "
          "100 MHz; stresses the fleet-scale vectorised solve.",
          "beyond-paper", n_devices=1000)
def _dense_1k(seed, *, n_devices: int = 1000, **kw) -> WirelessFLProblem:
    kw.setdefault("total_bandwidth_hz", 100e6)
    kw.setdefault("dataset_total", 600_000)
    return sample_problem(seed, n_devices, **kw)


@register("mega_fleet_100k",
          "Mega fleet: 100 000 devices in a 10 km^2 metro area sharing "
          "1 GHz of OFDMA spectrum; the fused single-level solver's "
          "chunked, element-sharded path solves it in fixed memory "
          "(``solve_joint_fused(..., chunk_elements=...)`` or "
          "``solve_joint_batch(method='fused', chunk_elements=...)``).",
          "beyond-paper", n_devices=100_000)
def _mega_fleet_100k(seed, *, n_devices: int = 100_000,
                     **kw) -> WirelessFLProblem:
    kw.setdefault("area_m", 3163.0)          # ~10 km^2
    kw.setdefault("total_bandwidth_hz", 1e9)
    kw.setdefault("dataset_total", 60_000_000)
    return sample_problem(seed, n_devices, **kw)


@register("metro_1m_users",
          "Metropolitan scale: 1 000 000 devices over 100 km^2 sharing "
          "10 GHz — the ROADMAP's million-user regime.  Solve with "
          "``method='fused'`` and a ``chunk_elements`` bound; anything "
          "that materialises per-instance intermediates at this size "
          "belongs on the chunked path.",
          "beyond-paper", n_devices=1_000_000)
def _metro_1m_users(seed, *, n_devices: int = 1_000_000,
                    **kw) -> WirelessFLProblem:
    kw.setdefault("area_m", 10_000.0)        # 100 km^2
    kw.setdefault("total_bandwidth_hz", 1e10)
    kw.setdefault("dataset_total", 600_000_000)
    return sample_problem(seed, n_devices, **kw)


@register("drifting_metro",
          "Paper-sized metro cell whose Rayleigh channel drifts between "
          "rounds (Gauss-Markov, coherence 0.9 by default): marginally "
          "identical to rayleigh_fading but with corr(g_k, g_{k+1}) = "
          "coherence^2, so successive per-round solves are near-identical "
          "— the warm-start serving regime (slice_round + "
          "solve_joint_fused(init=prev.resume), see docs/serving.md).",
          "beyond-paper (cf. Perazzone et al., arXiv:2201.07912)",
          n_devices=100)
def _drifting_metro(seed, *, n_devices: int = 100, n_rounds: int = 20,
                    coherence: float = 0.9, **kw) -> WirelessFLProblem:
    prob = sample_problem(seed, n_devices, n_rounds=n_rounds, **kw)
    fading = gauss_markov_fading(np.random.default_rng(seed + 104_729),
                                 n_devices, n_rounds, coherence)
    return dataclasses.replace(prob, fading=_f32(fading, prob.device))


@register("drifting_mega_fleet",
          "mega_fleet_100k with Gauss-Markov channel drift (coherence "
          "0.95): 100 000 devices x K correlated rounds.  Stream it "
          "through the fleet service (or slice_round + chunked "
          "solve_joint_fused) to exercise warm starts at mega-fleet "
          "scale.",
          "beyond-paper", n_devices=100_000)
def _drifting_mega_fleet(seed, *, n_devices: int = 100_000,
                         n_rounds: int = 4, coherence: float = 0.95,
                         **kw) -> WirelessFLProblem:
    kw.setdefault("area_m", 3163.0)          # ~10 km^2, as mega_fleet_100k
    kw.setdefault("total_bandwidth_hz", 1e9)
    kw.setdefault("dataset_total", 60_000_000)
    prob = sample_problem(seed, n_devices, n_rounds=n_rounds, **kw)
    fading = gauss_markov_fading(np.random.default_rng(seed + 104_729),
                                 n_devices, n_rounds, coherence)
    return dataclasses.replace(prob, fading=_f32(fading, prob.device))


@register("metro_coupled",
          "Coupled metro tick: 16 paper-like cells (64 devices each) on a "
          "4x4 grid, moderate inter-cell interference plus one shared "
          "backhaul budget sized to bind (~60% of the uncoupled expected "
          "uplink).  Builds a MultiCellProblem — solve with "
          "``core.multicell.solve_coupled`` (or "
          "``FleetControlService.solve_coupled``), not the single-cell "
          "solvers.",
          "beyond-paper (cf. Guo et al., arXiv:2205.09306; Yang et al., "
          "arXiv:1911.02417)", n_devices=16 * 64)
def _metro_coupled(seed, *, n_cells: int = 16, n_devices: int = 64,
                   coupling_gain: float = 2e-13, alpha: float = 2.0,
                   backhaul_fraction: float | None = 0.6,
                   backhaul_bits: float | None = None,
                   **kw) -> MultiCellProblem:
    problems = [sample_problem(seed + 7_001 * c, n_devices, **kw)
                for c in range(n_cells)]
    if backhaul_bits is None and backhaul_fraction is not None:
        # the uncoupled expected uplink is ~2.1 device-uploads per cell
        # under the paper's energy-budget distribution (weakly dependent
        # on n_devices: per-device bandwidth shrinks as fleets grow);
        # 60% of that keeps the knapsack price strictly positive.
        # backhaul_fraction=None drops the shared budget entirely
        # (interference coupling only).
        s_bits = problems[0].grad_size_bits
        backhaul_bits = backhaul_fraction * 2.1 * n_cells * s_bits
    return make_multicell(problems,
                          grid_coupling(n_cells, gain=coupling_gain,
                                        alpha=alpha),
                          backhaul_bits=backhaul_bits,
                          device=kw.get("device"))


@register("interference_grid",
          "Interference-limited metro: 16 cells (32 devices each) on a "
          "4x4 grid with strong nearest-neighbour coupling and NO shared "
          "budget — pure interference fixed point, the regime where the "
          "dual-decomposition outer loop needs damping.  Builds a "
          "MultiCellProblem for ``core.multicell.solve_coupled``.",
          "beyond-paper (cf. Guo et al., arXiv:2205.09306)",
          n_devices=16 * 32)
def _interference_grid(seed, *, n_cells: int = 16, n_devices: int = 32,
                       coupling_gain: float = 1e-12, alpha: float = 2.0,
                       **kw) -> MultiCellProblem:
    problems = [sample_problem(seed + 7_001 * c, n_devices, **kw)
                for c in range(n_cells)]
    return make_multicell(problems,
                          grid_coupling(n_cells, gain=coupling_gain,
                                        alpha=alpha),
                          device=kw.get("device"))


@register("bandwidth_starved",
          "Rural macro-cell: 32 devices share only 2 MHz with generous "
          "energy budgets (log-uniform in [1, 100] J) — the round deadline "
          "(7c) binds nearly everywhere, so the fp32 payload caps a*_i at "
          "tau/T_i and the joint bit-allocation step (docs/compression.md) "
          "buys participation roughly linearly in 32/b.",
          "beyond-paper", n_devices=32)
def _bandwidth_starved(seed, *, n_devices: int = 32,
                       **kw) -> WirelessFLProblem:
    kw.setdefault("total_bandwidth_hz", 2e6)
    kw.setdefault("energy_budget_range", (1.0, 100.0))
    return sample_problem(seed, n_devices, **kw)


@register("sparse_energy_starved",
          "Sparse IoT fleet: 32 devices over 4 km^2 with per-round energy "
          "budgets log-uniform in [1e-4, 1e-2] J — the energy constraint "
          "(7b), not the time constraint, binds nearly everywhere.",
          "beyond-paper", n_devices=32)
def _sparse_energy_starved(seed, *, n_devices: int = 32,
                           **kw) -> WirelessFLProblem:
    kw.setdefault("area_m", 2000.0)
    kw.setdefault("energy_budget_range", (1e-4, 1e-2))
    return sample_problem(seed, n_devices, **kw)
