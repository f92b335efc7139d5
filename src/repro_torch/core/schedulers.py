"""Client-selection strategies of the paper's grid.

Every scheduler exposes

    state = scheduler.precompute(problem)              # one-off solve
    draw  = scheduler.sample(state, generator, k)      # per-round draw

with a ``ParticipationDraw`` holding the participation mask, the transmit
powers and the aggregation weights alpha_i of the server update (eq. 4):

* **probabilistic** (the paper's Alg. 2/3): a* from the joint solve;
  participate w.p. a*_ik at power P*_ik; alpha proportional to |D_i|.
* **deterministic**: the rounded, expected-count preserving binary version.
* **uniform** [McMahan et al.]: M clients uniformly at random at P^max.
* **equally_weighted** [Nishio & Yonetani]: binary selection with equal
  objective and aggregation weights.
* **greedy_channel**: per-round top-M devices by instantaneous path gain
  at the minimum tau-feasible power, the channel-aware baseline.
* **lyapunov**: virtual-queue drift-plus-penalty scheduling: a per-device
  energy-budget queue Q_i(k+1) = max(Q_i(k) + m_i E_ik - E^max_i, 0)
  throttles devices whose realised energy overshoots their budget, and
  round k selects the devices whose utility V w_i outweighs Q_i(k) E_ik.

Random draws come from the ``torch.Generator`` the caller passes (the
reference's ``jax.random`` streams cannot be reproduced; callers that need
the reference's draws pass its masks to the FL engines).  The
probabilistic scheduler's batched methods (``solve_batch``,
``precompute_batch``, ``sample_batch``) take a ``core.batch.ProblemBatch``.
The channel-aware pair (greedy_channel, lyapunov) produce per-round
``[N, K]`` states on fading problems, which the engines and the closed
loop (``repro_torch.fl.closed_loop``) consume round by round.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.alternating import JointSolution, solve_joint, solve_joint_fused
from repro_torch.core.batch import BatchSolution, ProblemBatch, solve_joint_batch
from repro_torch.core.optimal import solve_joint_optimal
from repro_torch.core.problem import WirelessFLProblem


class ParticipationDraw(NamedTuple):
    mask: torch.Tensor         # [N] bool — who transmits this round
    power: torch.Tensor        # [N] transmit power for participants
    agg_weights: torch.Tensor  # [N] alpha_i for the server update (eq. 4)
    probs: torch.Tensor        # [N] the selection probabilities used


class SchedulerState(NamedTuple):
    a: torch.Tensor            # [N] or [N, K]
    power: torch.Tensor
    agg_weights: torch.Tensor  # [N]


def _round_slice(x: torch.Tensor, k) -> torch.Tensor:
    return x if x.ndim == 1 else x[:, k]


def _data_weights(problem: WirelessFLProblem) -> torch.Tensor:
    return problem.dataset_size / torch.sum(problem.dataset_size)


def bernoulli_mask(generator: torch.Generator, a: torch.Tensor) -> torch.Tensor:
    """m_i ~ Bernoulli(a_i): one uniform draw per device from
    ``generator`` (on its own device), compared on ``a``'s device."""
    u = torch.rand(a.shape, generator=generator, device=generator.device)
    return u.to(a.device) < a


def uniform_mask(generator: torch.Generator, n: int, m: int,
                 device) -> torch.Tensor:
    """Exactly ``m`` of ``n`` devices, uniformly at random."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    mask = torch.zeros((n,), dtype=torch.bool, device=generator.device)
    mask[perm[:m]] = True
    return mask.to(device)


@dataclasses.dataclass(frozen=True)
class ProbabilisticScheduler:
    """The paper's joint probabilistic selection + power allocation.

    ``solver`` names the joint solve: "alternating" (paper), "fused" or
    "optimal" (exact).  ``bit_menu`` (uplink widths, e.g. ``(8, 16,
    32)``) adds the bit-allocation step; only the fused solver has it.
    """

    solver: str = "alternating"
    power_solver: str = "dinkelbach"   # "dinkelbach" (paper) | "analytic"
    unbiased_aggregation: bool = False  # beyond-paper alpha_i / a_i correction
    faithful_eq13_typo: bool = False
    bit_menu: Optional[tuple] = None

    def solve(self, problem: WirelessFLProblem) -> JointSolution:
        if self.bit_menu is not None and self.solver != "fused":
            raise ValueError(
                f"bit_menu is implemented by the fused single-level solver "
                f"only; solver={self.solver!r} would silently ignore it")
        if self.solver == "optimal":
            return solve_joint_optimal(problem)
        if self.solver == "fused":
            return solve_joint_fused(problem,
                                     faithful_eq13_typo=self.faithful_eq13_typo,
                                     bit_menu=self.bit_menu)
        if self.solver == "alternating":
            return solve_joint(problem, power_solver=self.power_solver,
                               faithful_eq13_typo=self.faithful_eq13_typo)
        raise ValueError(f"unknown solver {self.solver!r}")

    def precompute(self, problem: WirelessFLProblem) -> SchedulerState:
        sol = self.solve(problem)
        return SchedulerState(a=sol.a, power=sol.power,
                              agg_weights=_data_weights(problem))

    def sample(self, state: SchedulerState, generator: torch.Generator,
               k: int = 0) -> ParticipationDraw:
        a = _round_slice(state.a, k)
        p = _round_slice(state.power, k)
        alpha = state.agg_weights
        if self.unbiased_aggregation:
            alpha = alpha / torch.clamp(a, min=1e-6)
        return ParticipationDraw(mask=bernoulli_mask(generator, a), power=p,
                                 agg_weights=alpha, probs=a)

    def expected_participants(self, state: SchedulerState) -> torch.Tensor:
        a = state.a if state.a.ndim == 1 else state.a.mean(dim=1)
        return torch.sum(a)

    # ---- batched (multi-scenario) path ---------------------------------
    def solve_batch(self, batch: ProblemBatch, **kw) -> BatchSolution:
        """One solve for a whole ProblemBatch of scenarios.

        Keyword overrides win over the scheduler's configuration, so
        ``solve_batch(batch, method="kernel")`` reaches the kernel.  As
        with ``solve()``, the Algorithm-2 knobs only apply to the methods
        that have them.
        """
        kw.setdefault("method", self.solver
                      if self.solver in ("optimal", "fused") else "alternating")
        if kw["method"] == "alternating":
            kw.setdefault("power_solver", self.power_solver)
        if kw["method"] in ("alternating", "fused", "fused_kernel"):
            kw.setdefault("faithful_eq13_typo", self.faithful_eq13_typo)
        if kw["method"] == "fused":
            kw.setdefault("bit_menu", self.bit_menu)
        return solve_joint_batch(batch, **kw)

    def precompute_batch(self, batch: ProblemBatch, **kw) -> SchedulerState:
        """Batched ``precompute``: every tensor gains a leading batch axis.
        Padded device slots have a = 0 and aggregation weight 0."""
        sol = self.solve_batch(batch, **kw)
        masked_sizes = batch.problem.dataset_size * batch.mask
        alpha = masked_sizes / masked_sizes.sum(dim=1, keepdim=True)
        return SchedulerState(a=sol.a, power=sol.power, agg_weights=alpha)

    def sample_batch(self, state: SchedulerState, generator: torch.Generator,
                     k: int = 0) -> ParticipationDraw:
        """Independent participation draws for every instance, ``[B, N]``:
        instance by instance from ``generator``, as ``sample`` draws."""
        draws = [self.sample(SchedulerState(*(x[b] for x in state)),
                             generator, k)
                 for b in range(state.a.shape[0])]
        return ParticipationDraw(*(torch.stack(x) for x in zip(*draws)))


def _top_m_binary(score: torch.Tensor, m) -> torch.Tensor:
    """Binary [N] mask selecting the ``m`` highest-scoring devices (ties
    to the lower index, as the reference's stable argsort)."""
    order = torch.argsort(-score, stable=True)
    ranks = torch.argsort(order, stable=True)
    return (ranks < m).to(score.dtype)


def _round_preserving_count(a: torch.Tensor, per_round: bool = False) -> torch.Tensor:
    """Binarise probabilities keeping the expected participant count: the
    round(sum a) (at least 1) highest-probability devices are selected.
    An [N, K] input keeps round 0's selection unless ``per_round``."""
    def one_round(col):
        k = int(torch.clamp(torch.round(torch.sum(col)), 1, col.shape[0]))
        return _top_m_binary(col, k)

    if a.ndim == 1:
        return one_round(a)
    if per_round:
        return torch.stack([one_round(a[:, j]) for j in range(a.shape[1])],
                           dim=1)
    return torch.broadcast_to(one_round(a[:, 0])[:, None], a.shape)


def _fixed_draw(state: SchedulerState, k: int) -> ParticipationDraw:
    a = _round_slice(state.a, k)
    return ParticipationDraw(mask=a > 0, power=_round_slice(state.power, k),
                             agg_weights=state.agg_weights, probs=a)


@dataclasses.dataclass(frozen=True)
class DeterministicScheduler:
    """Rounded binary version of the probabilistic solution (paper Sec. V),
    expected-count preserving."""

    inner: ProbabilisticScheduler = ProbabilisticScheduler()
    per_round: bool = False

    def precompute(self, problem: WirelessFLProblem) -> SchedulerState:
        sol = self.inner.solve(problem)
        a_bin = _round_preserving_count(sol.a, per_round=self.per_round)
        return SchedulerState(a=a_bin, power=sol.power,
                              agg_weights=_data_weights(problem))

    def sample(self, state: SchedulerState, generator=None,
               k: int = 0) -> ParticipationDraw:
        return _fixed_draw(state, k)


@dataclasses.dataclass(frozen=True)
class UniformScheduler:
    """M clients uniformly at random at P^max; constraint-oblivious [1]."""

    m: int = 10

    def precompute(self, problem: WirelessFLProblem) -> SchedulerState:
        n, dev = problem.n_devices, problem.device
        a = torch.full((n,), self.m / n, device=dev)
        p = torch.full((n,), problem.p_max, device=dev)
        return SchedulerState(a=a, power=p, agg_weights=_data_weights(problem))

    def sample(self, state: SchedulerState, generator: torch.Generator,
               k: int = 0) -> ParticipationDraw:
        mask = uniform_mask(generator, state.a.shape[0], self.m, state.a.device)
        return ParticipationDraw(mask=mask, power=state.power,
                                 agg_weights=state.agg_weights, probs=state.a)


@dataclasses.dataclass(frozen=True)
class EquallyWeightedScheduler:
    """Binary selection with equal device weights, per [6] (Nishio &
    Yonetani); aggregation also equally weighted."""

    inner: ProbabilisticScheduler = ProbabilisticScheduler()

    def precompute(self, problem: WirelessFLProblem) -> SchedulerState:
        equal = dataclasses.replace(
            problem, weights=torch.full_like(problem.weights,
                                             1.0 / problem.n_devices))
        sol = self.inner.solve(equal)
        a_bin = _round_preserving_count(sol.a)
        n_sel = torch.clamp(torch.sum(a_bin if a_bin.ndim == 1 else a_bin[:, 0]),
                            min=1.0)
        alpha = torch.ones_like(problem.weights) / n_sel
        return SchedulerState(a=a_bin, power=sol.power, agg_weights=alpha)

    def sample(self, state: SchedulerState, generator=None,
               k: int = 0) -> ParticipationDraw:
        return _fixed_draw(state, k)


def _tau_feasible_power(problem: WirelessFLProblem) -> torch.Tensor:
    """Minimum power transmitting within tau at full participation:
    clip(P^min(a=1), 0, P^max), [N] or [N, K] on a fading problem.
    Devices whose P^min(1) exceeds P^max are clamped (they violate tau;
    channel-aware selection avoids them)."""
    ones = torch.ones((problem.n_devices,), dtype=torch.float32,
                      device=problem.device)
    return torch.clamp(problem.p_min(ones), 0.0, problem.p_max)


@dataclasses.dataclass(frozen=True)
class GreedyChannelScheduler:
    """Channel-aware greedy: every round, the M devices with the best
    instantaneous channel (highest path gain) transmit at the minimum
    tau-feasible power.  It tracks the fading but ignores energy budgets
    and data weights."""

    m: int = 10

    def precompute(self, problem: WirelessFLProblem) -> SchedulerState:
        gain = problem.path_gain()                  # [N] or [N, K]
        power = _tau_feasible_power(problem)
        m = min(self.m, problem.n_devices)
        if gain.ndim == 1:
            a = _top_m_binary(gain, m)
        else:
            a = torch.stack([_top_m_binary(gain[:, j], m)
                             for j in range(gain.shape[1])], dim=1)
        return SchedulerState(a=a.to(torch.float32), power=power,
                              agg_weights=_data_weights(problem))

    def sample(self, state: SchedulerState, generator=None,
               k: int = 0) -> ParticipationDraw:
        return _fixed_draw(state, k)


@dataclasses.dataclass(frozen=True)
class LyapunovScheduler:
    """Virtual-queue drift-plus-penalty scheduler (cf. Perazzone et al.,
    arXiv:2201.07912).

    Each device carries an energy-budget virtual queue

        Q_i(k+1) = max(Q_i(k) + m_i(k) E_ik - E^max_i, 0),   Q_i(0) = 0,

    where ``E_ik`` is the device's round-k energy at the minimum
    tau-feasible power and ``E^max_i`` its per-round budget.  Round k
    selects device i iff ``V w_i > Q_i(k) E_ik`` (float32, as written).
    The recursion is deterministic given the channel trajectory, so the
    whole schedule precomputes to a per-round binary ``[N, K]`` state;
    ``n_rounds`` sets its length on a static problem.
    """

    v: float = 1.0
    n_rounds: Optional[int] = None

    def _energy_table(self, problem: WirelessFLProblem
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(power, e_rounds [N, K]): per-round full-participation energy."""
        power = _tau_feasible_power(problem)
        e = problem.round_energy(power)             # [N] or [N, K]
        if e.ndim == 1:
            k = self.n_rounds if self.n_rounds else max(problem.n_rounds, 1)
            e = torch.broadcast_to(e[:, None], (e.shape[0], k))
        return power, e

    def _run(self, problem: WirelessFLProblem, e_rounds: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """The queue recursion over the rounds: (queues [K+1, N] with
        Q(0) = 0 first, selections [K, N] bool)."""
        w, emax = problem.weights, problem.energy_budget_j
        vw = torch.tensor(self.v, dtype=torch.float32, device=w.device) * w
        q = torch.zeros((problem.n_devices,), dtype=torch.float32,
                        device=w.device)
        qs, sels = [q], []
        for e_k in e_rounds.T:
            sel = vw > q * e_k
            q = torch.clamp(q + torch.where(sel, e_k, 0.0) - emax, min=0.0)
            qs.append(q)
            sels.append(sel)
        return torch.stack(qs), torch.stack(sels)

    def queue_trajectory(self, problem: WirelessFLProblem) -> torch.Tensor:
        """Virtual-queue path [K+1, N] (Q(0) = 0 first row)."""
        return self._run(problem, self._energy_table(problem)[1])[0]

    def precompute(self, problem: WirelessFLProblem) -> SchedulerState:
        power, e_rounds = self._energy_table(problem)
        sels = self._run(problem, e_rounds)[1]      # [K, N]
        return SchedulerState(a=sels.T.to(torch.float32), power=power,
                              agg_weights=_data_weights(problem))

    def sample(self, state: SchedulerState, generator=None,
               k: int = 0) -> ParticipationDraw:
        return _fixed_draw(state, k)


SCHEDULERS = {
    "probabilistic": ProbabilisticScheduler,
    "deterministic": DeterministicScheduler,
    "uniform": UniformScheduler,
    "equally_weighted": EquallyWeightedScheduler,
    "greedy_channel": GreedyChannelScheduler,
    "lyapunov": LyapunovScheduler,
}


def make_scheduler(name: str, **kwargs):
    return SCHEDULERS[name](**kwargs)
