"""Sweep engine: many FL trajectories advanced together, round by round.

``repro.fl.scan_engine`` compiles each trajectory as a ``lax.scan`` and
vmaps it over a stacked plan.  Here the trajectory axis is a batch
dimension written out: every round runs once for all T trajectories of
a (seed x strategy x scenario) grid — the per-client gradients of every
trajectory in one ``torch.func`` call, and the eq.-4 server sum of every
trajectory in one ``masked_aggregate`` launch per parameter leaf on the
stacked path.

Everything a round needs is precomputed into a :class:`TrajectoryPlan`:
selection probabilities per round, the tx-time/energy tables at the
planned powers (Sec. II-C), the participation masks and the minibatch
index schedule.  The masks are drawn from a ``torch.Generator`` seeded
with ``config.seed`` in the order ``run_fl`` draws them (or are given by
the caller), and the minibatch schedule is the reference's numpy stream,
so a sweep reproduces ``run_fl`` to float tolerance.

A plan with a ``bits`` table trains with a quantised uplink: each round
every client's gradient is stochastically rounded to its width and
summed by the ``quantized_masked_aggregate`` wrapper, with the noise of
``run_fl``'s stream (``engine.quantizer_generator``, seeded per
trajectory seed and round).  ``plans_from_batch`` plans a registry
ensemble from one batched solve.

A plan with a ``drops`` table (``[K, N]`` bool, True where device i's
round-k upload is lost; ``serve.faults.dropout_mask``) trains degraded:
the round's time and energy are charged over the attempted mask, only
the surviving uploads enter the eq.-4 sum, and ``participants`` counts
the survivors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batch import ProblemBatch
from repro_torch.core.problem import WirelessFLProblem, div
from repro_torch.core.schedulers import (
    DeterministicScheduler,
    EquallyWeightedScheduler,
    GreedyChannelScheduler,
    LyapunovScheduler,
    ProbabilisticScheduler,
    SchedulerState,
    UniformScheduler,
    bernoulli_mask,
    uniform_mask,
)
from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.fl.engine import (FLConfig, FLHistory, FLResult, check_config,
                                   quantizer_generator)
from repro_torch.kernels.masked_aggregate.ops import (masked_aggregate_pytree,
                                                      quantized_aggregate_pytree)
from repro_torch.models import cnn
from repro_torch.tree import tree_map

# participation-sampling modes
MODE_BERNOULLI = 0   # probabilistic: m_i ~ Bernoulli(a_ik)
MODE_FIXED = 1       # deterministic / equally-weighted / greedy /
#                      Lyapunov: m_i = [a_ik > 0]
MODE_UNIFORM = 2     # uniform: exactly M clients via a random permutation


@dataclasses.dataclass(frozen=True)
class TrajectoryPlan:
    """Everything one trajectory needs, precomputed to tables.

    Per-round tables are ``[K, N]`` (round-major); ``stack_plans`` adds a
    leading trajectory axis to every field.  ``masks`` takes the place of
    the reference's PRNG key: it holds the draws themselves.  ``drops``,
    when present, marks the lost uploads (the attempt is still charged);
    ``bits``, when present, switches the trajectory to the quantised
    uplink.
    """

    probs: torch.Tensor         # [K, N] selection probabilities a_ik
    tx_time: torch.Tensor       # [K, N] T_ik at the planned power P*_ik (eq. 1)
    round_energy: torch.Tensor  # [K, N] E^c_i + P*_ik T_ik per participant (eq. 6)
    comp_time: torch.Tensor     # [N] local computation time
    agg_weights: torch.Tensor   # [N] alpha_i for the server update (eq. 4)
    batch_idx: torch.Tensor     # [K, N, b] int64 planned client minibatches
    masks: torch.Tensor         # [K, N] bool participation masks
    lr: torch.Tensor            # scalar f32 learning rate
    unbiased: torch.Tensor      # scalar bool: alpha_i / a_ik correction
    dataset_id: torch.Tensor    # scalar int64 row into the stacked datasets
    seed: torch.Tensor          # scalar int64 config.seed: the quantiser noise
    drops: Optional[torch.Tensor] = None  # [K, N] bool, True = upload lost
    bits: Optional[torch.Tensor] = None  # [K, N] f32 uplink widths b_ik

    @property
    def n_rounds(self) -> int:
        return int(self.probs.shape[-2])

    @property
    def n_devices(self) -> int:
        return int(self.probs.shape[-1])

    def to(self, device) -> "TrajectoryPlan":
        return TrajectoryPlan(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


class SweepResult(NamedTuple):
    """Output of ``run_fl_sweep`` (leading trajectory axis)."""

    params: Any                  # tree, every leaf [T, ...]
    histories: list[FLHistory]   # per trajectory, run_fl's layout

    def result(self, t: int) -> FLResult:
        return FLResult(params=tree_map(lambda x: x[t], self.params),
                        history=self.histories[t])


# ------------------------------------------------------------- planning

def _scheduler_mode(scheduler) -> tuple[int, int, bool]:
    """(mode, m, unbiased) encoding of a scheduler's sampling behaviour."""
    if isinstance(scheduler, ProbabilisticScheduler):
        return MODE_BERNOULLI, 0, bool(scheduler.unbiased_aggregation)
    if isinstance(scheduler, (DeterministicScheduler, EquallyWeightedScheduler,
                              GreedyChannelScheduler, LyapunovScheduler)):
        return MODE_FIXED, 0, False
    if isinstance(scheduler, UniformScheduler):
        return MODE_UNIFORM, int(scheduler.m), False
    raise TypeError(
        f"cannot plan scheduler {type(scheduler).__name__}; expected one of "
        "Probabilistic/Deterministic/Uniform/EquallyWeighted/"
        "GreedyChannel/Lyapunov")


def draw_masks(probs: torch.Tensor, mode: int, m: int,
               generator: torch.Generator) -> torch.Tensor:
    """[K, N] participation masks, one round after another, consuming
    ``generator`` exactly as ``run_fl``'s per-round ``sample`` calls do."""
    if mode == MODE_FIXED:
        return probs > 0
    rows = []
    for a_k in probs:
        if mode == MODE_BERNOULLI:
            rows.append(bernoulli_mask(generator, a_k))
        else:
            rows.append(uniform_mask(generator, a_k.shape[0], m, a_k.device))
    return torch.stack(rows)


def _per_round(x: torch.Tensor, n_rounds: int, name: str) -> torch.Tensor:
    """[N] or [N, K_sol] -> round-major [K, N] float32 on the host."""
    x = x.detach().to("cpu", torch.float32)
    if x.ndim == 1:
        return x.expand(n_rounds, x.shape[0]).contiguous()
    if x.shape[1] < n_rounds:
        raise ValueError(
            f"{name} covers {x.shape[1]} fading rounds but the config asks "
            f"for {n_rounds}; regenerate the scenario with n_rounds >= that")
    return x[:, :n_rounds].T.contiguous()


def plan_trajectory(problem: WirelessFLProblem,
                    scheduler,
                    parts: Sequence[np.ndarray],
                    config: FLConfig,
                    *,
                    state: Optional[SchedulerState] = None,
                    dataset_id: int = 0,
                    masks: Optional[np.ndarray] = None,
                    drops: Optional[np.ndarray] = None,
                    bits=None) -> TrajectoryPlan:
    """Build one trajectory's plan (on the host), mirroring ``run_fl``.

    ``state`` reuses one ``precompute`` across many seeds.  ``masks``
    ([K, N] bool) replaces the draws from ``config.seed``'s generator.
    The minibatch schedule consumes ``np.random.default_rng(config.seed)``
    exactly as ``run_fl`` does (draws only on rounds with a participant).

    ``drops`` is an optional ``[K, N]`` bool upload-loss table (True =
    the round-k upload from device i never arrives).  The minibatch
    schedule still draws on every round with an attempted upload.

    ``bits`` is an optional ``[N]`` or ``[N, K]`` uplink width table (e.g.
    ``solve_joint_fused(..., bit_menu=...)``'s choice); ``config.uplink_bits``
    is shorthand for a uniform one.  Either needs ``aggregate='stacked'``.
    """
    check_config(config)
    if config.uplink_bits is not None:
        if bits is not None:
            raise ValueError(
                "pass either config.uplink_bits (uniform) or a per-device "
                "bits table, not both")
        bits = np.full(problem.n_devices, float(config.uplink_bits), np.float32)
    if bits is not None and config.aggregate != "stacked":
        raise ValueError("uplink quantisation requires aggregate='stacked' "
                         "(per-client gradients must exist to quantise)")
    n = problem.n_devices
    if len(parts) != n:
        raise ValueError(f"{len(parts)} client partitions for {n} devices")
    k_rounds = config.n_rounds
    b = config.batch_per_client
    state = scheduler.precompute(problem) if state is None else state
    mode, m, unbiased = _scheduler_mode(scheduler)

    probs = _per_round(state.a, k_rounds, "selection probabilities")
    t_table = _per_round(problem.tx_time(state.power), k_rounds,
                         "tx-time table")
    ec = problem.compute_energy().cpu()
    e_up = _per_round(problem.upload_energy(state.power), k_rounds,
                      "upload-energy table")
    comp = (problem.cycles_per_sample * problem.dataset_size
            / problem.cpu_hz).cpu()

    if masks is None:
        gen = torch.Generator().manual_seed(config.seed)
        mask_t = draw_masks(probs, mode, m, gen)
    else:
        mask_t = torch.from_numpy(np.array(masks, dtype=bool))
        if tuple(mask_t.shape) != (k_rounds, n):
            raise ValueError(f"masks must be [{k_rounds}, {n}], got "
                             f"{tuple(mask_t.shape)}")

    drop_t = None
    if drops is not None:
        drop_t = torch.from_numpy(np.array(drops, dtype=bool))
        if tuple(drop_t.shape) != (k_rounds, n):
            raise ValueError(f"drops must be [{k_rounds}, {n}], got "
                             f"{tuple(drop_t.shape)}")

    # minibatch schedule: same generator, same consumption order as run_fl
    rng = np.random.default_rng(config.seed)
    batch_idx = np.zeros((k_rounds, n, b), np.int64)
    any_part = mask_t.any(dim=1).tolist()
    for k in range(k_rounds):
        if any_part[k]:
            batch_idx[k] = np.stack([
                rng.choice(parts[i], size=b, replace=len(parts[i]) < b)
                for i in range(n)])

    return TrajectoryPlan(
        probs=probs,
        tx_time=t_table,
        round_energy=e_up + ec[None, :],
        comp_time=comp,
        agg_weights=state.agg_weights.detach().to("cpu", torch.float32),
        batch_idx=torch.from_numpy(batch_idx),
        masks=mask_t,
        lr=torch.tensor(config.lr, dtype=torch.float32),
        unbiased=torch.tensor(unbiased),
        dataset_id=torch.tensor(dataset_id, dtype=torch.int64),
        seed=torch.tensor(config.seed, dtype=torch.int64),
        drops=drop_t,
        bits=None if bits is None else _per_round(
            bits if isinstance(bits, torch.Tensor)
            else torch.from_numpy(np.array(bits, np.float32)),
            k_rounds, "bit-width table"),
    )


def plans_from_batch(batch: ProblemBatch,
                     scheduler: ProbabilisticScheduler,
                     parts_list: Sequence[Sequence[np.ndarray]],
                     configs: Sequence[FLConfig],
                     dataset_ids: Optional[Sequence[int]] = None,
                     masks: Optional[Sequence[np.ndarray]] = None,
                     **solve_kw) -> list[TrajectoryPlan]:
    """One batched solve (``precompute_batch``), then one plan per instance.

    All instances must share a fleet size: a ragged batch pads device
    slots, and the uniform strategy's draws over the padded axis would
    change.  ``masks`` (one ``[K, N]`` array per instance) replaces the
    draws from each ``config.seed``, as in ``plan_trajectory``.
    """
    sizes = batch.fleet_sizes.cpu().numpy()
    if not (sizes == sizes[0]).all():
        raise ValueError(
            f"plans_from_batch needs a uniform fleet size, got {sizes}; "
            "stack equal-N instances (no padding) for the FL sweep")
    state = scheduler.precompute_batch(batch, **solve_kw)
    problems = batch.unstack()
    if dataset_ids is None:
        dataset_ids = range(len(problems))
    if masks is None:
        masks = [None] * len(problems)
    return [plan_trajectory(problem, scheduler, parts, cfg,
                            state=SchedulerState(*(x[i] for x in state)),
                            dataset_id=int(ds), masks=m)
            for i, (problem, parts, cfg, ds, m) in enumerate(
                zip(problems, parts_list, configs, dataset_ids, masks))]


def stack_plans(plans: Sequence[TrajectoryPlan]) -> TrajectoryPlan:
    """Stack per-trajectory plans along a new leading sweep axis."""
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    if 0 < sum(p.drops is not None for p in plans) < len(plans):
        raise ValueError(
            "cannot stack plans with and without drop tables; give the "
            "fault-free plans an all-False [K, N] drops array")
    if 0 < sum(p.bits is not None for p in plans) < len(plans):
        raise ValueError(
            "cannot stack plans with and without bit-width tables; give "
            "the full-precision plans an all-32 [K, N] bits table")
    ref = plans[0]
    for p in plans[1:]:
        if (p.n_rounds, p.n_devices, p.batch_idx.shape) != (
                ref.n_rounds, ref.n_devices, ref.batch_idx.shape):
            raise ValueError(
                "all plans in a sweep must share (n_rounds, n_devices, "
                f"batch_per_client); got {tuple(p.probs.shape)} vs "
                f"{tuple(ref.probs.shape)}")
    return TrajectoryPlan(**{
        f.name: None if getattr(ref, f.name) is None
        else torch.stack([getattr(p, f.name) for p in plans])
        for f in dataclasses.fields(TrajectoryPlan)})


# --------------------------------------------------------------- one round

def _eval_rounds(config: FLConfig) -> tuple[int, ...]:
    """``run_fl``'s eval schedule: every eval_every-th round and the last."""
    return tuple(k for k in range(config.n_rounds)
                 if (k + 1) % config.eval_every == 0 or k == config.n_rounds - 1)


def _grid_grads(params, images, labels, coef, fused: bool, bits=None,
                **noise_src):
    """The aggregated eq.-4 gradient of every trajectory: params leaves
    [T, ...], images [T, N, b, 28, 28, 1], labels [T, N, b], coef [T, N].
    With ``bits`` ([T, N]) every client's gradient is quantised in the
    sum, its noise from ``generator=`` (one per trajectory) or
    ``noise=``."""
    t, n, b = labels.shape
    grad = torch.func.grad(cnn.loss_fn)
    if fused:
        sw = div(torch.repeat_interleave(coef, b, dim=1), float(b))
        return torch.func.vmap(grad)(
            params, images.reshape(t, n * b, 28, 28, 1),
            labels.reshape(t, n * b), sw)
    client = torch.func.vmap(grad, in_dims=(None, 0, 0))
    gstack = torch.func.vmap(client)(params, images, labels)   # [T, N, ...]
    if bits is not None:
        return quantized_aggregate_pytree(gstack, coef, bits, **noise_src)
    return masked_aggregate_pytree(gstack, coef)


def _accuracy(params, test_x, test_y) -> torch.Tensor:
    """[T] test accuracy of every trajectory on its own test set."""
    logits = torch.func.vmap(cnn.apply)(params, test_x)
    return torch.mean((torch.argmax(logits, -1) == test_y).to(torch.float32),
                      dim=1)


# ------------------------------------------------------------- public API

def _stack_datasets(data: Dataset | Sequence[Dataset], device):
    if isinstance(data, Dataset):
        data = [data]
    x = torch.from_numpy(np.stack([d.images for d in data])).to(device)
    y = torch.from_numpy(np.stack([d.labels for d in data]).astype(np.int64))
    return x, y.to(device)


def run_fl_sweep(plans: TrajectoryPlan,
                 train: Dataset | Sequence[Dataset],
                 test: Dataset | Sequence[Dataset],
                 config: FLConfig,
                 init_params: Any,
                 *,
                 shard: bool = True,
                 noise: Optional[Sequence] = None,
                 device=None) -> SweepResult:
    """Run every trajectory of a stacked plan, all rounds in lockstep.

    ``init_params`` is a stacked params tree ([T, ...] leaves, see
    ``init_sweep_params``); ``train``/``test`` are one shared dataset or
    one per ``dataset_id``.  The stacked path's eq.-4 sum is the
    ``masked_aggregate`` wrapper, or with a ``bits`` table the
    ``quantized_masked_aggregate`` one, so it runs the kernel on the
    card (the reference's ``use_kernel=True``).  ``noise`` (one tree of
    ``[T, N, ...]`` uniform(0,1) arrays per round) replaces the
    quantiser's draws.  ``shard`` is a no-op: the port runs on one
    device.
    """
    check_config(config)
    if plans.n_rounds != config.n_rounds:
        raise ValueError(f"plan has {plans.n_rounds} rounds, "
                         f"config.n_rounds={config.n_rounds}")
    quantized = plans.bits is not None
    if quantized and config.aggregate != "stacked":
        raise ValueError("quantized plans (bits tables) require "
                         "aggregate='stacked'")
    if config.uplink_bits is not None and not quantized:
        raise ValueError("config.uplink_bits is set but the stacked plans "
                         "carry no bits table; build them with "
                         "plan_trajectory(..., config) so the table exists")
    if noise is not None and (not quantized or len(noise) != config.n_rounds):
        raise ValueError("noise= needs plans with a bits table and one tree "
                         "per round")
    seeds = plans.seed.tolist()
    dev = resolve_device(device)
    plans = plans.to(dev)
    params = tree_map(lambda x: x.to(dev), init_params)
    train_x, train_y = _stack_datasets(train, dev)
    test_x, test_y = _stack_datasets(test, dev)
    test_x, test_y = test_x[plans.dataset_id], test_y[plans.dataset_id]
    fused = config.aggregate == "fused"
    eval_rounds = _eval_rounds(config)
    rows = plans.dataset_id[:, None, None]

    times, energies, counts, accs = [], [], [], []
    for k in range(config.n_rounds):
        mask = plans.masks[:, k]                       # [T, N] attempted
        a_k = plans.probs[:, k]

        # -- accounting (paper Sec. V-B): straggler tx time, summed E --
        # over the attempted mask: a lost upload still spent its energy
        # and the round still waited on it
        t_k = plans.tx_time[:, k]
        if config.include_compute_time:
            t_k = t_k + plans.comp_time
        straggler = torch.amax(torch.where(mask, t_k, -torch.inf), dim=1)
        times.append(torch.where(mask.any(dim=1), straggler, 0.0))
        energies.append(torch.sum(torch.where(mask, plans.round_energy[:, k],
                                              0.0), dim=1))

        # -- server update (eq. 4) over the surviving uploads ------------
        if plans.drops is not None:
            mask = mask & ~plans.drops[:, k]
        counts.append(mask.sum(dim=1))
        fmask = mask.to(torch.float32)
        alpha = torch.where(plans.unbiased[:, None],
                            plans.agg_weights / torch.clamp(a_k, min=1e-6),
                            plans.agg_weights)
        coef = alpha * fmask
        if config.renormalize:
            coef = coef / torch.clamp(coef.sum(dim=1, keepdim=True), min=1e-12)
        idx = plans.batch_idx[:, k]                    # [T, N, b]
        quant = {}
        if quantized:
            quant = (dict(noise=noise[k]) if noise is not None else
                     dict(generator=[quantizer_generator(s, k, dev)
                                     for s in seeds]))
            quant["bits"] = plans.bits[:, k]
        grads = _grid_grads(params, train_x[rows, idx], train_y[rows, idx],
                            coef, fused, **quant)
        # an all-zero coef (empty round) makes grads exactly zero, so the
        # update is a no-op — the reference loop's skip
        params = tree_map(
            lambda p, g: p - plans.lr.reshape((-1,) + (1,) * (g.ndim - 1)) * g,
            params, grads)
        if k in eval_rounds:
            accs.append(_accuracy(params, test_x, test_y))

    round_time = torch.stack(times, dim=1).cpu().numpy()       # [T, K]
    round_energy = torch.stack(energies, dim=1).cpu().numpy()
    participants = torch.stack(counts, dim=1).cpu().numpy()
    acc = torch.stack(accs, dim=1).cpu().numpy()
    ev = np.asarray(eval_rounds)
    histories = []
    for t in range(round_time.shape[0]):
        # float64 cumulation, as run_fl accumulates python floats
        sim_time = np.cumsum(round_time[t], dtype=np.float64)
        energy = np.cumsum(round_energy[t], dtype=np.float64)
        histories.append(FLHistory(
            rounds=np.arange(config.n_rounds), sim_time=sim_time,
            energy=energy, participants=participants[t].astype(np.int64),
            eval_rounds=ev, eval_time=sim_time[ev], eval_acc=acc[t]))
    return SweepResult(params=params, histories=histories)


def init_sweep_params(configs: Sequence[FLConfig], device=None) -> Any:
    """Per-trajectory model inits, stacked: ``cnn.init`` from a generator
    seeded with ``seed + 17`` per config, as ``run_fl`` does."""
    dev = resolve_device(device)
    inits = [cnn.init(torch.Generator().manual_seed(c.seed + 17), device=dev)
             for c in configs]
    return tree_map(lambda *xs: torch.stack(xs), *inits)


def run_fl_scan(problem: WirelessFLProblem,
                scheduler,
                train: Dataset,
                parts: Sequence[np.ndarray],
                test: Dataset,
                config: FLConfig,
                init_params: Any | None = None,
                *,
                masks: Optional[np.ndarray] = None,
                device=None,
                **sweep_kw) -> FLResult:
    """``run_fl`` through the sweep engine (one trajectory)."""
    dev = resolve_device(device)
    plan = plan_trajectory(problem.to(dev), scheduler, parts, config,
                           masks=masks)
    if init_params is None:
        params0 = init_sweep_params([config], device=dev)
    else:
        params0 = tree_map(lambda x: x[None], init_params)
    sweep = run_fl_sweep(stack_plans([plan]), train, test, config, params0,
                         device=dev, **sweep_kw)
    return sweep.result(0)
