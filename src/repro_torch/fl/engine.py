"""Federated learning round engine — Algorithm 3 of the paper.

One communication round k:
  1. server broadcasts theta^k (downlink neglected, Sec. II-C),
  2. the scheduler draws the participation mask m ~ Bernoulli(a*_k) and
     supplies transmit powers P*_k,
  3. every participating client computes its local stochastic gradient,
  4. server updates  theta^{k+1} = theta^k - eta * sum_i alpha_i m_i g_i
     (eq. 4),
  5. wall-clock advances by the straggler's transmission time
     max_{i in S} T_ik and energy by sum_{i in S} (E^c_i + P_ik T_ik).

Two aggregation paths, as in ``repro.fl.engine``:

* ``fused``   — alpha_i m_i enters as per-example loss weights, so one
  backward pass over the whole cohort gives the aggregated gradient;
* ``stacked`` — per-client gradients (``torch.func.vmap`` of
  ``torch.func.grad``), then an explicit weighted reduction:
  ``masked_aggregate_pytree`` (the kernel on the card) unless the caller
  passes another ``aggregate_fn``.

This python-loop engine is the reference path; sweeps use
``repro_torch.fl.scan_engine``.  Participation draws come from a
``torch.Generator`` seeded with ``config.seed``, or from ``masks=`` given
by the caller (the reference's ``jax.random`` draws cannot be
reproduced, so parity runs pass them in).  The minibatch schedule is the
reference's numpy stream.  Uplink quantisation (the reference's
``uplink_bits``) comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.problem import WirelessFLProblem, div
from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.masked_aggregate.ops import masked_aggregate_pytree
from repro_torch.models import cnn
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_rounds: int = 300
    batch_per_client: int = 16
    lr: float = 0.05
    eval_every: int = 10
    aggregate: str = "fused"            # "fused" | "stacked"
    include_compute_time: bool = False  # paper: round time = straggler tx time
    # divide eq. (4)'s coefficients by sum_i alpha_i m_i (FedAvg
    # weighting); False is the paper's verbatim fixed alpha_i
    renormalize: bool = True
    seed: int = 0


class FLHistory(NamedTuple):
    rounds: np.ndarray
    sim_time: np.ndarray        # cumulative simulated seconds
    energy: np.ndarray          # cumulative Joules
    participants: np.ndarray    # per-round participant count
    eval_rounds: np.ndarray
    eval_time: np.ndarray
    eval_acc: np.ndarray

    def time_to_accuracy(self, target: float) -> float:
        hit = np.where(self.eval_acc >= target)[0]
        return float(self.eval_time[hit[0]]) if len(hit) else float("nan")

    def energy_to_accuracy(self, target: float) -> float:
        hit = np.where(self.eval_acc >= target)[0]
        if not len(hit):
            return float("nan")
        r = self.eval_rounds[hit[0]]
        return float(self.energy[np.searchsorted(self.rounds, r)])


class FLResult(NamedTuple):
    params: Any
    history: FLHistory


# --------------------------------------------------------------------- steps

def client_grads(params: dict, images: torch.Tensor,
                 labels: torch.Tensor) -> dict:
    """Per-client mean-loss gradients: images [N, b, 28, 28, 1] and
    labels [N, b] -> a tree whose leaves are [N, ...]."""
    grad = torch.func.grad(cnn.loss_fn)
    return torch.func.vmap(grad, in_dims=(None, 0, 0))(params, images, labels)


def _sgd(params: dict, grads: dict, lr: float) -> dict:
    return tree_map(lambda p, g: p - lr * g, params, grads)


def check_config(config: FLConfig) -> None:
    if config.aggregate not in ("fused", "stacked"):
        raise ValueError(f"unknown aggregate mode {config.aggregate!r}")


# -------------------------------------------------------------------- engine

def run_fl(problem: WirelessFLProblem,
           scheduler,
           train: Dataset,
           parts: Sequence[np.ndarray],
           test: Dataset,
           config: FLConfig,
           aggregate_fn: Callable | None = None,
           init_params: Any | None = None,
           *,
           masks: Optional[np.ndarray] = None,
           device=None) -> FLResult:
    """Simulate Algorithm 3 with exact paper time/energy accounting.

    ``masks`` ([K, N] bool) replaces the scheduler's participation draws;
    ``aggregate_fn(gstack, coef)`` replaces the stacked path's
    ``masked_aggregate_pytree``.
    """
    check_config(config)
    dev = resolve_device(device)
    problem = problem.to(dev)
    n = problem.n_devices
    if len(parts) != n:
        raise ValueError(f"{len(parts)} client partitions for {n} devices")
    if masks is not None:
        masks = np.asarray(masks, bool)
        if masks.shape != (config.n_rounds, n):
            raise ValueError(f"masks must be [{config.n_rounds}, {n}], got "
                             f"{masks.shape}")
    rng = np.random.default_rng(config.seed)
    gen = torch.Generator().manual_seed(config.seed)

    if init_params is None:
        params = cnn.init(torch.Generator().manual_seed(config.seed + 17),
                          device=dev)
    else:
        params = tree_map(lambda x: x.to(dev), init_params)
    state = scheduler.precompute(problem)
    ec = problem.compute_energy().cpu().numpy()
    # tx-time table at the planned powers: [N], or [N, K] under fading
    state_power = state.power.cpu().numpy()
    t_table = problem.tx_time(state.power).cpu().numpy()

    fused = config.aggregate == "fused"
    aggregate = masked_aggregate_pytree if aggregate_fn is None else aggregate_fn
    test_x = torch.from_numpy(test.images).to(dev)
    test_y = torch.from_numpy(test.labels).to(dev)

    b = config.batch_per_client
    hist_rounds, hist_time, hist_energy, hist_parts = [], [], [], []
    eval_rounds, eval_time, eval_acc = [], [], []
    cum_time = 0.0
    cum_energy = 0.0

    for k in range(config.n_rounds):
        draw = scheduler.sample(state, gen, k)
        mask = draw.mask.cpu().numpy() if masks is None else masks[k]
        power = draw.power.cpu().numpy()
        alpha = draw.agg_weights.cpu().numpy()

        # ---- accounting (paper Sec. V-B) --------------------------------
        if mask.any():
            planned = state_power if state_power.ndim == 1 else state_power[:, k]
            if np.array_equal(power, planned):
                t_all = t_table if t_table.ndim == 1 else t_table[:, k]
            else:
                t_all = problem.tx_time(draw.power).cpu().numpy()
                if t_all.ndim > 1:      # [N] power on a fading problem
                    t_all = t_all[:, k]
            sel_t = t_all[mask]
            round_time = float(np.max(sel_t))
            if config.include_compute_time:
                comp = (problem.cycles_per_sample * problem.dataset_size
                        / problem.cpu_hz).cpu().numpy()
                round_time = float(np.max(sel_t + comp[mask]))
            round_energy = float(np.sum(power[mask] * sel_t + ec[mask]))
        else:
            round_time, round_energy = 0.0, 0.0

        cum_time += round_time
        cum_energy += round_energy
        hist_rounds.append(k)
        hist_time.append(cum_time)
        hist_energy.append(cum_energy)
        hist_parts.append(int(mask.sum()))

        # ---- learning step (eq. 4) --------------------------------------
        if mask.any():
            batch_idx = np.stack([
                rng.choice(parts[i], size=b, replace=len(parts[i]) < b)
                for i in range(n)])
            images = torch.from_numpy(train.images[batch_idx]).to(dev)
            labels = torch.from_numpy(train.labels[batch_idx]).to(dev)
            coef = torch.from_numpy((alpha * mask).astype(np.float32)).to(dev)
            if config.renormalize:
                coef = coef / torch.clamp(coef.sum(), min=1e-12)
            if fused:
                sw = div(torch.repeat_interleave(coef, b), float(b))
                grads = torch.func.grad(cnn.loss_fn)(
                    params, images.reshape(n * b, 28, 28, 1),
                    labels.reshape(n * b), sw)
            else:
                grads = aggregate(client_grads(params, images, labels), coef)
            params = _sgd(params, grads, config.lr)

        if (k + 1) % config.eval_every == 0 or k == config.n_rounds - 1:
            eval_rounds.append(k)
            eval_time.append(cum_time)
            eval_acc.append(cnn.accuracy(params, test_x, test_y))

    history = FLHistory(
        rounds=np.asarray(hist_rounds), sim_time=np.asarray(hist_time),
        energy=np.asarray(hist_energy), participants=np.asarray(hist_parts),
        eval_rounds=np.asarray(eval_rounds), eval_time=np.asarray(eval_time),
        eval_acc=np.asarray(eval_acc))
    return FLResult(params=params, history=history)
