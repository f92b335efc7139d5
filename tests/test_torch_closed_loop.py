"""Parity of the port's drift-aware closed loop with the JAX reference.

The channel-aware schedulers (greedy, Lyapunov), ``round_energy``, upload
drops in the sweep, the online control pass (``solve_rounds``) with its
checkpoint resume, every strategy's state, the grid, and the four entry
points of the slice, on seeded drifting_metro cells of 8 devices.

``jax.random`` streams cannot be reproduced in torch, so whole grids are
held against the reference only for the fixed-mode strategies
(deterministic, greedy_channel, lyapunov), whose masks are their states.
The sampled strategies (probabilistic, uniform, joint_bits) are held at
the plan and sweep level, with the reference's masks and quantiser noise
passed in.  The grid's initial parameters come from the port's own
generator, so grid rows are compared without ``final_acc``; the sweep
tests pass the reference's parameters in and compare accuracy too.

Tolerances:

* a* and P* at 1e-5 (P* as atol = rtol), the reference's solver
  tolerance; ``round_energy`` and the tau-feasible power at rtol 1e-6
  (``expm1`` and ``log`` may differ by an ulp between XLA and torch);
* the Lyapunov queues at rtol 1e-5 (atol 1e-12); the binary selections
  of greedy and Lyapunov exactly.  Both are discontinuous: a one-ulp
  difference in the path gain or the energy can flip a device.  Where a
  selection differs, the test requires the reference's decision margin
  there (``|V w - Q E|``, or the gain's distance from the M-th best
  gain) to be within ``ULPS`` float32 ulps, and compares rounds only up
  to the first flip (the queues diverge after it);
* bit widths and participant counts exactly; time and energy at rtol
  1e-6 where both packages plan at the same powers, 1e-5 where the port
  plans at its own control pass's (a solver tolerance away);
* the inputs of every round's eq.-4 sum, read from the port's sweep
  (``_grid_grads``): the coefficients over the surviving uploads at rtol
  1e-6 against the reference's composition from its plan, the client
  minibatches and the widths exactly;
* parameters at 1e-5, accuracy at atol 0.02, as ``test_torch_fl.py``;
  quantised parameters within one quantiser level per round, as
  ``test_torch_quantized.py``.  The CNN's gradient is discontinuous at a
  ReLU zero and at a max-pool tie, where a one-ulp difference between
  XLA's and torch's forward pass routes a gradient another way.  A
  trajectory whose end point differs is accepted only with the evidence
  that this happened: on some round, a participating client's gradient,
  evaluated by both packages on the port's own inputs of that round,
  differs by more than 1e-5;
* the port against itself (no drops against an all-False table, a
  resumed control pass against an uninterrupted one) bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import problem as ref_problem_mod
from repro.core import scenarios as ref_scen
from repro.core import schedulers as ref_sched
from repro.data.partition import dirichlet_partition as ref_partition
from repro.data.synthetic import make_mnist_like as ref_make_mnist_like
from repro.fl import closed_loop as ref_cl
from repro.fl import engine as ref_engine
from repro.fl import scan_engine as ref_scan
from repro.models import cnn as ref_cnn
from repro.serve import faults as ref_faults
from repro.serve import fleet_service as ref_fs
from repro_torch import (closed_loop_demo, compression_study, fading_rounds,
                         quickstart)
from repro_torch.convert import params_from_numpy, params_to_numpy, problem_from_numpy
from repro_torch.core import schedulers
from repro_torch.core.scenarios import make_problem
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.fl import closed_loop as cl
from repro_torch.fl import engine, scan_engine
from repro_torch.serve import faults
from repro_torch.serve.fleet_service import FleetControlService, ServiceConfig
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N, K = 8, 5
SOLVE_TOL = 1e-5
ENERGY_RTOL = 1e-6
QUEUE_RTOL = 1e-5
TIME_RTOL = 1e-6
ROW_RTOL = 1e-5
PARAM_TOL = 1e-5
ACC_ATOL = 0.02
FLIP_SHARE = 1e-3
ULPS = 4
FAULTS = dict(seed=3, device_rate=0.25, drop_rate=0.3)
CFG = dict(n_devices=N, n_rounds=K, n_train=256, n_test=64, eval_every=2,
           n_seeds=2)
FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j", "dataset_size",
          "cycles_per_sample", "cpu_hz", "weights", "fading",
          "interference", "bits")
CONSTANTS = ("grad_size_bits", "noise_power", "p_max", "tau_th", "kappa",
             "n_rounds")
CNN_SHAPES = {"conv1": {"w": (3, 3, 1, 8), "b": (8,)},
              "conv2": {"w": (3, 3, 8, 16), "b": (16,)},
              "fc1": {"w": (784, 249), "b": (249,)},
              "fc2": {"w": (249, 10), "b": (10,)}}


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_problem(ref):
    fields = {f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
              for f in FIELDS}
    fields.update({c: getattr(ref, c) for c in CONSTANTS})
    return problem_from_numpy(fields, device="cpu")


def port_state(ref_state):
    return schedulers.SchedulerState(*(torch.from_numpy(np.array(x))
                                       for x in ref_state))


def ref_drifting(seed=0, **kw):
    kw = dict(dict(n_devices=N, n_rounds=K, tau_th=0.5), **kw)
    return ref_scen.make_problem("drifting_metro", seed=seed, **kw)


def ref_masks(plan):
    return np.asarray(ref_scan._mask_stream(plan.key, plan.probs, plan.mode,
                                            plan.m))


def ref_noise_tree(key, n):
    """The reference's quantiser noise for one round: split over the
    leaves (sorted keys), then over the clients, uniform per client."""
    leaves, treedef = jax.tree_util.tree_flatten(
        CNN_SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    keys = jax.random.split(key, len(leaves))
    out = [np.array(jax.vmap(lambda kk, s=s: jax.random.uniform(kk, s))(
        jax.random.split(k, n))) for s, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, out)


def ref_round_noise(seed, n_rounds, n):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        out.append(ref_noise_tree(jax.random.fold_in(sub, 1), n))
    return out


def stack_noise(per_traj):
    return [jax.tree_util.tree_map(lambda *xs: np.stack(xs), *rounds)
            for rounds in zip(*per_traj)]


def assert_selections(ref_a, got_a, margin, scale):
    """[N, K] binary selections equal; where they are not, the reference's
    decision ``margin`` at the first differing round is within ULPS ulps
    of ``scale``.  Returns the rounds compared (up to the first flip)."""
    ref_a, got_a = np.asarray(ref_a) > 0, np.asarray(got_a) > 0
    diff = ref_a != got_a
    if not diff.any():
        return ref_a.shape[1]
    k0 = int(np.flatnonzero(diff.any(axis=0))[0])
    i = np.flatnonzero(diff[:, k0])
    tol = ULPS * np.spacing(np.abs(np.asarray(scale, np.float32)[i, k0]))
    assert (np.asarray(margin)[i, k0] <= tol).all(), (k0, i)
    return k0


@pytest.fixture
def sum_inputs(monkeypatch):
    """Every round's inputs of the port sweep's eq.-4 sum, in order."""
    calls = []
    orig = scan_engine._grid_grads

    def spy(params, images, labels, coef, fused, bits=None, **noise_src):
        calls.append(dict(params=params, images=images, labels=labels,
                          coef=coef, bits=bits))
        return orig(params, images, labels, coef, fused, bits=bits,
                    **noise_src)
    monkeypatch.setattr(scan_engine, "_grid_grads", spy)
    return calls


def ref_coef(ref_plan, k):
    """The reference sweep's round-k eq.-4 coefficients (renormalised,
    over the surviving uploads), from its plan."""
    mask = ref_masks(ref_plan)[k]
    if ref_plan.drops is not None:
        mask = mask & ~np.asarray(ref_plan.drops)[k]
    c = np.asarray(ref_plan.agg_weights) * mask.astype(np.float32)
    return c / np.maximum(c.sum(), np.float32(1e-12))


def assert_sum_inputs(calls, ref_plans, ref_train):
    """The port's per-round eq.-4 inputs against the reference plans'."""
    assert len(calls) == ref_plans[0].probs.shape[0]
    for k, call in enumerate(calls):
        for t, rp in enumerate(ref_plans):
            np.testing.assert_allclose(np_(call["coef"][t]), ref_coef(rp, k),
                                       rtol=1e-6, atol=0)
            idx = np.asarray(rp.batch_idx)[k]
            np.testing.assert_array_equal(np_(call["images"][t]),
                                          ref_train.images[idx])
            np.testing.assert_array_equal(np_(call["labels"][t]),
                                          ref_train.labels[idx])
            if rp.bits is not None:
                np.testing.assert_array_equal(np_(call["bits"][t]),
                                              np.asarray(rp.bits)[k])


def cnn_gradients_disagree(calls, t) -> bool:
    """Whether, on some round, a participating client's gradient differs
    between the packages on the port's own inputs of that round."""
    grad = jax.jit(jax.vmap(jax.grad(ref_cnn.loss_fn), in_axes=(None, 0, 0)))
    for call in calls:
        params = {layer: {k: v[t] for k, v in leaves.items()}
                  for layer, leaves in call["params"].items()}
        got = engine.client_grads(params, call["images"][t], call["labels"][t])
        ref = grad(jax.tree_util.tree_map(lambda x: jnp.asarray(np_(x)), params),
                   jnp.asarray(np_(call["images"][t])),
                   jnp.asarray(np_(call["labels"][t])))
        on = np_(call["coef"][t]) > 0
        gap = max(float(np.abs(np_(g)[on] - np.asarray(r)[on]).max(initial=0.0))
                  for g, r in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)))
        if gap > PARAM_TOL:
            return True
    return False


def assert_end_point(ref_params, got_params, calls, t, level=None):
    """Trajectory t's parameters at PARAM_TOL (within ``level`` per
    element for all but FLIP_SHARE of them when quantised), or the
    evidence that the CNN's gradient itself split the packages."""
    r = np.concatenate([np.asarray(x).ravel()
                        for x in jax.tree_util.tree_leaves(ref_params)])
    g = np.concatenate([x.ravel() for x in tree_leaves(params_to_numpy(got_params))])
    off = np.abs(g - r) > PARAM_TOL + PARAM_TOL * np.abs(r)
    if level is None:
        ok = not off.any()
    else:
        ok = off.mean() <= FLIP_SHARE and np.abs(g - r).max() <= PARAM_TOL + level
    assert ok or cnn_gradients_disagree(calls, t), \
        f"trajectory {t}: {off.sum()} of {off.size} parameters differ"


def assert_history(ref, got, rtol=TIME_RTOL, acc=True):
    np.testing.assert_array_equal(got.rounds, ref.rounds)
    np.testing.assert_allclose(got.sim_time, ref.sim_time, rtol=rtol)
    np.testing.assert_allclose(got.energy, ref.energy, rtol=rtol)
    np.testing.assert_array_equal(got.participants, ref.participants)
    np.testing.assert_array_equal(got.eval_rounds, ref.eval_rounds)
    if acc:
        np.testing.assert_allclose(got.eval_acc, ref.eval_acc, atol=ACC_ATOL)


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def cell():
    """The reference's drifting cell, the port's draw of it, and both
    packages' control passes over it (each on its own service)."""
    ref_prob = ref_drifting()
    prob = make_problem("drifting_metro", seed=0, n_devices=N, n_rounds=K,
                        tau_th=0.5, device="cpu")
    ref_control = ref_cl.solve_rounds(
        ref_prob, ref_fs.FleetControlService(ref_fs.ServiceConfig()))
    control = cl.solve_rounds(
        prob, FleetControlService(ServiceConfig(), device="cpu"))
    return dict(ref_prob=ref_prob, prob=prob, ref_control=ref_control,
                control=control)


@pytest.fixture(scope="module")
def data():
    ref_train, ref_test = ref_make_mnist_like(256, 64, seed=0)
    train, test = make_mnist_like(256, 64, seed=0)
    parts = ref_partition(ref_train, N, 0.3, seed=1)
    return dict(ref_train=ref_train, ref_test=ref_test, train=train,
                test=test, parts=parts)


def test_port_draws_the_reference_cell(cell):
    for f in FIELDS:
        r, g = getattr(cell["ref_prob"], f), getattr(cell["prob"], f)
        assert (r is None) == (g is None), f
        if r is not None:
            np.testing.assert_array_equal(np_(g), np.asarray(r), err_msg=f)
    for c in CONSTANTS:
        assert getattr(cell["prob"], c) == getattr(cell["ref_prob"], c), c


# ----------------------------------------------------------- schedulers

@pytest.mark.parametrize("fading", [False, True])
def test_round_energy_matches_reference(fading):
    ref_p = ref_drifting(seed=2) if fading else \
        ref_problem_mod.sample_problem(2, N, tau_th=0.5)
    got_p = port_problem(ref_p)
    rng = np.random.default_rng(0)
    shape = (N, K) if fading else (N,)
    power = rng.uniform(0.01, 1.0, shape).astype(np.float32)
    ref = np.asarray(ref_p.round_energy(jnp.asarray(power)))
    got = np_(got_p.round_energy(torch.from_numpy(power)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=ENERGY_RTOL)
    np.testing.assert_allclose(
        np_(schedulers._tau_feasible_power(got_p)),
        np.asarray(ref_sched._tau_feasible_power(ref_p)), rtol=ENERGY_RTOL)


@pytest.mark.parametrize("m", [3, 5, 10 * N])
@pytest.mark.parametrize("fading", [False, True])
def test_greedy_state_matches_reference(m, fading):
    ref_p = ref_drifting(seed=1) if fading else \
        ref_problem_mod.sample_problem(1, N, tau_th=0.5)
    got_p = port_problem(ref_p)
    ref = ref_sched.GreedyChannelScheduler(m=m).precompute(ref_p)
    got = schedulers.GreedyChannelScheduler(m=m).precompute(got_p)
    gain = np.asarray(ref_p.path_gain()).reshape(N, -1)
    np.testing.assert_array_equal(np_(got_p.path_gain()).reshape(N, -1), gain)
    # margin: distance of each gain from the M-th best of its round
    mth = -np.sort(-gain, axis=0)[min(m, N) - 1]
    assert_selections(np.asarray(ref.a).reshape(N, -1),
                      np_(got.a).reshape(N, -1),
                      np.abs(gain - mth), np.maximum(gain, mth))
    assert np_(got.a).sum(axis=0).max() == min(m, N)
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               rtol=ENERGY_RTOL)
    np.testing.assert_allclose(np_(got.agg_weights),
                               np.asarray(ref.agg_weights), rtol=1e-6)
    draw = schedulers.GreedyChannelScheduler(m=m).sample(got, None, 0)
    np.testing.assert_array_equal(np_(draw.mask), np_(got.a).reshape(N, -1)[:, 0] > 0)


@pytest.mark.parametrize("v,budgets", [(1e-4, None), (1.0, None),
                                       (1e-4, (1e-4, 1e-3))])
def test_lyapunov_matches_reference(v, budgets):
    kw = {} if budgets is None else dict(energy_budget_range=budgets)
    ref_p = ref_drifting(seed=1, **kw)
    got_p = port_problem(ref_p)
    ref_s, got_s = ref_sched.LyapunovScheduler(v=v), schedulers.LyapunovScheduler(v=v)
    ref, got = ref_s.precompute(ref_p), got_s.precompute(got_p)
    ref_q = np.asarray(ref_s.queue_trajectory(ref_p))        # [K+1, N]
    got_q = np_(got_s.queue_trajectory(got_p))
    e = np.asarray(ref_p.round_energy(ref.power))            # [N, K]
    vw = np.float32(v) * np.asarray(ref_p.weights)
    qe = ref_q[:-1].T * e
    k_ok = assert_selections(ref.a, got.a, np.abs(vw[:, None] - qe),
                             np.maximum(vw[:, None], qe))
    assert got_q.shape == ref_q.shape == (K + 1, N)
    np.testing.assert_allclose(got_q[:k_ok + 1], ref_q[:k_ok + 1],
                               rtol=QUEUE_RTOL, atol=1e-12)
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               rtol=ENERGY_RTOL)
    if budgets is not None:         # the queues must bite on a starved fleet
        a = np_(got.a)
        assert a[:, 1:].sum(axis=0).max() < a[:, 0].sum()


def test_lyapunov_static_schedule_matches_reference():
    ref_p = ref_problem_mod.sample_problem(4, N, tau_th=0.5)
    got_p = port_problem(ref_p)
    ref = ref_sched.LyapunovScheduler(v=1e-4, n_rounds=7).precompute(ref_p)
    got = schedulers.LyapunovScheduler(v=1e-4, n_rounds=7).precompute(got_p)
    assert tuple(got.a.shape) == (N, 7)
    np.testing.assert_array_equal(np_(got.a), np.asarray(ref.a))


@pytest.mark.parametrize("per_round", [False, True])
def test_expected_participants_matches_reference(cell, per_round):
    a = np.asarray(cell["ref_control"].a)
    a = a if per_round else a[:, 0]
    ref_st = ref_sched.SchedulerState(a=jnp.asarray(a), power=jnp.asarray(a),
                                      agg_weights=jnp.ones(N))
    got = schedulers.ProbabilisticScheduler().expected_participants(
        port_state(ref_st))
    ref = ref_sched.ProbabilisticScheduler().expected_participants(ref_st)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_channel_aware_schedulers_are_registered():
    assert isinstance(schedulers.make_scheduler("greedy_channel", m=3),
                      schedulers.GreedyChannelScheduler)
    assert isinstance(schedulers.make_scheduler("lyapunov", v=0.5),
                      schedulers.LyapunovScheduler)
    assert set(schedulers.SCHEDULERS) == set(ref_sched.SCHEDULERS)
    for sch in (schedulers.GreedyChannelScheduler(),
                schedulers.LyapunovScheduler()):
        assert scan_engine._scheduler_mode(sch) == (scan_engine.MODE_FIXED, 0,
                                                    False)


# ---------------------------------------------------------- upload drops

@pytest.fixture(scope="module")
def drop_case(data):
    """A static 8-device problem, the probabilistic strategy at the
    reference's state, and the reference's masks for one config."""
    sizes = np.array([len(p) for p in data["parts"]])
    ref_p = ref_problem_mod.sample_problem(0, N, tau_th=0.5,
                                           dirichlet_sizes=sizes)
    ref_sch = ref_sched.ProbabilisticScheduler()
    state = ref_sch.precompute(ref_p)
    ref_cfg = ref_engine.FLConfig(n_rounds=6, eval_every=3, seed=0)
    cfg = engine.FLConfig(n_rounds=6, eval_every=3, seed=0)
    masks = ref_masks(ref_scan.plan_trajectory(ref_p, ref_sch, data["parts"],
                                               ref_cfg, state=state))
    return dict(ref_p=ref_p, prob=port_problem(ref_p), ref_sch=ref_sch,
                state=state, ref_cfg=ref_cfg, cfg=cfg, masks=masks)


def _port_run(case, data, drops=None, params=None):
    plan = scan_engine.plan_trajectory(
        case["prob"], schedulers.ProbabilisticScheduler(), data["parts"],
        case["cfg"], state=port_state(case["state"]), masks=case["masks"],
        drops=drops)
    params = scan_engine.init_sweep_params([case["cfg"]], device="cpu") \
        if params is None else params
    return plan, scan_engine.run_fl_sweep(
        scan_engine.stack_plans([plan]), data["train"], data["test"],
        case["cfg"], params, device="cpu")


def test_all_false_drop_table_is_no_table_bit_for_bit(drop_case, data):
    _, clean = _port_run(drop_case, data)
    plan, zeros = _port_run(drop_case, data, drops=np.zeros((6, N), bool))
    assert plan.drops is not None and not plan.drops.any()
    h0, hz = clean.histories[0], zeros.histories[0]
    for f in h0._fields:
        np.testing.assert_array_equal(getattr(hz, f), getattr(h0, f), err_msg=f)
    for a, b in zip(tree_leaves(clean.params), tree_leaves(zeros.params)):
        assert torch.equal(a, b)


def test_drops_match_reference_and_keep_energy_charged(drop_case, data,
                                                       sum_inputs):
    """Survivors are cut from eq. 4 and from ``participants``; the
    attempted uploads' time and energy stay charged."""
    c = drop_case
    drops = ref_faults.dropout_mask(3, 6, N, 0.6)
    np.testing.assert_array_equal(faults.dropout_mask(3, 6, N, 0.6), drops)
    ref_plan = ref_scan.plan_trajectory(c["ref_p"], c["ref_sch"], data["parts"],
                                        c["ref_cfg"], state=c["state"],
                                        drops=drops)
    ref_params = ref_scan.init_sweep_params([c["ref_cfg"]])
    ref = ref_scan.run_fl_sweep(ref_scan.stack_plans([ref_plan]),
                                data["ref_train"], data["ref_test"],
                                c["ref_cfg"], ref_params, shard=False)
    params = params_from_numpy(np_tree(ref_params), device="cpu")
    plan, got = _port_run(c, data, drops=drops, params=params)
    np.testing.assert_array_equal(np_(plan.drops), np.asarray(ref_plan.drops))
    np.testing.assert_array_equal(np_(plan.batch_idx), np.asarray(ref_plan.batch_idx))
    assert_sum_inputs(sum_inputs, [ref_plan], data["ref_train"])
    assert_history(ref.histories[0], got.histories[0])
    assert_end_point(ref.result(0).params, got.result(0).params, sum_inputs, 0)
    _, clean = _port_run(c, data, params=params)
    h0, hd = clean.histories[0], got.histories[0]
    np.testing.assert_array_equal(
        hd.participants, (c["masks"] & ~drops).sum(axis=1))
    assert hd.participants.sum() < h0.participants.sum()
    np.testing.assert_array_equal(hd.energy, h0.energy)
    np.testing.assert_array_equal(hd.sim_time, h0.sim_time)


def test_plans_refuse_mixed_or_misshapen_drop_tables(drop_case, data):
    c = drop_case
    kw = dict(state=port_state(c["state"]), masks=c["masks"])
    sch = schedulers.ProbabilisticScheduler()
    p1 = scan_engine.plan_trajectory(c["prob"], sch, data["parts"], c["cfg"], **kw)
    p2 = scan_engine.plan_trajectory(c["prob"], sch, data["parts"], c["cfg"],
                                     drops=np.zeros((6, N), bool), **kw)
    with pytest.raises(ValueError, match="drop"):
        scan_engine.stack_plans([p1, p2])
    with pytest.raises(ValueError, match="drops must be"):
        scan_engine.plan_trajectory(c["prob"], sch, data["parts"], c["cfg"],
                                    drops=np.zeros((5, N), bool), **kw)


# --------------------------------------------------------- control pass

def test_solve_rounds_matches_reference(cell):
    ref, got = cell["ref_control"], cell["control"]
    assert tuple(got.a.shape) == (N, K) and got.a.dtype == torch.float32
    np.testing.assert_allclose(np_(got.a), ref.a, atol=SOLVE_TOL, rtol=SOLVE_TOL)
    np.testing.assert_allclose(np_(got.power), ref.power, atol=SOLVE_TOL,
                               rtol=SOLVE_TOL)
    assert got.n_rounds == ref.n_rounds == K
    assert (got.warm_rounds, got.inner_iters, got.outer_iters) == (
        ref.warm_rounds, ref.inner_iters, ref.outer_iters)
    assert got.warm_rounds == K - 1
    assert got.service.stats.n_solved == K


def test_solve_rounds_rejects_static_problem():
    static = make_problem("paper_static", seed=0, n_devices=N, device="cpu")
    with pytest.raises(ValueError, match="fading"):
        cl.solve_rounds(static, FleetControlService(device="cpu"))


def _crashing_service(after: int) -> FleetControlService:
    svc = FleetControlService(ServiceConfig(), device="cpu")
    run, calls = svc.run, [0]

    def crashy(reqs=None):
        if calls[0] >= after:
            raise RuntimeError("simulated crash")
        calls[0] += 1
        return run(reqs)
    svc.run = crashy
    return svc


def test_resume_equals_the_uninterrupted_run_bit_for_bit(cell, tmp_path):
    with pytest.raises(RuntimeError, match="simulated crash"):
        cl.solve_rounds(cell["prob"], _crashing_service(2),
                        checkpoint_dir=str(tmp_path))
    svc = FleetControlService(ServiceConfig(), device="cpu")
    res = cl.solve_rounds(cell["prob"], svc, checkpoint_dir=str(tmp_path))
    ref = cell["control"]
    assert torch.equal(res.a, ref.a) and torch.equal(res.power, ref.power)
    assert (res.warm_rounds, res.inner_iters, res.outer_iters) == (
        ref.warm_rounds, ref.inner_iters, ref.outer_iters)
    assert svc.stats.n_solved == K - 2
    assert svc.stats.n_warm == K - 2        # round 2 warm from the seed


def test_completed_checkpoint_solves_nothing(cell, tmp_path):
    first = cl.solve_rounds(cell["prob"],
                            FleetControlService(ServiceConfig(), device="cpu"),
                            checkpoint_dir=str(tmp_path))
    svc = FleetControlService(ServiceConfig(), device="cpu")
    again = cl.solve_rounds(cell["prob"], svc, checkpoint_dir=str(tmp_path))
    assert torch.equal(first.a, again.a) and torch.equal(first.power, again.power)
    assert svc.stats.n_solved == 0


def test_reference_checkpoint_resumes_in_the_port(cell, tmp_path):
    """The reference crashes after two rounds; the port restores its
    columns and solves the rest warm from its last answer."""
    svc = ref_fs.FleetControlService(ref_fs.ServiceConfig())
    run, calls = svc.run, [0]

    def crashy(reqs=None):
        if calls[0] >= 2:
            raise RuntimeError("simulated crash")
        calls[0] += 1
        return run(reqs)
    svc.run = crashy
    with pytest.raises(RuntimeError, match="simulated crash"):
        ref_cl.solve_rounds(cell["ref_prob"], svc, checkpoint_dir=str(tmp_path))
    got = cl.solve_rounds(cell["prob"],
                          FleetControlService(ServiceConfig(), device="cpu"),
                          checkpoint_dir=str(tmp_path))
    ref = cell["ref_control"]
    np.testing.assert_array_equal(np_(got.a)[:, :2], ref.a[:, :2])
    np.testing.assert_allclose(np_(got.a), ref.a, atol=SOLVE_TOL, rtol=SOLVE_TOL)
    np.testing.assert_allclose(np_(got.power), ref.power, atol=SOLVE_TOL,
                               rtol=SOLVE_TOL)
    assert (got.warm_rounds, got.inner_iters, got.outer_iters) == (
        ref.warm_rounds, ref.inner_iters, ref.outer_iters)


# ------------------------------------------------------------ strategies

def _ref_trace_in_port(ref_control):
    return cl.ControlTrace(a=torch.from_numpy(np.array(ref_control.a)),
                           power=torch.from_numpy(np.array(ref_control.power)),
                           warm_rounds=ref_control.warm_rounds,
                           inner_iters=ref_control.inner_iters,
                           outer_iters=ref_control.outer_iters,
                           solve_seconds=0.0, service=None)


@pytest.mark.parametrize("name", cl.CLOSED_LOOP_STRATEGIES)
def test_strategy_state_matches_reference(cell, name):
    """Both packages' strategies over the reference's control trace."""
    ref_cfg = ref_cl.ClosedLoopConfig(n_devices=N, n_rounds=K)
    cfg = cl.ClosedLoopConfig(n_devices=N, n_rounds=K)
    ref_sch, ref = ref_cl.strategy_state(name, cell["ref_prob"],
                                         cell["ref_control"], ref_cfg)
    sch, got = cl.strategy_state(name, cell["prob"],
                                 _ref_trace_in_port(cell["ref_control"]), cfg)
    assert type(sch).__name__ == type(ref_sch).__name__
    assert scan_engine._scheduler_mode(sch) == ref_scan._scheduler_mode(ref_sch)
    if name in ("probabilistic", "joint_bits"):
        np.testing.assert_allclose(np_(got.a), np.asarray(ref.a),
                                   atol=SOLVE_TOL, rtol=SOLVE_TOL)
    elif name == "lyapunov":
        e = np.asarray(cell["ref_prob"].round_energy(ref.power))
        q = np.asarray(ref_sch.queue_trajectory(cell["ref_prob"]))[:-1].T
        vw = np.float32(ref_cfg.lyapunov_v) * np.asarray(cell["ref_prob"].weights)
        assert_selections(ref.a, got.a, np.abs(vw[:, None] - q * e),
                          np.maximum(vw[:, None], q * e))
    elif name == "greedy_channel":
        gain = np.asarray(cell["ref_prob"].path_gain())
        mth = -np.sort(-gain, axis=0)[ref_sch.m - 1]
        assert_selections(ref.a, got.a, np.abs(gain - mth),
                          np.maximum(gain, mth))
    else:
        np.testing.assert_array_equal(np_(got.a), np.asarray(ref.a))
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               atol=SOLVE_TOL, rtol=SOLVE_TOL)
    np.testing.assert_allclose(np_(got.agg_weights), np.asarray(ref.agg_weights),
                               rtol=1e-6)


def test_joint_bits_state_matches_reference(cell):
    cfg = cl.ClosedLoopConfig(n_devices=N, n_rounds=K)
    _, ref, ref_bits = ref_cl.joint_bits_state(
        cell["ref_prob"], ref_cl.ClosedLoopConfig(n_devices=N, n_rounds=K))
    _, got, bits = cl.joint_bits_state(cell["prob"], cfg)
    np.testing.assert_array_equal(np_(bits), ref_bits)
    assert bits.dtype == torch.float32 and tuple(bits.shape) == (N, K)
    np.testing.assert_allclose(np_(got.a), np.asarray(ref.a), atol=SOLVE_TOL,
                               rtol=SOLVE_TOL)
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               atol=SOLVE_TOL, rtol=SOLVE_TOL)


def test_unknown_strategy_raises(cell):
    with pytest.raises(KeyError, match="strategy"):
        cl.strategy_state("oracle", cell["prob"], cell["control"],
                          cl.ClosedLoopConfig(n_devices=N, n_rounds=K))


# ------------------------------------------------------------------ grid

FIXED = ("deterministic", "greedy_channel", "lyapunov")
SAMPLED = ("probabilistic", "uniform", "joint_bits")


@pytest.mark.parametrize("faulted", [False, True])
def test_fixed_mode_grid_rows_match_reference(faulted, tmp_path):
    fp = dict(fault_plan=ref_faults.FaultPlan(**FAULTS),
              checkpoint_dir=str(tmp_path / "ref")) if faulted else {}
    ref = ref_cl.run_closed_loop_grid(ref_cl.ClosedLoopConfig(**CFG, **fp),
                                      strategies=FIXED, shard=False)
    fp = dict(fault_plan=faults.FaultPlan(**FAULTS),
              checkpoint_dir=str(tmp_path / "port")) if faulted else {}
    got = cl.run_closed_loop_grid(cl.ClosedLoopConfig(**CFG, **fp),
                                  strategies=FIXED, device="cpu")
    for key in ("warm_rounds", "n_rounds", "inner_iters", "outer_iters"):
        assert got["control"][key] == ref["control"][key], key
    assert got["control"]["service"]["unhealthy_devices"] == \
        ref["control"]["service"]["unhealthy_devices"]
    if faulted:
        assert got["faults"]["n_unhealthy_devices"] == \
            ref["faults"]["n_unhealthy_devices"] > 0
    assert list(got["strategies"]) == list(FIXED)
    for name in FIXED:
        r, g = ref["strategies"][name], got["strategies"][name]
        assert g["mean_participants"] == r["mean_participants"], name
        assert g["mean_bits"] == r["mean_bits"] == 32.0
        for key in ("expected_participants", "total_energy_j",
                    "completion_time_s"):
            np.testing.assert_allclose(g[key], r[key], rtol=ROW_RTOL,
                                       err_msg=f"{name} {key}")
        assert np.isfinite(list(g.values())).all()
    assert set(got["seconds"]) == {"control", "planning", "sweep",
                                   "quantized_sweep"}


def _sampled_plans(cell, data, drops_for):
    """Both packages' plans for the sampled strategies, as the grid
    composes them, over the reference's control trace; the port's with
    the reference's masks."""
    ref_cfgc = ref_cl.ClosedLoopConfig(**CFG)
    cfgc = cl.ClosedLoopConfig(**CFG)
    trace = _ref_trace_in_port(cell["ref_control"])
    groups = {False: ([], [], [], [], []), True: ([], [], [], [], [])}
    n_plans = 0
    for name in SAMPLED:
        quantized = name in cl.QUANTIZED_STRATEGIES
        if quantized:
            ref_sch, ref_st, ref_bits = ref_cl.joint_bits_state(cell["ref_prob"],
                                                                ref_cfgc)
            sch, st, bits = cl.joint_bits_state(cell["prob"], cfgc)
            ref_p = dataclasses.replace(cell["ref_prob"],
                                        bits=jnp.asarray(ref_bits))
            prob = dataclasses.replace(cell["prob"], bits=bits)
            bits_kw = dict(bits=ref_bits)
        else:
            ref_sch, ref_st = ref_cl.strategy_state(name, cell["ref_prob"],
                                                    cell["ref_control"], ref_cfgc)
            sch, st = cl.strategy_state(name, cell["prob"], trace, cfgc)
            ref_p, prob, bits_kw = cell["ref_prob"], cell["prob"], {}
        for run in range(CFG["n_seeds"]):
            ref_cfg = ref_cl._fl_config(ref_cfgc, run)
            cfg = cl._fl_config(cfgc, run)
            if quantized:
                ref_cfg = dataclasses.replace(ref_cfg, aggregate="stacked")
                cfg = dataclasses.replace(cfg, aggregate="stacked")
            drops = drops_for(n_plans)
            n_plans += 1
            ref_plan = ref_scan.plan_trajectory(ref_p, ref_sch, data["parts"],
                                                ref_cfg, state=ref_st,
                                                drops=drops, **bits_kw)
            plan = scan_engine.plan_trajectory(
                prob, sch, data["parts"], cfg, state=port_state(ref_st),
                masks=ref_masks(ref_plan), drops=drops, **bits_kw)
            for lst, x in zip(groups[quantized],
                              (ref_plan, plan, ref_cfg, cfg, name)):
                lst.append(x)
    return groups


@pytest.mark.parametrize("faulted", [False, True])
def test_sampled_strategies_match_reference(cell, data, faulted, sum_inputs):
    """probabilistic, uniform and joint_bits at the plan and sweep level,
    with the reference's masks, quantiser noise and initial parameters."""
    plan_f = faults.FaultPlan(**FAULTS)
    groups = _sampled_plans(cell, data, lambda j: faults.dropout_mask(
        plan_f.seed + 31 * j, K, N, plan_f.drop_rate) if faulted else None)
    for quantized, (ref_plans, plans, ref_cfgs, cfgs, names) in groups.items():
        for rp, p in zip(ref_plans, plans):
            for f in ("probs", "tx_time", "round_energy"):
                np.testing.assert_allclose(np_(getattr(p, f)),
                                           np.asarray(getattr(rp, f)),
                                           rtol=ENERGY_RTOL, err_msg=f)
            np.testing.assert_array_equal(np_(p.batch_idx), np.asarray(rp.batch_idx))
            if faulted:
                np.testing.assert_array_equal(np_(p.drops), np.asarray(rp.drops))
            if quantized:
                np.testing.assert_array_equal(np_(p.bits), np.asarray(rp.bits))
        ref_params = ref_scan.init_sweep_params(ref_cfgs)
        del sum_inputs[:]
        ref = ref_scan.run_fl_sweep(ref_scan.stack_plans(ref_plans),
                                    data["ref_train"], data["ref_test"],
                                    ref_cfgs[0], ref_params, shard=False)
        noise = stack_noise([ref_round_noise(c.seed, K, N) for c in cfgs]) \
            if quantized else None
        got = scan_engine.run_fl_sweep(
            scan_engine.stack_plans(plans), data["train"], data["test"], cfgs[0],
            params_from_numpy(np_tree(ref_params), device="cpu"), noise=noise,
            device="cpu")
        assert_sum_inputs(sum_inputs, ref_plans, data["ref_train"])
        # one quantiser level per round at most: lr * max scale, with
        # |g| under 10 for this CNN, at the menu's narrowest width
        level = K * cfgs[0].lr * 10.0 / float(ref_engine.quantize_levels(
            min(cl.ClosedLoopConfig().bit_menu))) if quantized else None
        for t, name in enumerate(names):
            assert_history(ref.histories[t], got.histories[t])
            assert_end_point(ref.result(t).params, got.result(t).params,
                             sum_inputs, t, level)
        if faulted:
            assert any((h.participants < np.asarray(rp.drops).shape[1]).any()
                       for h, rp in zip(got.histories, ref_plans))


def test_grid_runs_every_strategy_and_formats(tmp_path):
    cfg = cl.ClosedLoopConfig(**dict(CFG, n_seeds=1),
                              fault_plan=faults.FaultPlan(**FAULTS),
                              checkpoint_dir=str(tmp_path))
    out = cl.run_closed_loop_grid(cfg, device="cpu")
    assert list(out["strategies"]) == list(cl.CLOSED_LOOP_STRATEGIES)
    for name, row in out["strategies"].items():
        assert np.isfinite(list(row.values())).all(), name
    assert out["strategies"]["joint_bits"]["mean_bits"] < 32.0
    assert out["faults"]["n_unhealthy_devices"] > 0
    assert out["control"]["service"]["unhealthy_devices"] > 0
    assert out["config"]["service"] == dataclasses.asdict(ServiceConfig())
    table = cl.format_closed_loop_table(out).splitlines()
    assert len(table) == 2 + len(cl.CLOSED_LOOP_STRATEGIES)
    assert table[0].startswith("closed loop on drifting_metro (N=8, K=5)")


# --------------------------------------------------------------- drivers

DRIVERS = {
    "closed_loop_demo": (closed_loop_demo,
                         ["--devices", "8", "--rounds", "3", "--train", "128"]),
    "quickstart": (quickstart, ["--devices", "8", "--rounds", "3",
                                "--train", "128", "--test", "32"]),
    "fading_rounds": (fading_rounds, ["--devices", "16", "--rounds", "6"]),
    "compression_study": (compression_study,
                          ["--devices", "8", "--rounds", "2", "--eval-every", "1",
                           "--train", "128", "--test", "32"]),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_drivers_run_on_the_cpu(name, tmp_path, capsys):
    mod, argv = DRIVERS[name]
    if name == "compression_study":
        argv = argv + ["--out", str(tmp_path / "study.json")]
    out = mod.main(["--device", "cpu"] + argv)
    text = capsys.readouterr().out
    assert "[cpu]" in text
    if name == "closed_loop_demo":
        assert list(out["strategies"]) == list(cl.CLOSED_LOOP_STRATEGIES)
    elif name == "quickstart":
        assert out["history"].rounds.shape == (3,)
    elif name == "fading_rounds":
        assert out["feasible"] and out["corr"] > 0.1
    else:
        assert sorted(out) == [4, 8, 32]
        assert (tmp_path / "study.json").exists()


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_drivers_refuse_to_run_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mod, argv = DRIVERS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
