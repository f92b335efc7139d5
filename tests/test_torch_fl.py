"""Parity of the port's model and FL engines with the JAX reference.

Both packages run the same inputs in one process: the datasets and
partitions from one numpy seed, the reference's initial parameters (as
numpy) and the reference's participation masks (``jax.random`` streams
cannot be reproduced in torch, so the masks are passed in).  Where the
plans need a solved state, the reference's state is passed in too, so
both engines account at the same powers.  Tolerances:

* the CNN at rtol 1e-5 / atol 1e-6: float32 products summed in another
  order by XLA and by torch;
* time and energy at rtol 1e-6 (a few float32 ulps of the tx-time
  tables, summed in float64), participants exactly;
* parameters after a few rounds at rtol/atol 1e-5, the reference's own
  scan-vs-loop tolerance (``tests/test_fl_scan.py``);
* accuracy at atol 0.02 (about one test image in 60 may flip on a tie).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedulers as ref_sched
from repro.core.problem import sample_problem as ref_sample_problem
from repro.data.partition import dirichlet_partition as ref_partition
from repro.data.synthetic import make_mnist_like as ref_make_mnist_like
from repro.fl import engine as ref_engine
from repro.fl import scan_engine as ref_scan
from repro.kernels.selection_solve.ops import (
    solve_joint_fused_kernel as ref_fused_kernel)
from repro.models import cnn as ref_cnn
from repro_torch.convert import params_from_numpy, params_to_numpy, problem_from_numpy
from repro_torch.core import schedulers
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.fl import engine, experiments, scan_engine
from repro_torch.kernels.selection_solve.ops import solve_joint_fused_kernel
from repro_torch.models import cnn
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N_DEV = 8
TIME_RTOL = 1e-6
PARAM_TOL = 1e-5
ACC_ATOL = 0.02
CNN_TOL = dict(rtol=1e-5, atol=1e-6)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    ref_train, ref_test = ref_make_mnist_like(240, 60, seed=0)
    train, test = make_mnist_like(240, 60, seed=0)
    parts = ref_partition(ref_train, N_DEV, beta=0.3, seed=1)
    sizes = np.array([len(p) for p in parts])
    ref_prob = ref_sample_problem(0, N_DEV, tau_th=0.5, dirichlet_sizes=sizes)
    fields = {f: getattr(ref_prob, f) for f in ref_prob.__dataclass_fields__}
    prob = problem_from_numpy({k: np.asarray(v) if hasattr(v, "shape") else v
                               for k, v in fields.items()}, device="cpu")
    return dict(ref_train=ref_train, ref_test=ref_test, train=train,
                test=test, parts=parts, ref_prob=ref_prob, prob=prob)


def port_state(ref_state):
    return schedulers.SchedulerState(*(torch.from_numpy(np.array(x))
                                       for x in ref_state))


@dataclasses.dataclass(frozen=True)
class GivenState(schedulers.ProbabilisticScheduler):
    """The probabilistic strategy planning with a state solved elsewhere."""

    given: object = None

    def precompute(self, problem):
        return self.given


def ref_masks(ref_prob, ref_sch, parts, cfg, state=None):
    """The reference's participation draws for ``cfg.seed``, [K, N]."""
    plan = ref_scan.plan_trajectory(ref_prob, ref_sch, parts, cfg, state=state)
    return np.asarray(ref_scan._mask_stream(plan.key, plan.probs, plan.mode,
                                            plan.m))


def assert_histories(ref, got):
    np.testing.assert_array_equal(got.rounds, ref.rounds)
    np.testing.assert_allclose(got.sim_time, ref.sim_time, rtol=TIME_RTOL)
    np.testing.assert_allclose(got.energy, ref.energy, rtol=TIME_RTOL)
    np.testing.assert_array_equal(got.participants, ref.participants)
    np.testing.assert_array_equal(got.eval_rounds, ref.eval_rounds)
    np.testing.assert_allclose(got.eval_time, ref.eval_time, rtol=TIME_RTOL)
    np.testing.assert_allclose(got.eval_acc, ref.eval_acc, atol=ACC_ATOL)


def assert_params(ref, got):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = tree_leaves(params_to_numpy(got))
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        np.testing.assert_allclose(g, np.asarray(r), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)


# ------------------------------------------------------------------ CNN

def test_cnn_layout_and_parameter_count():
    ref = ref_cnn.init(jax.random.PRNGKey(0))
    got = cnn.init(torch.Generator().manual_seed(0), device="cpu")
    assert cnn.n_params(got) == ref_cnn.n_params(ref) == 199_213
    assert set(got) == set(ref)
    for layer in ref:
        for name in ref[layer]:
            assert tuple(got[layer][name].shape) == ref[layer][name].shape
            assert got[layer][name].dtype == torch.float32


def test_cnn_forward_and_gradients_match_reference():
    ref_params = np_tree(ref_cnn.init(jax.random.PRNGKey(3)))
    params = params_from_numpy(ref_params, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (6, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    weights = rng.uniform(0, 1, 6).astype(np.float32)
    x, y, w = (torch.from_numpy(v) for v in (images, labels, weights))
    ref_logits = np.asarray(jax.jit(ref_cnn.apply)(ref_params, jnp.asarray(images)))
    np.testing.assert_allclose(cnn.apply(params, x).numpy(), ref_logits,
                               **CNN_TOL)
    ref_grad = jax.jit(jax.grad(ref_cnn.loss_fn))
    for sw, ref_sw in ((None, None), (w, jnp.asarray(weights))):
        ref_g = ref_grad(ref_params, jnp.asarray(images), jnp.asarray(labels),
                         ref_sw)
        got_g = torch.func.grad(cnn.loss_fn)(params, x, y, sw)
        for r, g in zip(jax.tree_util.tree_leaves(ref_g), tree_leaves(got_g)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **CNN_TOL)
    assert cnn.accuracy(params, x, y, batch=4) == pytest.approx(
        float(np.mean(ref_logits.argmax(-1) == labels)))


# --------------------------------------------------------------- run_fl

@pytest.mark.parametrize("aggregate", ["fused", "stacked"])
def test_run_fl_matches_reference(setup, aggregate):
    s = setup
    kw = dict(n_rounds=3, eval_every=1, batch_per_client=4,
              aggregate=aggregate, seed=11)
    ref_cfg, cfg = ref_engine.FLConfig(**kw), engine.FLConfig(**kw)
    ref_sch = ref_sched.ProbabilisticScheduler()
    ref_state = ref_sch.precompute(s["ref_prob"])
    ref_params = np_tree(ref_cnn.init(jax.random.PRNGKey(5)))
    ref = ref_engine.run_fl(s["ref_prob"], ref_sch, s["ref_train"], s["parts"],
                            s["ref_test"], ref_cfg, init_params=ref_params)
    masks = ref_masks(s["ref_prob"], ref_sch, s["parts"], ref_cfg)
    assert masks.any(), "the case must train"
    got = engine.run_fl(
        s["prob"], GivenState(given=port_state(ref_state)), s["train"],
        s["parts"], s["test"], cfg,
        init_params=params_from_numpy(ref_params, device="cpu"),
        masks=masks, device="cpu")
    assert_histories(ref.history, got.history)
    assert_params(ref.params, got.params)


# ------------------------------------------------------- sweep / slice

def test_sweep_slice_matches_reference(setup):
    """The slice's configuration: the fused-kernel solve's state for the
    probabilistic and uniform strategies, the stacked eq.-4 sum through
    the masked_aggregate wrapper, four strategies in one sweep."""
    s = setup
    ref_k = ref_fused_kernel(s["ref_prob"], interpret=True)
    got_k = solve_joint_fused_kernel(s["prob"])
    np.testing.assert_allclose(got_k.a.numpy(), np.asarray(ref_k.a), atol=1e-5)
    np.testing.assert_allclose(got_k.power.numpy(), np.asarray(ref_k.power),
                               atol=1e-5, rtol=1e-5)
    alpha = ref_sched._data_weights(s["ref_prob"])
    kernel_state = ref_sched.SchedulerState(a=ref_k.a, power=ref_k.power,
                                            agg_weights=alpha)
    m = max(1, int(round(float(np.asarray(ref_k.a).sum()))))
    strategies = [
        (ref_sched.ProbabilisticScheduler(), schedulers.ProbabilisticScheduler(),
         kernel_state),
        (ref_sched.DeterministicScheduler(), schedulers.DeterministicScheduler(),
         None),
        (ref_sched.UniformScheduler(m=m), schedulers.UniformScheduler(m=m), None),
        (ref_sched.EquallyWeightedScheduler(),
         schedulers.EquallyWeightedScheduler(), None),
    ]
    kw = dict(n_rounds=3, eval_every=2, batch_per_client=4, aggregate="stacked")
    ref_plans, plans, ref_cfgs, cfgs = [], [], [], []
    for j, (ref_sch, sch, state) in enumerate(strategies):
        ref_cfg = ref_engine.FLConfig(**kw, seed=3 + j)
        cfg = engine.FLConfig(**kw, seed=3 + j)
        state = ref_sch.precompute(s["ref_prob"]) if state is None else state
        ref_plans.append(ref_scan.plan_trajectory(s["ref_prob"], ref_sch,
                                                  s["parts"], ref_cfg,
                                                  state=state))
        plans.append(scan_engine.plan_trajectory(
            s["prob"], sch, s["parts"], cfg, state=port_state(state),
            masks=ref_masks(s["ref_prob"], ref_sch, s["parts"], ref_cfg,
                            state=state)))
        ref_cfgs.append(ref_cfg)
        cfgs.append(cfg)
    ref_params = ref_scan.init_sweep_params(ref_cfgs)
    ref = ref_scan.run_fl_sweep(ref_scan.stack_plans(ref_plans),
                                s["ref_train"], s["ref_test"], ref_cfgs[0],
                                ref_params, shard=False)
    got = scan_engine.run_fl_sweep(
        scan_engine.stack_plans(plans), s["train"], s["test"], cfgs[0],
        params_from_numpy(np_tree(ref_params), device="cpu"), device="cpu")
    for t in range(len(strategies)):
        assert_histories(ref.histories[t], got.histories[t])
        assert_params(ref.result(t).params, got.result(t).params)
    assert sum(int(h.participants.sum()) for h in got.histories) > 0


@pytest.mark.parametrize("aggregate", ["fused", "stacked"])
def test_port_sweep_reproduces_port_loop(setup, aggregate):
    """Without given masks both engines draw from ``config.seed``'s
    generator in the same order, so they agree with each other."""
    s = setup
    cfg = engine.FLConfig(n_rounds=4, eval_every=2, batch_per_client=4,
                          aggregate=aggregate, seed=2)
    for sch in (schedulers.ProbabilisticScheduler(solver="fused"),
                schedulers.UniformScheduler(m=3)):
        loop = engine.run_fl(s["prob"], sch, s["train"], s["parts"], s["test"],
                             cfg, device="cpu")
        sweep = scan_engine.run_fl_scan(s["prob"], sch, s["train"], s["parts"],
                                        s["test"], cfg, device="cpu")
        np.testing.assert_array_equal(sweep.history.participants,
                                      loop.history.participants)
        np.testing.assert_allclose(sweep.history.sim_time, loop.history.sim_time,
                                   rtol=TIME_RTOL)
        for r, g in zip(tree_leaves(loop.params), tree_leaves(sweep.params)):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=PARAM_TOL,
                                       atol=PARAM_TOL)


def test_plan_and_sweep_reject_bad_arguments(setup):
    s = setup
    cfg = engine.FLConfig(n_rounds=2, eval_every=1, batch_per_client=2)
    sch = schedulers.UniformScheduler(m=2)
    with pytest.raises(ValueError, match="aggregate"):
        engine.run_fl(s["prob"], sch, s["train"], s["parts"], s["test"],
                      dataclasses.replace(cfg, aggregate="tree"), device="cpu")
    plan = scan_engine.plan_trajectory(s["prob"], sch, s["parts"], cfg)
    with pytest.raises(ValueError, match="aggregate"):
        scan_engine.run_fl_sweep(scan_engine.stack_plans([plan]), s["train"],
                                 s["test"], dataclasses.replace(cfg, aggregate="tree"),
                                 scan_engine.init_sweep_params([cfg], "cpu"),
                                 device="cpu")
    with pytest.raises(ValueError, match="masks"):
        scan_engine.plan_trajectory(s["prob"], sch, s["parts"], cfg,
                                    masks=np.zeros((3, N_DEV), bool))


# ---------------------------------------------------------- experiments

def test_run_grid_kernel_configuration_scan_matches_loop():
    """The slice's grid at a tiny size: both scenarios, four strategies,
    the kernel solve and the kernel aggregate (their plain versions on the
    CPU); the sweep and the loop engine give the same tables."""
    specs = [dataclasses.replace(
        spec, n_devices=6, n_train=120, n_test=40, n_rounds=3, eval_every=1,
        n_runs=2, solver="fused_kernel")
        for spec in (experiments.HIGH_BIAS, experiments.MILD_BIAS)]
    kw = dict(verbose=False, device="cpu")
    scan = experiments.run_grid(specs, engine="scan", **kw)
    loop = experiments.run_grid(specs, engine="loop", **kw)
    for spec in specs:
        assert list(scan[spec.name]["strategies"]) == list(experiments.STRATEGIES)
        for strat, res in scan[spec.name]["strategies"].items():
            ref = loop[spec.name]["strategies"][strat]
            assert res["mean_participants"] == ref["mean_participants"]
            assert res["total_time_s"] == pytest.approx(ref["total_time_s"],
                                                        rel=TIME_RTOL)
            assert res["total_energy_j"] == pytest.approx(
                ref["total_energy_j"], rel=TIME_RTOL)
            assert res["final_acc"] == pytest.approx(ref["final_acc"],
                                                     abs=ACC_ATOL)
        table = experiments.format_tables(scan[spec.name], spec)
        assert all(s in table for s in experiments.STRATEGIES)


@pytest.mark.parametrize("solver", ["fused_kernel", "kernel"])
def test_kernel_solvers_give_the_plans_their_state(solver):
    """A kernel solver is the experiments' choice, not the scheduler's: the
    probabilistic plan carries the drop-in solve's a*, the uniform plan
    its rounded participant count, and ``ProbabilisticScheduler`` keeps
    the reference's solver names."""
    spec = dataclasses.replace(experiments.MILD_BIAS, n_devices=6, n_train=120,
                               n_test=40, n_rounds=2, eval_every=1, n_runs=1,
                               solver=solver)
    plans, labels, *_ = experiments.build_scenario_plans(
        spec, strategies=("probabilistic", "uniform"), device="cpu")
    problem = experiments.make_problem_and_data(spec, 0, "cpu")[0]
    sol = experiments.KERNEL_SOLVERS[solver](problem)
    assert labels == ["probabilistic", "uniform"]
    torch.testing.assert_close(plans[0].probs, sol.a.expand_as(plans[0].probs),
                               rtol=0, atol=0)
    m = max(1, int(round(float(sol.a.sum()))))
    assert (plans[1].masks.sum(dim=1) == m).all()
    with pytest.raises(ValueError, match="unknown solver"):
        schedulers.ProbabilisticScheduler(solver=solver).solve(problem)
