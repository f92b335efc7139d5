"""Parity of the port's quantised-uplink slice with the JAX reference.

The bit-allocation step (``bit_menu`` / ``select_best_bits``), the
stochastic-rounding quantisers, the quantised eq.-4 sum (its plain
version here: the wrappers pick it for CPU tensors) and the engines'
``uplink_bits`` / ``bits``-table paths, on inputs made from numpy seeds.
``jax.random`` streams cannot be reproduced in torch, so the reference's
participation masks and quantiser noise are rebuilt from its key stream
(per round ``split``, then ``fold_in(sub, 1)``, then a split over the
leaves and one over the clients) and passed in.  Tolerances:

* quantiser and quantised sum on identical inputs: rtol/atol 1e-5, the
  reference's kernel-vs-oracle tolerance (the sum adds clients in
  another order);
* a width that is not a whole number: the level count comes from
  ``pow`` in torch and from ``exp2`` in XLA, which may differ by an ulp,
  so the levels are compared at rtol 1e-6 and the quantiser at 1e-5;
* the bit-menu solve: a* and P* at 1e-5 (the reference's solver
  tolerance), widths exactly;
* whole training runs: the port's gradients differ from XLA's by float
  rounding, and stochastic rounding is discontinuous at every level, so
  an element may round one level apart.  All but ``FLIP_SHARE`` of the
  parameters agree at 1e-5, and every parameter within one level per
  round (lr * max coef * max scale, summed over the rounds);
* the port's sweep against the port's loop: the same noise stream and
  the same arithmetic, so at the unquantised tolerance, 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alternating as ref_alt
from repro.core import schedulers as ref_sched
from repro.core.problem import sample_problem as ref_sample_problem
from repro.core.scenarios import make_problem as ref_make_problem
from repro.data.partition import dirichlet_partition as ref_partition
from repro.data.synthetic import make_mnist_like as ref_make_mnist_like
from repro.fl import engine as ref_engine
from repro.fl import scan_engine as ref_scan
from repro.kernels.masked_aggregate import ops as ref_agg_ops
from repro.kernels.masked_aggregate import ref as ref_agg_ref
from repro.models import cnn as ref_cnn
from repro_torch.convert import params_from_numpy, params_to_numpy, problem_from_numpy
from repro_torch.core import alternating, schedulers, select_best_bits
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.fl import engine, scan_engine
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.masked_aggregate import ops as agg_ops
from repro_torch.kernels.masked_aggregate import ref as agg_ref
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

N_DEV = 8
MENU = (8, 16, 32)
Q_TOL = dict(rtol=1e-5, atol=1e-5)
SOLVE_TOL = 1e-5
TIME_RTOL = 1e-6
PARAM_TOL = 1e-5
FLIP_SHARE = 1e-3
ACC_ATOL = 0.02
# 2^(b-1) - 1 rounds to 127 - 4.6e-5 in float32 at this width
NOT_WHOLE = 7.9999995
CNN_SHAPES = {"conv1": {"w": (3, 3, 1, 8), "b": (8,)},
              "conv2": {"w": (3, 3, 8, 16), "b": (16,)},
              "fc1": {"w": (784, 249), "b": (249,)},
              "fc2": {"w": (249, 10), "b": (10,)}}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_problem(ref):
    fields = {f: getattr(ref, f) for f in ref.__dataclass_fields__}
    return problem_from_numpy({k: np.asarray(v) if hasattr(v, "shape") else v
                               for k, v in fields.items()}, device="cpu")


def ref_noise_tree(key, shapes, n):
    """The reference's quantiser noise for one round: split over the
    leaves (sorted keys), then over the clients, uniform per client."""
    leaves, treedef = jax.tree_util.tree_flatten(
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    keys = jax.random.split(key, len(leaves))
    out = [np.array(jax.vmap(lambda kk, s=s: jax.random.uniform(kk, s))(
        jax.random.split(k, n))) for s, k in zip(leaves, keys)]
    return jax.tree_util.tree_unflatten(treedef, out)


def ref_round_noise(seed, n_rounds, n, shapes=CNN_SHAPES):
    """``run_fl``'s per-round quantiser noise for ``seed``: [K] trees of
    [N, ...] arrays."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_rounds):
        key, sub = jax.random.split(key)
        out.append(ref_noise_tree(jax.random.fold_in(sub, 1), shapes, n))
    return out


def stack_noise(per_traj):
    """[T] lists of per-round trees -> per-round trees of [T, N, ...]."""
    return [jax.tree_util.tree_map(lambda *xs: np.stack(xs), *rounds)
            for rounds in zip(*per_traj)]


def ref_masks(ref_prob, ref_sch, parts, cfg, state=None):
    plan = ref_scan.plan_trajectory(ref_prob, ref_sch, parts, cfg, state=state)
    return np.asarray(ref_scan._mask_stream(plan.key, plan.probs, plan.mode,
                                            plan.m))


@dataclasses.dataclass(frozen=True)
class GivenState(schedulers.ProbabilisticScheduler):
    """The probabilistic strategy planning with a state solved elsewhere."""

    given: object = None

    def precompute(self, problem):
        return self.given


def port_state(ref_state):
    return schedulers.SchedulerState(*(torch.from_numpy(np.array(x))
                                       for x in ref_state))


def assert_params_within_levels(ref, got, level_bound):
    """All but FLIP_SHARE of the parameters at PARAM_TOL, and each within
    ``level_bound`` (one quantiser level per round) of the reference."""
    r = np.concatenate([np.asarray(x).ravel()
                        for x in jax.tree_util.tree_leaves(ref)])
    g = np.concatenate([x.ravel() for x in tree_leaves(params_to_numpy(got))])
    off = np.abs(g - r) > PARAM_TOL + PARAM_TOL * np.abs(r)
    assert off.mean() <= FLIP_SHARE, f"{off.sum()} of {off.size} parameters"
    assert np.abs(g - r).max() <= PARAM_TOL + level_bound


def level_bound(cfg, n_rounds, bits):
    """lr * max coef * max scale over the rounds: renormalised coef is at
    most 1, and a scale is max|g| / L with |g| under 10 for this CNN."""
    return n_rounds * cfg.lr * 10.0 / float(ref_engine.quantize_levels(bits))


def assert_histories(ref, got):
    np.testing.assert_array_equal(got.rounds, ref.rounds)
    np.testing.assert_allclose(got.sim_time, ref.sim_time, rtol=TIME_RTOL)
    np.testing.assert_allclose(got.energy, ref.energy, rtol=TIME_RTOL)
    np.testing.assert_array_equal(got.participants, ref.participants)
    np.testing.assert_allclose(got.eval_acc, ref.eval_acc, atol=ACC_ATOL)


# -------------------------------------------------------------- quantisers

@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32, NOT_WHOLE])
def test_quantizers_match_reference(bits):
    rng = np.random.default_rng(int(bits * 10))
    g = rng.normal(size=(4, 257)).astype(np.float32)
    u = rng.uniform(size=(4, 257)).astype(np.float32)
    ref_lv = ref_engine.quantize_levels(bits)
    assert engine.quantize_levels(bits) == ref_lv
    got_lv = engine.quantize_levels(torch.tensor(bits, dtype=torch.float32))
    np.testing.assert_allclose(
        got_lv.numpy(), np.asarray(ref_engine.quantize_levels(jnp.float32(bits))),
        rtol=1e-6)
    for bb, ref_b in ((bits, bits),
                      (torch.tensor(bits, dtype=torch.float32), jnp.float32(bits))):
        got = engine.quantize_with_noise(torch.from_numpy(g),
                                         torch.from_numpy(u), bb)
        ref = ref_engine.quantize_with_noise(jnp.asarray(g), jnp.asarray(u),
                                             ref_b)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **Q_TOL)
    # the tensor path of the reference's kernel helper agrees too
    np.testing.assert_allclose(
        agg_ref.quantizer_levels(torch.tensor([bits, 1.0])).numpy(),
        np.asarray(ref_agg_ref.quantizer_levels(jnp.asarray([bits, 1.0]))),
        rtol=1e-6)


def test_quantize_stochastic_draws_from_the_generator():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 50))
                         .astype(np.float32))
    q1 = engine.quantize_stochastic(g, torch.Generator().manual_seed(4), 4)
    q2 = engine.quantize_stochastic(g, torch.Generator().manual_seed(4), 4)
    u = torch.rand(g.shape, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(q1, q2, rtol=0, atol=0)
    torch.testing.assert_close(q1, engine.quantize_with_noise(g, u, 4),
                               rtol=0, atol=0)
    levels = engine.quantize_levels(4)
    assert float(q1.abs().max()) <= float(g.abs().max()) + 1e-6
    assert len(torch.unique(q1)) <= 2 * levels + 1


@pytest.mark.parametrize("n,d", [(1, 33), (5, 1000), (12, 513), (3, 2490)])
@pytest.mark.parametrize("per_client", [False, True])
def test_quantized_aggregate_plain_matches_reference(n, d, per_client):
    """Ragged N and D, scalar and per-client widths, against the
    reference's Pallas kernel in interpret mode and its oracle."""
    rng = np.random.default_rng(n * 1000 + d)
    g = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.uniform(size=(n, d)).astype(np.float32)
    coef = (rng.uniform(size=n) * (rng.uniform(size=n) > 0.3)).astype(np.float32)
    bits = (rng.choice([1.0, 4.0, 8.0, NOT_WHOLE, 32.0], n).astype(np.float32)
            if per_client else 8)
    ref = np.asarray(ref_agg_ops.quantized_masked_aggregate(
        jnp.asarray(g), jnp.asarray(coef), jnp.asarray(u),
        jnp.asarray(bits) if per_client else bits, interpret=True))
    got = agg_ops.quantized_masked_aggregate(
        torch.from_numpy(g), torch.from_numpy(coef), torch.from_numpy(u),
        torch.from_numpy(np.asarray(bits)) if per_client else bits)
    np.testing.assert_allclose(got.numpy(), ref, **Q_TOL)
    oracle = ref_agg_ref.quantized_masked_aggregate_ref(
        jnp.asarray(g), jnp.asarray(coef), jnp.asarray(u), jnp.asarray(bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **Q_TOL)


def test_quantized_aggregate_batched_is_per_trajectory():
    """A leading trajectory axis is T independent sums, each equal to
    the one-trajectory call, bit for bit."""
    rng = np.random.default_rng(7)
    t, n = 3, 5
    g = torch.from_numpy(rng.normal(size=(t, n, 4, 9)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(t, n, 4, 9)).astype(np.float32))
    coef = torch.from_numpy(rng.uniform(size=(t, n)).astype(np.float32))
    bits = torch.from_numpy(rng.choice([2.0, 8.0, 16.0], (t, n)).astype(np.float32))
    out = agg_ops.quantized_masked_aggregate(g, coef, u, bits)
    assert out.shape == (t, 4, 9)
    for i in range(t):
        torch.testing.assert_close(
            out[i], agg_ops.quantized_masked_aggregate(g[i], coef[i], u[i],
                                                       bits[i]),
            rtol=0, atol=0)


def sparse_coef(rng, n, live):
    """Coefficients in (0, 1] on ``live`` of the n clients (a count, or
    "22pct" of them, as a quantised sweep round has) and 0 elsewhere."""
    coef = rng.uniform(0.01, 1.0, size=n).astype(np.float32)
    keep = round(0.22 * n) if live == "22pct" else live
    coef[rng.permutation(n)[keep:]] = 0.0
    return coef


@pytest.mark.parametrize("live", [0, 1, "22pct", 40])
@pytest.mark.parametrize("per_client", [False, True])
def test_quantized_aggregate_sparse_coefficients_match_reference(live,
                                                                  per_client):
    """No live client, one, about 22 % of them and all 40: the rows whose
    coefficient is 0 add nothing, against the reference's Pallas kernel
    in interpret mode and its oracle."""
    rng = np.random.default_rng(11 + (live if isinstance(live, int) else 22))
    n, d = 40, 300
    g = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.uniform(size=(n, d)).astype(np.float32)
    g[n // 2] = 0.0
    coef = sparse_coef(rng, n, live)
    bits = (rng.choice([1.0, 4.0, 8.0, NOT_WHOLE, 32.0], n).astype(np.float32)
            if per_client else 8)
    ref = np.asarray(ref_agg_ops.quantized_masked_aggregate(
        jnp.asarray(g), jnp.asarray(coef), jnp.asarray(u),
        jnp.asarray(bits) if per_client else bits, interpret=True))
    got = agg_ops.quantized_masked_aggregate(
        torch.from_numpy(g), torch.from_numpy(coef), torch.from_numpy(u),
        torch.from_numpy(np.asarray(bits)) if per_client else bits).numpy()
    assert int((coef != 0).sum()) == (round(0.22 * n) if live == "22pct"
                                      else live)
    np.testing.assert_allclose(got, ref, **Q_TOL)
    oracle = ref_agg_ref.quantized_masked_aggregate_ref(
        jnp.asarray(g), jnp.asarray(coef), jnp.asarray(u), jnp.asarray(bits))
    np.testing.assert_allclose(got, np.asarray(oracle), **Q_TOL)
    if live == 0:
        assert not got.any()


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_quantized_aggregate_nonfinite_zero_coefficient_row_matches_reference(
        bad):
    """A client whose coefficient is 0 but whose row holds a NaN or an
    inf: its scale is non-finite, 0 * Q(g) is NaN, and the reference's
    sum is NaN.  Trajectory 0 holds such a row, trajectory 1 does not;
    NaN at the same places in both outputs, every other value equal."""
    rng = np.random.default_rng(5)
    t, n, d = 2, 12, 300
    g = rng.normal(size=(t, n, d)).astype(np.float32)
    u = rng.uniform(size=(t, n, d)).astype(np.float32)
    coef = np.stack([sparse_coef(rng, n, 4) for _ in range(t)])
    dead = int(np.flatnonzero(coef[0] == 0)[0])
    g[0, dead, 17] = bad
    bits = rng.choice([4.0, 8.0, 16.0], (t, n)).astype(np.float32)
    ref = np.stack([np.asarray(ref_agg_ops.quantized_masked_aggregate(
        jnp.asarray(g[i]), jnp.asarray(coef[i]), jnp.asarray(u[i]),
        jnp.asarray(bits[i]), interpret=True)) for i in range(t)])
    got = agg_ops.quantized_masked_aggregate(
        torch.from_numpy(g), torch.from_numpy(coef), torch.from_numpy(u),
        torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0]).all() and np.isfinite(got[1]).all()
    np.testing.assert_allclose(got[1], ref[1], **Q_TOL)


@pytest.mark.parametrize("bits", [4, "per_client"])
def test_quantized_aggregate_pytree_matches_reference(bits):
    """CNN-shaped leaves, the reference's noise tree passed in."""
    n = 3
    rng = np.random.default_rng(2)
    gstack = jax.tree_util.tree_map(
        lambda s: rng.normal(size=(n,) + s).astype(np.float32) * 0.1,
        CNN_SHAPES, is_leaf=lambda x: isinstance(x, tuple))
    coef = np.asarray([0.5, 0.0, 0.25], np.float32)
    b = np.asarray([8.0, 16.0, 4.0], np.float32) if bits == "per_client" else bits
    key = jax.random.PRNGKey(9)
    ref = ref_agg_ops.quantized_aggregate_pytree(
        jax.tree_util.tree_map(jnp.asarray, gstack), jnp.asarray(coef), key,
        jnp.asarray(b) if bits == "per_client" else b, interpret=True)
    noise = ref_noise_tree(key, CNN_SHAPES, n)
    port_b = torch.from_numpy(b) if bits == "per_client" else b
    got = agg_ops.quantized_aggregate_pytree(
        params_from_numpy(gstack, "cpu"), torch.from_numpy(coef), port_b,
        noise=noise)
    unfused = agg_ops.masked_aggregate_pytree(
        engine._quantize_tree(params_from_numpy(gstack, "cpu"), port_b,
                              noise=noise), torch.from_numpy(coef))
    for r, g, f in zip(jax.tree_util.tree_leaves(ref), tree_leaves(got),
                       tree_leaves(unfused)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **Q_TOL)
        # quantise-then-sum is the fused sum's own arithmetic and order
        torch.testing.assert_close(f, g, rtol=0, atol=0)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=(2, 6, 40)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(2, 6, 40)).astype(np.float32))
    coef = torch.from_numpy(rng.uniform(size=(2, 6)).astype(np.float32))
    levels = agg_ref.quantizer_levels(torch.full((2, 6), 4.0))
    scale = agg_ops.row_scale(g, levels)
    before = dict(cuda_lib.LAUNCHES)
    out = agg_ops.quantized_masked_aggregate_batched(g, coef, u, scale, levels)
    assert cuda_lib.LAUNCHES == before
    torch.testing.assert_close(
        out, agg_ref.quantized_masked_aggregate_ref(g, coef, u, scale, levels),
        rtol=0, atol=0)
    torch.testing.assert_close(
        agg_ops.quantized_masked_aggregate(g, coef, u, 4), out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="expected g and noise"):
        agg_ops.quantized_masked_aggregate_batched(g, coef, u[:, :3], scale,
                                                   levels)


def test_row_scale_batched_takes_row_scale_on_cpu():
    """On CPU tensors the scale pass is ``row_scale``, launches nothing,
    and gives the reference's max(max|g|, 1e-12) / L, with NaN and inf
    rows propagated and an all-zero row at 1e-12 / L."""
    rng = np.random.default_rng(8)
    g = rng.normal(size=(2, 5, 40)).astype(np.float32)
    g[0, 1] = 0.0
    g[0, 2, 7] = np.nan
    g[1, 3, 0] = -np.inf
    bits = rng.choice([1.0, 4.0, NOT_WHOLE, 32.0], (2, 5)).astype(np.float32)
    levels = agg_ref.quantizer_levels(torch.from_numpy(bits))
    before = dict(cuda_lib.LAUNCHES)
    got = agg_ops.row_scale_batched(torch.from_numpy(g), levels)
    assert cuda_lib.LAUNCHES == before
    torch.testing.assert_close(got, agg_ops.row_scale(torch.from_numpy(g), levels),
                               rtol=0, atol=0, equal_nan=True)
    ref_levels = ref_agg_ref.quantizer_levels(jnp.asarray(bits))
    ref = np.asarray(jnp.maximum(jnp.max(jnp.abs(jnp.asarray(g)), axis=-1),
                                 1e-12) / ref_levels)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    assert bool(torch.isnan(got[0, 2])) and bool(torch.isinf(got[1, 3]))
    with pytest.raises(ValueError, match="expected g"):
        agg_ops.row_scale_batched(torch.from_numpy(g), levels[:, :3])


def test_noise_streams_follow_the_generators():
    """One [N, *leaf] draw per leaf in sorted-key order from each
    trajectory's generator; a batched draw is the stacked single ones."""
    tree = {"b": torch.zeros(4, 3), "a": {"y": torch.zeros(4, 2), "x": torch.zeros(4)}}
    one = agg_ops.uniform_noise_like(tree, torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(1)
    for leaf in tree_leaves(one):                 # sorted: a.x, a.y, b
        torch.testing.assert_close(leaf, torch.rand(leaf.shape, generator=gen),
                                   rtol=0, atol=0)
    batched = {k: torch.stack([v, v]) if not isinstance(v, dict) else
               {kk: torch.stack([vv, vv]) for kk, vv in v.items()}
               for k, v in tree.items()}
    two = agg_ops.uniform_noise_like(
        batched, [torch.Generator().manual_seed(s) for s in (1, 2)])
    other = agg_ops.uniform_noise_like(tree, torch.Generator().manual_seed(2))
    for b, x, y in zip(tree_leaves(two), tree_leaves(one), tree_leaves(other)):
        torch.testing.assert_close(b[0], x, rtol=0, atol=0)
        torch.testing.assert_close(b[1], y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generators"):
        agg_ops.uniform_noise_like(batched, [torch.Generator()])
    with pytest.raises(ValueError, match="exactly one"):
        agg_ops.quantized_aggregate_pytree(tree, torch.ones(4), 8)


# ------------------------------------------------------------ bit menu

def test_golden_n3_select_best_bits():
    """The reference's golden case (menu order 32, 16, 8): device 0 picks
    8, device 1's exact tie and device 2's float-noise gain keep 32."""
    s = 1000.0
    a_m = [[0.3, 1.0, 0.4], [0.5, 1.0, 0.4 + 1e-8], [0.9, 1.0, 0.4]]
    p_m = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]]
    sbits_m = [[s] * 3, [s / 2] * 3, [s / 4] * 3]
    a, p, bits = select_best_bits(*(torch.tensor(x) for x in (a_m, p_m, sbits_m)),
                                  s_bits=s)
    ref = ref_alt.select_best_bits(*(jnp.asarray(x) for x in (a_m, p_m, sbits_m)),
                                   s_bits=s)
    np.testing.assert_allclose(bits.numpy(), [8.0, 32.0, 32.0])
    np.testing.assert_allclose(a.numpy(), [0.9, 1.0, 0.4])
    np.testing.assert_allclose(p.numpy(), [7.0, 2.0, 3.0])
    for got, r in zip((a, p, bits), ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(r))


def _starved(seed, n=32):
    return ref_make_problem("bandwidth_starved", seed=seed, n_devices=n)


@pytest.mark.parametrize("seed,cap,chunk", [(1, None, None), (3, None, 8),
                                            (4, 16.0, None)])
def test_solve_joint_fused_bit_menu_matches_reference(seed, cap, chunk):
    ref_prob = _starved(seed)
    if cap is not None:      # a problem-level bits leaf caps the menu
        ref_prob = dataclasses.replace(
            ref_prob, bits=jnp.full((ref_prob.n_devices,), cap, jnp.float32))
    ref = ref_alt.solve_joint_fused(ref_prob, bit_menu=MENU)
    got = alternating.solve_joint_fused(port_problem(ref_prob), bit_menu=MENU,
                                        chunk_elements=chunk)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(ref.a), rtol=0,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power),
                               rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(ref.bits))
    assert got.bits.shape == (ref_prob.n_devices,)
    assert float(got.bits.max()) <= (32.0 if cap is None else cap)
    if cap is None:
        plain = alternating.solve_joint_fused(port_problem(ref_prob))
        assert plain.bits is None
        assert float(got.a.sum()) > float(plain.a.sum())


def test_solve_joint_fused_rejects_a_bad_menu():
    prob = port_problem(_starved(1, n=4))
    for menu in ((), (0, 8), (8, 64)):
        with pytest.raises(ValueError, match="bit_menu"):
            alternating.solve_joint_fused(prob, bit_menu=menu)


def test_scheduler_threads_the_menu():
    ref_prob = _starved(2, n=16)
    prob = port_problem(ref_prob)
    sch = schedulers.ProbabilisticScheduler(solver="fused", bit_menu=MENU)
    sol = sch.solve(prob)
    direct = alternating.solve_joint_fused(prob, bit_menu=MENU)
    torch.testing.assert_close(sol.bits, direct.bits, rtol=0, atol=0)
    torch.testing.assert_close(sch.precompute(prob).a, direct.a, rtol=0, atol=0)
    ref = ref_sched.ProbabilisticScheduler(solver="fused",
                                           bit_menu=MENU).solve(ref_prob)
    np.testing.assert_array_equal(sol.bits.numpy(), np.asarray(ref.bits))
    for solver in ("alternating", "optimal"):
        with pytest.raises(ValueError, match="bit_menu"):
            schedulers.ProbabilisticScheduler(solver=solver,
                                              bit_menu=MENU).solve(prob)


# ------------------------------------------------------------- engines

@pytest.fixture(scope="module")
def setup():
    ref_train, ref_test = ref_make_mnist_like(240, 60, seed=0)
    train, test = make_mnist_like(240, 60, seed=0)
    parts = ref_partition(ref_train, N_DEV, beta=0.3, seed=1)
    sizes = np.array([len(p) for p in parts])
    ref_prob = ref_sample_problem(0, N_DEV, tau_th=0.5, dirichlet_sizes=sizes)
    return dict(ref_train=ref_train, ref_test=ref_test, train=train,
                test=test, parts=parts, ref_prob=ref_prob,
                prob=port_problem(ref_prob))


@pytest.mark.parametrize("bits", [8, 2])
def test_run_fl_uplink_bits_matches_reference(setup, bits):
    s = setup
    kw = dict(n_rounds=3, eval_every=1, batch_per_client=4, aggregate="stacked",
              uplink_bits=bits, seed=11)
    ref_cfg, cfg = ref_engine.FLConfig(**kw), engine.FLConfig(**kw)
    ref_sch = ref_sched.ProbabilisticScheduler()
    ref_state = ref_sch.precompute(s["ref_prob"])
    ref_params = np_tree(ref_cnn.init(jax.random.PRNGKey(5)))
    ref = ref_engine.run_fl(s["ref_prob"], ref_sch, s["ref_train"], s["parts"],
                            s["ref_test"], ref_cfg, init_params=ref_params)
    masks = ref_masks(s["ref_prob"], ref_sch, s["parts"], ref_cfg)
    assert masks.any(), "the case must train"
    noise = ref_round_noise(cfg.seed, cfg.n_rounds, N_DEV)
    runs = [engine.run_fl(
        s["prob"], GivenState(given=port_state(ref_state)), s["train"],
        s["parts"], s["test"], cfg,
        init_params=params_from_numpy(ref_params, device="cpu"),
        masks=masks, noise=noise, device="cpu", aggregate_fn=fn)
        for fn in (None, agg_ops.masked_aggregate_pytree)]
    assert_histories(ref.history, runs[0].history)
    assert_params_within_levels(ref.params, runs[0].params,
                                level_bound(cfg, cfg.n_rounds, bits))
    # quantise-then-sum with a caller's aggregate_fn: the same arithmetic
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sweep_bits_table_matches_reference(setup):
    """joint_bits (the menu's widths, on a problem carrying them), a fixed
    8-bit and a fixed 4-bit uplink in one quantised sweep."""
    s = setup
    kw = dict(n_rounds=3, eval_every=2, batch_per_client=4, aggregate="stacked")
    ref_sol = ref_alt.solve_joint_fused(s["ref_prob"], bit_menu=MENU)
    got_sol = alternating.solve_joint_fused(s["prob"], bit_menu=MENU)
    np.testing.assert_array_equal(got_sol.bits.numpy(), np.asarray(ref_sol.bits))
    alpha = ref_sched._data_weights(s["ref_prob"])
    joint = ref_sched.SchedulerState(a=ref_sol.a, power=ref_sol.power,
                                     agg_weights=alpha)
    ref_qprob = dataclasses.replace(s["ref_prob"], bits=ref_sol.bits)
    cases = [(ref_qprob, dict(bits=np.asarray(ref_sol.bits)), {}, joint),
             (s["ref_prob"], {}, dict(uplink_bits=8), None),
             (s["ref_prob"], {}, dict(uplink_bits=4), None)]
    ref_plans, plans, ref_cfgs, cfgs, noises = [], [], [], [], []
    for j, (rp, bits_kw, cfg_kw, state) in enumerate(cases):
        ref_cfg = ref_engine.FLConfig(**kw, **cfg_kw, seed=3 + j)
        cfg = engine.FLConfig(**kw, **cfg_kw, seed=3 + j)
        ref_sch = ref_sched.ProbabilisticScheduler(solver="fused")
        state = ref_sch.precompute(rp) if state is None else state
        ref_plans.append(ref_scan.plan_trajectory(rp, ref_sch, s["parts"],
                                                  ref_cfg, state=state,
                                                  **bits_kw))
        plans.append(scan_engine.plan_trajectory(
            port_problem(rp), schedulers.ProbabilisticScheduler(), s["parts"],
            cfg, state=port_state(state),
            masks=ref_masks(rp, ref_sch, s["parts"], ref_cfg, state=state),
            **bits_kw))
        ref_cfgs.append(ref_cfg)
        cfgs.append(cfg)
        noises.append(ref_round_noise(cfg.seed, cfg.n_rounds, N_DEV))
    ref_params = ref_scan.init_sweep_params(ref_cfgs)
    ref = ref_scan.run_fl_sweep(ref_scan.stack_plans(ref_plans), s["ref_train"],
                                s["ref_test"], ref_cfgs[0], ref_params,
                                shard=False)
    got = scan_engine.run_fl_sweep(
        scan_engine.stack_plans(plans), s["train"], s["test"], cfgs[0],
        params_from_numpy(np_tree(ref_params), device="cpu"),
        noise=stack_noise(noises), device="cpu")
    np.testing.assert_array_equal(plans[0].bits.numpy(),
                                  np.asarray(ref_plans[0].bits))
    for t, bits in enumerate((min(MENU), 8, 4)):
        assert_histories(ref.histories[t], got.histories[t])
        assert_params_within_levels(ref.result(t).params, got.result(t).params,
                                    level_bound(cfgs[t], cfgs[t].n_rounds, bits))
    assert sum(int(h.participants.sum()) for h in got.histories) > 0


@pytest.mark.parametrize("bits", [8, 4])
def test_port_sweep_reproduces_port_loop(setup, bits):
    """Both engines draw round k's noise from (seed, k)'s generator, so
    they agree with each other, also when a round had no participant
    (the loop draws no noise there, the sweep does)."""
    s = setup
    cfg = engine.FLConfig(n_rounds=4, eval_every=2, batch_per_client=4,
                          aggregate="stacked", uplink_bits=bits, seed=2)
    masks = np.random.default_rng(bits).uniform(size=(4, N_DEV)) < 0.5
    masks[1] = False
    for sch, kw in ((schedulers.ProbabilisticScheduler(solver="fused"), {}),
                    (schedulers.UniformScheduler(m=3), {}),
                    (schedulers.ProbabilisticScheduler(solver="fused"),
                     dict(masks=masks))):
        loop = engine.run_fl(s["prob"], sch, s["train"], s["parts"], s["test"],
                             cfg, device="cpu", **kw)
        sweep = scan_engine.run_fl_scan(s["prob"], sch, s["train"], s["parts"],
                                        s["test"], cfg, device="cpu", **kw)
        np.testing.assert_array_equal(sweep.history.participants,
                                      loop.history.participants)
        np.testing.assert_allclose(sweep.history.sim_time,
                                   loop.history.sim_time, rtol=TIME_RTOL)
        for r, g in zip(tree_leaves(loop.params), tree_leaves(sweep.params)):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=PARAM_TOL,
                                       atol=PARAM_TOL)
    assert (loop.history.participants == 0).any()


def test_quantized_arguments_are_refused(setup):
    s = setup
    cfg = engine.FLConfig(n_rounds=2, eval_every=1, batch_per_client=2,
                          aggregate="stacked")
    sch = schedulers.UniformScheduler(m=2)
    run = dict(train=s["train"], parts=s["parts"], test=s["test"])
    fused8 = dataclasses.replace(cfg, aggregate="fused", uplink_bits=8)
    with pytest.raises(ValueError, match="stacked"):
        engine.run_fl(s["prob"], sch, config=fused8, device="cpu", **run)
    with pytest.raises(ValueError, match="stacked"):
        scan_engine.plan_trajectory(s["prob"], sch, s["parts"], fused8)
    with pytest.raises(ValueError, match="stacked"):
        scan_engine.plan_trajectory(s["prob"], sch, s["parts"],
                                    dataclasses.replace(cfg, aggregate="fused"),
                                    bits=np.full(N_DEV, 8.0))
    with pytest.raises(ValueError, match="not both"):
        scan_engine.plan_trajectory(s["prob"], sch, s["parts"],
                                    dataclasses.replace(cfg, uplink_bits=8),
                                    bits=np.full(N_DEV, 8.0))
    for bad in (0, 0.5):
        with pytest.raises(ValueError, match="bits >= 1"):
            engine.run_fl(s["prob"], sch, config=dataclasses.replace(
                cfg, uplink_bits=bad), device="cpu", **run)
        with pytest.raises(ValueError, match="bits >= 1"):
            engine.quantize_levels(bad)
    with pytest.raises(ValueError, match="noise"):
        engine.run_fl(s["prob"], sch, config=cfg, device="cpu",
                      noise=[{}] * cfg.n_rounds, **run)
    plain = scan_engine.plan_trajectory(s["prob"], sch, s["parts"], cfg)
    quant = scan_engine.plan_trajectory(s["prob"], sch, s["parts"], cfg,
                                        bits=np.full(N_DEV, 8.0))
    assert plain.bits is None and quant.bits.shape == (2, N_DEV)
    with pytest.raises(ValueError, match="bit-width tables"):
        scan_engine.stack_plans([plain, quant])
    params0 = scan_engine.init_sweep_params([cfg], "cpu")
    sweep = dict(train=s["train"], test=s["test"], init_params=params0,
                 device="cpu")
    with pytest.raises(ValueError, match="no bits table"):
        scan_engine.run_fl_sweep(scan_engine.stack_plans([plain]),
                                 config=dataclasses.replace(cfg, uplink_bits=8),
                                 **sweep)
    with pytest.raises(ValueError, match="aggregate='stacked'"):
        scan_engine.run_fl_sweep(scan_engine.stack_plans([quant]),
                                 config=dataclasses.replace(cfg, aggregate="fused"),
                                 **sweep)
    with pytest.raises(ValueError, match="noise"):
        scan_engine.run_fl_sweep(scan_engine.stack_plans([plain]), config=cfg,
                                 noise=[{}] * cfg.n_rounds, **sweep)
    stacked = scan_engine.stack_plans([quant, quant])
    assert stacked.bits.shape == (2, 2, N_DEV)
    assert stacked.to("cpu").bits is not None
    assert scan_engine.stack_plans([plain, plain]).bits is None
