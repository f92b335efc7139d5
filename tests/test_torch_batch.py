"""Parity of the port's batched solve and scenario registry with the JAX
reference.

The same numpy-seeded problems go through ``repro`` and ``repro_torch``
(on the CPU) in one process, data passed as numpy.  Tolerances:

* numpy draws (the registry's scenarios, stacking, padding) bit for bit:
  both packages run the same numpy code and cast to float32 once;
* solves at 1e-5 on a*, P* and the objective, the reference's own solver
  tolerance (see ``tests/test_torch_core.py``); the reference's kernel
  methods run in interpret mode, their default off the TPU;
* per-instance ``converged`` equal and ``n_iters`` within one, as the
  single solves are held: the objectives' float32 sums are taken in
  another order, and the stopping rule compares them at eps = 1e-7;
* every batched method also against a loop of the port's own
  per-instance solves, at the same tolerances;
* plans from a batched solve at rtol 1e-6 (a few float32 ulps of the
  tx-time tables), minibatches and masks exactly; the reference's
  participation masks are passed in (``jax.random`` streams cannot be
  reproduced in torch).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch as ref_batch
from repro.core import multicell as ref_multicell
from repro.core import problem as ref_problem
from repro.core import scenarios as ref_scenarios
from repro.core import schedulers as ref_sched
from repro.data.partition import dirichlet_partition as ref_partition
from repro.data.synthetic import make_mnist_like as ref_make_mnist_like
from repro.fl import engine as ref_engine
from repro.fl import scan_engine as ref_scan
from repro_torch.convert import problem_from_numpy
from repro_torch.core import alternating, batch, multicell, optimal, scenarios, schedulers
from repro_torch.fl import engine, scan_engine
from repro_torch.kernels.selection_solve import ops

torch.set_num_threads(1)

TENSOR_FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j",
                 "dataset_size", "cycles_per_sample", "cpu_hz", "weights",
                 "fading", "interference", "bits")
CONSTANTS = ("grad_size_bits", "noise_power", "p_max", "tau_th", "kappa",
             "n_rounds")
SOLVE_TOL = 1e-5
TIME_RTOL = 1e-6
METHODS = ("alternating", "fused", "optimal", "kernel", "fused_kernel")
MULTICELL = ("metro_coupled", "interference_grid")
# the mega-fleet entries at a fleet size a CPU test can draw
SMALL_FLEET = {"mega_fleet_100k": 1000, "metro_1m_users": 1000,
               "drifting_mega_fleet": 1000}


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_problem(ref):
    fields = {f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
              for f in TENSOR_FIELDS}
    fields.update({c: getattr(ref, c) for c in CONSTANTS})
    return problem_from_numpy(fields, device="cpu")


def stack_both(refs):
    return (ref_batch.stack_problems(refs),
            batch.stack_problems([port_problem(p) for p in refs], device="cpu"))


def assert_problem_equal(ref, got):
    for f in TENSOR_FIELDS:
        r, g = getattr(ref, f), getattr(got, f)
        assert (r is None) == (g is None), f
        if r is not None:
            assert g.dtype == torch.float32, f
            np.testing.assert_array_equal(np_(g), np.asarray(r), err_msg=f)
    for c in CONSTANTS:
        assert getattr(got, c) == getattr(ref, c), c


def assert_batch_equal(ref, got):
    assert_problem_equal(ref.problem, got.problem)
    np.testing.assert_array_equal(np_(got.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(np_(got.fleet_sizes), np.asarray(ref.fleet_sizes))


def assert_solution(ref, got, tol=SOLVE_TOL):
    np.testing.assert_allclose(np_(got.a), np.asarray(ref.a), atol=tol, rtol=0)
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(np_(got.objective), np.asarray(ref.objective),
                               atol=tol, rtol=0)


def assert_counts(ref_iters, ref_conv, got_iters, got_conv):
    np.testing.assert_array_equal(np.asarray(got_conv), np.asarray(ref_conv))
    assert np.all(np.abs(np.asarray(got_iters, np.int64)
                         - np.asarray(ref_iters, np.int64)) <= 1)


# --------------------------------------------------------------- batches

def _ragged():
    return [ref_problem.sample_problem(i, n, tau_th=0.3)
            for i, n in enumerate([8, 24, 16])]


def _fading_b_eq_k():
    # B == K == 3: a stacked [B, N_max, K] leaf whose two axes could swap
    return [ref_problem.sample_problem(10 + i, n, with_fading=True, n_rounds=3)
            for i, n in enumerate([5, 7, 6])]


def _b_eq_nmax():
    # B == N_max == 6: a stacked [B, N_max] leaf reads like one [N, K]
    # fading problem to a rank-dispatched per-instance method
    return [ref_problem.sample_problem(20 + i, n, tau_th=0.5)
            for i, n in enumerate([6, 4, 5, 6, 3, 6])]


def _interference():
    return [dataclasses.replace(
        ref_problem.sample_problem(30 + i, n),
        interference=jnp.full((n,), 3e-13 * (i + 1), jnp.float32))
        for i, n in enumerate([9, 12])]


def _bits():
    rng = np.random.default_rng(4)
    return [dataclasses.replace(
        ref_problem.sample_problem(40 + i, n, tau_th=0.2),
        bits=jnp.asarray(rng.choice([8.0, 16.0, 32.0], n), jnp.float32))
        for i, n in enumerate([10, 7])]


CASES = {"ragged": _ragged, "fading_b_eq_k": _fading_b_eq_k,
         "b_eq_nmax": _b_eq_nmax, "interference": _interference,
         "bits": _bits}
SINGLE = {"alternating": alternating.solve_joint,
          "fused": alternating.solve_joint_fused,
          "optimal": optimal.solve_joint_optimal,
          "kernel": ops.solve_joint_kernel,
          "fused_kernel": ops.solve_joint_fused_kernel}


@pytest.fixture(scope="module")
def stacked():
    return {name: (refs, *stack_both(refs))
            for name, make in CASES.items() for refs in [make()]}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_reference(stacked, case, method):
    refs, rb, tb = stacked[case]
    if case == "bits" and method in ("kernel", "fused_kernel"):
        with pytest.raises(ValueError, match="bits"):
            ref_batch.solve_joint_batch(rb, method=method)
        with pytest.raises(ValueError, match="bits"):
            batch.solve_joint_batch(tb, method=method)
        return
    ref = ref_batch.solve_joint_batch(rb, method=method)
    got = batch.solve_joint_batch(tb, method=method)
    assert tuple(got.a.shape) == tuple(np.shape(ref.a))
    assert tuple(got.objective.shape) == (len(refs),)
    assert_solution(ref, got)
    ref_iters = np.broadcast_to(np.asarray(ref.n_iters), (len(refs),))
    assert_counts(ref_iters, ref.converged, got.n_iters, got.converged)
    np.testing.assert_array_equal(np_(got.mask), np.asarray(ref.mask))
    if method == "alternating":
        # Dinkelbach's inner steps, per instance: float32 rounding may end
        # one alternation's inner loop a step apart, so at most one step
        # for each alternation
        diff = np.abs(np_(got.inner_iters) - np.asarray(ref.inner_iters))
        assert np.all(diff <= np.minimum(np_(got.n_iters), ref_iters))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_port_loop(stacked, case, method):
    """Each instance of the batched solve against the port's own solve of
    that instance alone."""
    _, _, tb = stacked[case]
    if case == "bits" and method in ("kernel", "fused_kernel"):
        with pytest.raises(ValueError, match="bits"):
            getattr(ops, f"solve_joint_{method}_batch")(tb)
        return
    sol = batch.solve_joint_batch(tb, method=method)
    for b, prob in enumerate(tb.unstack()):
        ref, got = SINGLE[method](prob), sol.instance(b)
        assert_solution(ref, got)
        if method == "fused":   # one loop runs until the slowest instance stops
            assert got.n_iters >= ref.n_iters - 1
            assert got.converged == ref.converged
        else:
            assert_counts([ref.n_iters], [ref.converged], [got.n_iters],
                          [got.converged])
        if method == "alternating":
            assert got.inner_iters == ref.inner_iters
        assert bool(prob.constraints_satisfied(got.a, got.power,
                                               rtol=1e-3).all())


@pytest.mark.parametrize("max_iters", [50, 2])
def test_alternating_stops_each_instance_on_its_own(max_iters):
    """Instances whose Algorithm-2 loops take 2 and 3 steps (the printed
    eq. 13 converges more slowly), and a budget of 2 that leaves some
    unconverged: each keeps its own count, as under ``vmap``; the fused
    method shares one.  (Not on fading draws: there the eq.-10 power
    gate at a^0, where P^min(a^0) = P^max in exact arithmetic, goes either
    way with XLA's and torch's expm1, and the printed eq. 13 turns the
    flip into a jump of a.)"""
    refs = [ref_scenarios.make_problem("dense_1k", s, n_devices=12)
            for s in range(6)]
    rb, tb = stack_both(refs)
    kw = dict(faithful_eq13_typo=True, power_solver="analytic",
              max_iters=max_iters)
    ref = ref_batch.solve_joint_batch(rb, method="alternating", **kw)
    got = batch.solve_joint_batch(tb, method="alternating", **kw)
    assert_solution(ref, got)
    assert_counts(ref.n_iters, ref.converged, got.n_iters, got.converged)
    assert len(set(got.n_iters.tolist() if max_iters > 2
                   else got.converged.tolist())) == 2
    for b, prob in enumerate(tb.unstack()):
        single = alternating.solve_joint(prob, **kw)
        assert (got.instance(b).n_iters, got.instance(b).converged) == \
            (single.n_iters, single.converged)
    fused = batch.solve_joint_batch(tb, method="fused", **kw)
    ref = ref_batch.solve_joint_batch(rb, method="fused", **kw)
    assert_solution(ref, fused)
    assert len(set(fused.n_iters.tolist())) == 1
    assert_counts(ref.n_iters, ref.converged, fused.n_iters, fused.converged)


def test_padding_inert(stacked):
    _, _, tb = stacked["fading_b_eq_k"]
    padded = batch.pad_batch(tb, batch_size=5, n_max=11)
    for method in METHODS:
        sol = batch.solve_joint_batch(tb, method=method)
        big = batch.solve_joint_batch(padded, method=method)
        pad = ~np_(padded.mask)
        assert np.all(np_(big.a)[pad] == 0.0) and np.all(np_(big.power)[pad] == 0.0)
        np.testing.assert_array_equal(np_(big.objective)[3:], 0.0)
        np.testing.assert_allclose(np_(big.objective)[:3], np_(sol.objective),
                                   atol=SOLVE_TOL, rtol=0)
        np.testing.assert_allclose(np_(big.a)[:3, :7], np_(sol.a),
                                   atol=SOLVE_TOL, rtol=0)
        assert big.instance(4).a.shape == (0, 3)


def test_fused_options_match_reference(stacked):
    _, rb, tb = stacked["ragged"]
    kw = dict(method="fused", chunk_elements=16)
    ref, got = (ref_batch.solve_joint_batch(rb, **kw),
                batch.solve_joint_batch(tb, **kw))
    assert_solution(ref, got)
    assert_counts(ref.n_iters, ref.converged, got.n_iters, got.converged)
    kw = dict(method="fused", bit_menu=(32, 8, 16))
    ref, got = (ref_batch.solve_joint_batch(rb, **kw),
                batch.solve_joint_batch(tb, **kw))
    assert_solution(ref, got)
    np.testing.assert_array_equal(np_(got.bits), np.asarray(ref.bits))
    assert got.instance(0).bits.shape == (8,)
    kw = dict(method="fused_kernel", max_iters=7, faithful_eq13_typo=True)
    assert_solution(ref_batch.solve_joint_batch(rb, **kw),
                    batch.solve_joint_batch(tb, **kw))


# ---------------------------------------------------------------- stacking

def test_ragged_roundtrip_matches_reference():
    refs = _ragged()
    rb, tb = stack_both(refs)
    assert (tb.batch_size, tb.n_max) == (3, 24)
    assert_batch_equal(rb, tb)
    for ref, back in zip(refs, tb.unstack()):
        assert_problem_equal(ref, back)


def test_unit_fading_opts_a_static_instance_in():
    a = ref_problem.sample_problem(0, 8, with_fading=True, n_rounds=3)
    b = ref_problem.sample_problem(1, 8, n_rounds=3)
    c = dataclasses.replace(b, fading=jnp.ones((8, 3), jnp.float32))
    rb, tb = stack_both([a, c])
    assert tuple(tb.problem.fading.shape) == (2, 8, 3)
    assert_batch_equal(rb, tb)


def _refused(name):
    a = ref_problem.sample_problem(0, 8, with_fading=True, n_rounds=3)
    s = ref_problem.sample_problem(1, 8)
    i1 = dataclasses.replace(s, interference=jnp.zeros(8, jnp.float32))
    i2 = dataclasses.replace(s, interference=jnp.zeros((8, 2), jnp.float32))
    b1 = dataclasses.replace(s, bits=jnp.full(8, 8.0, jnp.float32))
    b2 = dataclasses.replace(s, bits=jnp.full((8, 2), 8.0, jnp.float32))
    return {"static": ([s, dataclasses.replace(s, tau_th=0.5)], "tau_th"),
            "fading": ([a, ref_problem.sample_problem(2, 8, n_rounds=3)],
                       "all-or-none"),
            "interference": ([i1, s], "all-or-none"),
            "interference_rank": ([i1, i2], "rank"),
            "bits": ([s, b1], "all-or-none"),
            "bits_rank": ([b1, b2], "rank"),
            "empty": ([], "at least one")}[name]


@pytest.mark.parametrize("name", ["static", "fading", "interference",
                                  "interference_rank", "bits", "bits_rank",
                                  "empty"])
def test_stack_refusals_match_reference(name):
    refs, match = _refused(name)
    with pytest.raises(ValueError, match=match):
        ref_batch.stack_problems(refs)
    with pytest.raises(ValueError, match=match):
        batch.stack_problems([port_problem(p) for p in refs], device="cpu")


def test_pad_batch_matches_reference():
    rb, tb = stack_both(_fading_b_eq_k())
    assert_batch_equal(ref_batch.pad_batch(rb, batch_size=5, n_max=9),
                       batch.pad_batch(tb, batch_size=5, n_max=9))
    rb, tb = stack_both(_bits() + [])
    assert_batch_equal(ref_batch.pad_batch(rb, n_max=12),
                       batch.pad_batch(tb, n_max=12))
    assert batch.pad_batch(tb) is tb
    with pytest.raises(ValueError, match="shrink"):
        batch.pad_batch(tb, batch_size=1)


def test_batch_elements_match_reference(stacked):
    for case in ("b_eq_nmax", "fading_b_eq_k", "interference", "bits"):
        _, rb, tb = stacked[case]
        ref, got = ref_batch.batch_elements(rb), batch.batch_elements(tb)
        for f in ("pg", "bw", "emax", "ec", "sbits"):
            r, g = getattr(ref, f), getattr(got, f)
            assert (r is None) == (g is None), f
            if r is not None:
                np.testing.assert_allclose(np_(g), np.asarray(r), rtol=1e-6,
                                           err_msg=f"{case} {f}")


def test_argument_checks():
    _, tb = stack_both(_ragged())
    _, tbits = stack_both(_bits())
    refusals = [
        (dict(method="nope"), ValueError, "unknown method"),
        (dict(method="alternating", bit_menu=(8,)), ValueError, "bit_menu"),
        (dict(method="optimal", faithful_eq13_typo=True), ValueError,
         "faithful_eq13_typo"),
        (dict(method="alternating", chunk_elements=8), ValueError,
         "chunk_elements"),
        (dict(method="fused_kernel", power_solver="dinkelbach"), ValueError,
         "analytic"),
        (dict(method="fused", mesh=object()), ValueError, "one device"),
        (dict(method="fused", sanitize=True), NotImplementedError, "sanitize"),
        (dict(method="alternating", init=(0.0, 0.0)), NotImplementedError,
         "init"),
    ]
    for kw, exc, match in refusals:
        with pytest.raises(exc, match=match):
            batch.solve_joint_batch(tb, **kw)
    with pytest.raises(ValueError, match="bits"):
        batch.solve_joint_batch(tbits, method="kernel")
    sol = batch.solve_joint_batch(tb, method="fused", shard=False)
    assert sol.n_iters.shape == (3,)


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("name", sorted(set(ref_scenarios.SCENARIOS) - set(MULTICELL)))
def test_registry_draws_bitwise(name):
    kw = {"n_devices": SMALL_FLEET[name]} if name in SMALL_FLEET else {}
    assert scenarios.SCENARIOS[name].n_devices == \
        ref_scenarios.SCENARIOS[name].n_devices
    for seed in (0, 5):
        assert_problem_equal(ref_scenarios.make_problem(name, seed, **kw),
                             scenarios.make_problem(name, seed, device="cpu",
                                                    **kw))


@pytest.mark.parametrize("name", MULTICELL)
def test_multicell_scenarios_match_reference(name):
    kw = dict(n_cells=4, n_devices=8)
    ref = ref_scenarios.make_problem(name, 1, **kw)
    got = scenarios.make_problem(name, 1, device="cpu", **kw)
    assert isinstance(got, multicell.MultiCellProblem) and got.n_cells == 4
    assert_batch_equal(ref.cells, got.cells)
    np.testing.assert_array_equal(np_(got.coupling), np.asarray(ref.coupling))
    assert got.backhaul_bits == ref.backhaul_bits
    with pytest.raises(ValueError, match="MultiCellProblem"):
        scenarios.make_batch(name, 2, device="cpu", **kw)


def test_grid_coupling_and_make_multicell_refusals():
    for c, kw in ((4, {}), (5, dict(alpha=3.0, spacing=2.0))):
        np.testing.assert_array_equal(
            multicell.grid_coupling(c, gain=1e-12, **kw),
            ref_multicell.grid_coupling(c, gain=1e-12, **kw))
    refs = [ref_problem.sample_problem(i, 6) for i in range(2)]
    cells = [port_problem(p) for p in refs]
    bad = [(np.zeros((3, 3)), {}, r"\[2, 2\]"),
           (np.array([[0.0, -1.0], [0.0, 0.0]]), {}, "non-negative"),
           (np.eye(2), {}, "diagonal"),
           (np.array([[0.0, np.nan], [0.0, 0.0]]), {}, "finite"),
           (np.zeros((2, 2)), dict(backhaul_bits=0.0), "positive")]
    for g, kw, match in bad:
        with pytest.raises(ValueError, match=match):
            ref_multicell.make_multicell(refs, g, **kw)
        with pytest.raises(ValueError, match=match):
            multicell.make_multicell(cells, g, device="cpu", **kw)
    mc = multicell.make_multicell(
        batch.stack_problems(cells, device="cpu"),
        torch.tensor([[0.0, 1e-12], [2e-12, 0.0]]), backhaul_bits=5)
    assert mc.backhaul_bits == 5.0 and mc.coupling.dtype == torch.float32


def test_make_batch_and_mixed_batch_match_reference():
    kw = dict(n_devices=12)
    assert_batch_equal(ref_scenarios.make_batch("sparse_energy_starved", 3, 2, **kw),
                       scenarios.make_batch("sparse_energy_starved", 3, 2,
                                            device="cpu", **kw))
    names = ["paper_static", "hetero_bandwidth", "bandwidth_starved",
             "sparse_energy_starved"]
    ref = ref_scenarios.make_mixed_batch(names, seed=1)
    got = scenarios.make_mixed_batch(names, seed=1, device="cpu")
    assert got.n_max == 100
    assert_batch_equal(ref, got)
    assert_solution(ref_batch.solve_joint_batch(ref, method="kernel"),
                    batch.solve_joint_batch(got, method="kernel"))
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.make_problem("nope")


def test_gauss_markov_and_slice_round_match_reference():
    np.testing.assert_array_equal(scenarios.gauss_markov_fading(3, 9, 5, 0.8),
                                  ref_scenarios.gauss_markov_fading(3, 9, 5, 0.8))
    for c in (1.0, -0.1):
        with pytest.raises(ValueError, match="coherence"):
            scenarios.gauss_markov_fading(0, 4, 2, c)
    ref = ref_scenarios.make_problem("drifting_metro", 2, n_devices=10)
    ref = dataclasses.replace(ref, bits=jnp.full((10, 20), 16.0, jnp.float32))
    got = port_problem(ref)
    for k in (0, 7, 19):
        assert_problem_equal(ref_scenarios.slice_round(ref, k),
                             scenarios.slice_round(got, k))
    with pytest.raises(ValueError, match="fading"):
        scenarios.slice_round(scenarios.make_problem("paper_static", 0,
                                                     device="cpu"), 0)


# -------------------------------------------------------------- schedulers

def test_precompute_and_sample_batch():
    rb = ref_scenarios.make_batch("paper_static", 4, seed=0, n_devices=16)
    tb = scenarios.make_batch("paper_static", 4, seed=0, n_devices=16,
                              device="cpu")
    ref = ref_sched.ProbabilisticScheduler().precompute_batch(rb)
    sched = schedulers.ProbabilisticScheduler()
    state = sched.precompute_batch(tb)
    for r, g in zip(ref, state):
        np.testing.assert_allclose(np_(g), np.asarray(r), atol=SOLVE_TOL,
                                   rtol=SOLVE_TOL)
    np.testing.assert_allclose(np_(state.agg_weights.sum(1)), 1.0, rtol=1e-6)
    draw = sched.sample_batch(state, torch.Generator().manual_seed(3), k=0)
    assert draw.mask.shape == (4, 16) and draw.mask.dtype == torch.bool
    gen = torch.Generator().manual_seed(3)
    for b, prob in enumerate(tb.unstack()):
        one = sched.sample(schedulers.SchedulerState(*(x[b] for x in state)),
                           gen)
        np.testing.assert_array_equal(np_(draw.mask[b]), np_(one.mask))
        single = sched.precompute(prob)
        np.testing.assert_allclose(np_(state.a[b]), np_(single.a), atol=SOLVE_TOL)
    kernel = sched.precompute_batch(tb, method="kernel")
    exact = schedulers.ProbabilisticScheduler(solver="optimal").precompute_batch(tb)
    np.testing.assert_allclose(np_(kernel.a), np_(exact.a), atol=SOLVE_TOL)


def test_plans_from_batch_match_reference():
    n, b = 8, 3
    ref_train, _ = ref_make_mnist_like(240, 60, seed=0)
    parts_list = [ref_partition(ref_train, n, beta=0.3, seed=s) for s in range(b)]
    rb = ref_scenarios.make_batch("paper_static", b, seed=4, n_devices=n,
                                  tau_th=0.5)
    tb = scenarios.make_batch("paper_static", b, seed=4, n_devices=n,
                              tau_th=0.5, device="cpu")
    kw = dict(n_rounds=3, eval_every=2, batch_per_client=4)
    ref_cfgs = [ref_engine.FLConfig(**kw, seed=s) for s in range(b)]
    cfgs = [engine.FLConfig(**kw, seed=s) for s in range(b)]
    ref_sch = ref_sched.ProbabilisticScheduler(solver="optimal")
    sch = schedulers.ProbabilisticScheduler(solver="optimal")
    ref_plans = ref_scan.plans_from_batch(rb, ref_sch, parts_list, ref_cfgs)
    masks = [np.asarray(ref_scan._mask_stream(p.key, p.probs, p.mode, p.m))
             for p in ref_plans]
    plans = scan_engine.plans_from_batch(tb, sch, parts_list, cfgs, masks=masks)
    for i, (r, g) in enumerate(zip(ref_plans, plans)):
        for f in ("probs", "tx_time", "round_energy", "comp_time", "agg_weights"):
            np.testing.assert_allclose(np_(getattr(g, f)), np.asarray(getattr(r, f)),
                                       rtol=TIME_RTOL, atol=1e-7, err_msg=f)
        np.testing.assert_array_equal(np_(g.batch_idx), np.asarray(r.batch_idx))
        np.testing.assert_array_equal(np_(g.masks), masks[i])
        assert int(g.dataset_id) == int(r.dataset_id) == i
    ragged = scenarios.make_mixed_batch(["paper_static", "bandwidth_starved"],
                                        device="cpu")
    with pytest.raises(ValueError, match="uniform fleet size"):
        scan_engine.plans_from_batch(ragged, sch, parts_list, cfgs)


# ------------------------------------------------------------ entry points

def test_fleet_scale_rows(capsys):
    from repro_torch import fleet_scale
    fleet_scale.main(["--device", "cpu", "--scenario", "rayleigh_fading",
                      "--n", "300", "--batch", "3"])
    rows = [r for r in capsys.readouterr().out.splitlines() if "objective=" in r]
    assert len(rows) == 6 + 5
    assert all("feasible=True" in r and "[cpu]" in r for r in rows)
    objective = {r.split(":")[0].strip(): float(r.split("objective=")[1].split()[0])
                 for r in rows}
    assert objective["fused (flat element set)"] == pytest.approx(
        objective["per-instance python loop"], abs=SOLVE_TOL)
    assert objective["kernel (one launch)"] >= objective["fused kernel (one launch)"]


def test_paper_repro_writes_tables(tmp_path, monkeypatch, capsys):
    from repro_torch import paper_repro
    for name in ("HIGH_BIAS", "MILD_BIAS"):
        monkeypatch.setattr(paper_repro, name, dataclasses.replace(
            getattr(paper_repro, name), n_rounds=2, eval_every=2, n_runs=1,
            n_train=200, n_test=50, n_devices=8))
    paper_repro.main(["--device", "cpu", "--engine", "scan",
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("time/energy to accuracy") == 2
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "highly_biased.json", "mildly_biased.json"]
