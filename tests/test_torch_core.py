"""Parity of the port's core and data modules with the JAX reference.

The same inputs, made from numpy seeds, go through ``repro`` and
``repro_torch`` (on the CPU) in one process.  Tolerances:

* numpy draws (``sample_problem``, the datasets, the partitions) are
  compared bit for bit: both packages run the same numpy code;
* closed forms at rtol 1e-6: the two evaluate the same float32
  operations in the same order, and differ only where XLA's ``expm1`` and
  ``log`` differ from torch's (a few ulps), and XLA on the CPU flushes
  subnormal results to zero where torch keeps them (atol: the smallest
  normal float32);
* solves at <= 1e-5 on a*, P* and the objective, the reference's own
  solver tolerance (P^min amplifies an ulp of a by up to ~80x through its
  exponent).  Solves are held against the *unchunked* reference.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alternating as ref_alt
from repro.core import optimal as ref_opt
from repro.core import power as ref_power
from repro.core import problem as ref_problem
from repro.core import schedulers as ref_sched
from repro.core import selection as ref_sel
from repro.data import partition as ref_partition
from repro.data import synthetic as ref_synthetic
from repro_torch.convert import problem_from_numpy
from repro_torch.core import alternating, optimal, power, problem, schedulers, selection
from repro_torch.data import partition, synthetic

torch.set_num_threads(1)

TENSOR_FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j",
                 "dataset_size", "cycles_per_sample", "cpu_hz", "weights",
                 "fading", "interference", "bits")
CONSTANTS = ("grad_size_bits", "noise_power", "p_max", "tau_th", "kappa",
             "n_rounds")
SOLVE_TOL = 1e-5
TINY = float(np.finfo(np.float32).tiny)


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def t_(x):
    return torch.from_numpy(np.array(x, np.float32))


def port_problem(ref):
    """The reference problem's fields, through numpy, as a port problem."""
    fields = {f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
              for f in TENSOR_FIELDS}
    fields.update({c: getattr(ref, c) for c in CONSTANTS})
    return problem_from_numpy(fields, device="cpu")


def assert_close(ref, port, rtol=1e-6, atol=TINY):
    np.testing.assert_allclose(np_(port), np.asarray(ref), rtol=rtol, atol=atol)


# ------------------------------------------------------------- numpy draws

@pytest.mark.parametrize("seed,with_fading", [(0, False), (3, True), (11, False)])
def test_sample_problem_bitwise(seed, with_fading):
    ref = ref_problem.sample_problem(seed, 24, with_fading=with_fading,
                                     n_rounds=5, tau_th=0.5)
    got = problem.sample_problem(seed, 24, with_fading=with_fading,
                                 n_rounds=5, tau_th=0.5, device="cpu")
    for f in TENSOR_FIELDS:
        r, g = getattr(ref, f), getattr(got, f)
        assert (r is None) == (g is None), f
        if r is not None:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(np_(g), np.asarray(r), err_msg=f)
    for c in CONSTANTS:
        assert getattr(ref, c) == getattr(got, c)


def test_sample_problem_dirichlet_sizes_bitwise():
    sizes = np.random.default_rng(4).integers(10, 500, 16)
    ref = ref_problem.sample_problem(2, 16, dirichlet_sizes=sizes)
    got = problem.sample_problem(2, 16, dirichlet_sizes=sizes, device="cpu")
    for f in ("dataset_size", "weights", "energy_budget_j", "cpu_hz"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))


def test_datasets_and_partition_bitwise():
    ref_train, ref_test = ref_synthetic.make_mnist_like(120, 40, seed=5)
    train, test = synthetic.make_mnist_like(120, 40, seed=5)
    for r, g in ((ref_train, train), (ref_test, test)):
        np.testing.assert_array_equal(g.images, r.images)
        np.testing.assert_array_equal(g.labels, r.labels)
        assert g.images.dtype == r.images.dtype and g.labels.dtype == r.labels.dtype
    for beta in (0.1, 0.3):
        ref_parts = ref_partition.dirichlet_partition(ref_train, 8, beta, seed=6)
        parts = partition.dirichlet_partition(train, 8, beta, seed=6)
        assert len(parts) == len(ref_parts)
        for r, g in zip(ref_parts, parts):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(
            partition.label_distribution(train, parts),
            ref_partition.label_distribution(ref_train, ref_parts))


# ---------------------------------------------------- problem and its ranks

N, K = 12, 4


def _leaf_problem(fading, interference, bits):
    """A reference problem with optional leaves of the given ranks."""
    rng = np.random.default_rng(hash((fading, interference, bits)) % 2**32)
    base = ref_problem.sample_problem(7, N, n_rounds=K, tau_th=0.3)

    def leaf(rank, lo, hi):
        if rank is None:
            return None
        shape = (N,) if rank == 1 else (N, K)
        return jnp.asarray(rng.uniform(lo, hi, shape), jnp.float32)

    return dataclasses.replace(base, fading=leaf(fading, 0.2, 3.0),
                               interference=leaf(interference, 0.0, 1e-11),
                               bits=leaf(bits, 4.0, 32.0))


# (fading, interference, bits) ranks; rank-2 interference/bits need fading
LEAF_RANKS = [(None, None, None), (2, None, None), (1, None, None),
              (None, 1, None), (2, 2, None), (2, 1, 2), (None, None, 1),
              (2, None, 2), (2, 2, 1)]


@pytest.mark.parametrize("ranks", LEAF_RANKS, ids=str)
def test_problem_methods_match_reference(ranks):
    ref = _leaf_problem(*ranks)
    got = port_problem(ref)
    rng = np.random.default_rng(1)
    assert_close(ref.path_gain(), got.path_gain())
    assert_close(ref.compute_energy(), got.compute_energy())
    for shape in ((N,), (N, K)):
        a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        pw = rng.uniform(0.0, 1.0, shape).astype(np.float32)
        assert_close(ref.p_min(jnp.asarray(a)), got.p_min(t_(a)))
        assert_close(ref.rate(jnp.asarray(pw)), got.rate(t_(pw)))
        assert_close(ref.tx_time(jnp.asarray(pw)), got.tx_time(t_(pw)))
        assert_close(ref.upload_energy(jnp.asarray(pw)),
                     got.upload_energy(t_(pw)))
        assert_close(ref.objective(jnp.asarray(a)), got.objective(t_(a)))
        np.testing.assert_array_equal(
            np_(got.constraints_satisfied(t_(a), t_(pw))),
            np.asarray(ref.constraints_satisfied(jnp.asarray(a),
                                                 jnp.asarray(pw))))
    if ref.bits is None:
        assert got.payload_bits() == ref.payload_bits() == ref_problem.GRAD_SIZE_BITS_FP32
    else:
        assert_close(ref.payload_bits(2), got.payload_bits(2))


def test_bcast_like_contract():
    x = torch.arange(3.0)
    assert problem._bcast_like(x, 1) is x
    assert tuple(problem._bcast_like(x, 2).shape) == (3, 1)
    assert problem.GRAD_SIZE_BITS_FP32 == ref_problem.GRAD_SIZE_BITS_FP32


def test_div_is_the_correctly_rounded_quotient():
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.1, 10, 4096)
                         .astype(np.float32))
    np.testing.assert_array_equal(np_(problem.div(3.7, x)),
                                  np.float32(3.7) / np_(x))
    np.testing.assert_array_equal(np_(problem.div(x, 0.3)),
                                  np_(x) / np.float32(0.3))


# ------------------------------------------------------------- closed forms

def _elements(seed, n=512):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, n).astype(np.float32)
    a[:8] = 0.0
    pg = rng.uniform(1e4, 1e8, n).astype(np.float32)
    pg[8:12] = 0.0                                   # gated-out devices
    bw = rng.uniform(5e4, 5e6, n).astype(np.float32)
    emax = np.exp(rng.uniform(-7, 4, n)).astype(np.float32)
    ec = np.exp(rng.uniform(-8, -2, n)).astype(np.float32)
    power_ = rng.uniform(0, 1, n).astype(np.float32)
    return a, pg, bw, emax, ec, power_


KW = dict(s_bits=6.4e6, tau=0.08)


def test_element_closed_forms_match_reference():
    a, pg, bw, emax, ec, pw = _elements(0)
    j, t = (lambda *xs: [jnp.asarray(x) for x in xs]), (lambda *xs: [t_(x) for x in xs])
    assert_close(ref_power.element_p_min(*j(a, pg, bw), **KW),
                 power.element_p_min(*t(a, pg, bw), **KW))
    assert_close(ref_power.element_tx_time(*j(pw, pg, bw), s_bits=6.4e6),
                 power.element_tx_time(*t(pw, pg, bw), s_bits=6.4e6))
    for r, g in zip(ref_power.analytic_power_elements(*j(a, pg, bw), p_max=1.0, **KW),
                    power.analytic_power_elements(*t(a, pg, bw), p_max=1.0, **KW)):
        assert_close(r, g)
    rp, rl, ri, rf = ref_power.dinkelbach_power_elements(*j(a, pg, bw), p_max=1.0, **KW)
    gp, gl, gi, gf = power.dinkelbach_power_elements(*t(a, pg, bw), p_max=1.0, **KW)
    assert_close(rp, gp, rtol=1e-5)
    assert_close(rl, gl, rtol=1e-5)
    np.testing.assert_array_equal(np_(gf), np.asarray(rf))
    assert abs(int(ri) - gi) <= 1
    lam = (pw * 0.01).astype(np.float32)
    np.testing.assert_array_equal(
        np_(power.energy_gate_elements(*t(a, lam, emax, ec))),
        np.asarray(ref_power.energy_gate_elements(*j(a, lam, emax, ec))))
    tx = np.asarray(ref_power.element_tx_time(*j(pw, pg, bw), s_bits=6.4e6))
    for typo in (False, True):
        assert_close(
            ref_sel.selection_update_elements(*j(pw, tx, emax, ec), tau=0.08,
                                              s_bits=6.4e6,
                                              faithful_eq13_typo=typo),
            selection.selection_update_elements(*t(pw, tx, emax, ec), tau=0.08,
                                                s_bits=6.4e6,
                                                faithful_eq13_typo=typo))


def test_p_min_gate_and_clamp():
    got = power.element_p_min(t_([0.0, 0.5, 2.0]), t_([0.0, float("nan"), 1.0]),
                              t_([1.0, 1.0, 1.0]), s_bits=100.0, tau=1.0)
    assert np.isinf(np_(got)[0]) and np.isinf(np_(got)[1])
    np.testing.assert_allclose(np_(got)[2], 2.0 ** 120, rtol=1e-5)


# the N=3 oracles of tests/test_golden_closed_forms.py (S = 100 bits,
# tau = 1 s, P^max = 1 W), hand-derived there from the paper's equations
S_BITS, TAU, P_MAX = 100.0, 1.0, 1.0
A3, PG3, BW3 = t_([0.5, 1.0, 0.0]), t_([3.0, 1.0, 2.0]), t_([100.0, 10.0, 50.0])
P_MIN_GOLD = [0.13807118745769837, 1023.0, 0.0]
P_GOLD = [0.13807118745769837, 1.0, 0.0]
LAM_GOLD = [0.13807118745769837, 10.0, 0.0]
FEAS_GOLD = [True, False, True]


def test_golden_power_oracles():
    np.testing.assert_allclose(
        np_(power.element_p_min(A3, PG3, BW3, s_bits=S_BITS, tau=TAU)),
        P_MIN_GOLD, rtol=1e-5)
    np.testing.assert_allclose(
        np_(power.element_tx_time(t_(3.0), t_(1.0), t_(25.0), s_bits=S_BITS)),
        2.0, rtol=1e-6)
    p, lam, feas = power.analytic_power_elements(A3, PG3, BW3, s_bits=S_BITS,
                                                 tau=TAU, p_max=P_MAX)
    np.testing.assert_allclose(np_(p), P_GOLD, rtol=1e-5)
    np.testing.assert_allclose(np_(lam), LAM_GOLD, rtol=1e-5)
    np.testing.assert_array_equal(np_(feas), FEAS_GOLD)
    p, lam, iters, feas = power.dinkelbach_power_elements(
        A3, PG3, BW3, s_bits=S_BITS, tau=TAU, p_max=P_MAX)
    np.testing.assert_allclose(np_(p), P_GOLD, rtol=1e-4)
    np.testing.assert_allclose(np_(lam), LAM_GOLD, rtol=1e-4)
    np.testing.assert_array_equal(np_(feas), FEAS_GOLD)
    assert 0 < iters <= 64


def test_golden_selection_and_gate_oracles():
    p, tx = t_([0.5, 1.0, 0.1, 0.0]), t_([4.0, 0.5, 0.1, 1.0])
    emax, ec = t_([10.0, 0.3, 100.0, 1.0]), t_([1.0, 0.1, 1.0, 0.1])
    np.testing.assert_allclose(
        np_(selection.selection_update_elements(p, tx, emax, ec, tau=TAU,
                                                s_bits=S_BITS)),
        [0.25, 0.5, 1.0, 0.0], rtol=1e-6)
    np.testing.assert_allclose(
        np_(selection.selection_update_elements(p, tx, emax, ec, tau=TAU,
                                                s_bits=S_BITS,
                                                faithful_eq13_typo=True)),
        [0.0025, 0.02, 0.1, 0.0], rtol=1e-6)
    np.testing.assert_array_equal(
        np_(power.energy_gate_elements(t_([0.5] * 3), t_([0.2, 0.6, 0.5]),
                                       t_([1.0] * 3), t_([1.0] * 3))),
        [True, False, True])


# ------------------------------------------------------------------ solvers

def _assert_solution(ref, got, tol=SOLVE_TOL):
    np.testing.assert_allclose(np_(got.a), np.asarray(ref.a), atol=tol, rtol=0)
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(got.objective), float(ref.objective),
                               atol=tol, rtol=0)


SOLVE_CASES = [dict(seed=5, n=100), dict(seed=9, n=64, tau_th=0.5),
               dict(seed=2, n=20, with_fading=True, n_rounds=3)]


@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda c: f"seed{c['seed']}")
def test_solve_joint_matches_reference(case):
    case = dict(case)
    ref_p = ref_problem.sample_problem(case.pop("seed"), case.pop("n"), **case)
    got_p = port_problem(ref_p)
    for power_solver in ("dinkelbach", "analytic"):
        ref = ref_alt.solve_joint(ref_p, power_solver=power_solver)
        got = alternating.solve_joint(got_p, power_solver=power_solver)
        _assert_solution(ref, got)
        assert got.converged == bool(ref.converged)
        assert abs(got.n_iters - int(ref.n_iters)) <= 1


@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda c: f"seed{c['seed']}")
def test_solve_joint_fused_and_optimal_match_reference(case):
    case = dict(case)
    ref_p = ref_problem.sample_problem(case.pop("seed"), case.pop("n"), **case)
    got_p = port_problem(ref_p)
    _assert_solution(ref_alt.solve_joint_fused(ref_p),
                     alternating.solve_joint_fused(got_p))
    _assert_solution(ref_alt.solve_joint(ref_p),
                     alternating.solve_joint_fused(got_p))
    ref_o, got_o = ref_opt.solve_joint_optimal(ref_p), optimal.solve_joint_optimal(got_p)
    _assert_solution(ref_o, got_o)
    assert bool(got_p.constraints_satisfied(got_o.a, got_o.power).all())


def test_solve_joint_trace_and_typo_match_reference():
    ref_p = ref_problem.sample_problem(4, 30, tau_th=0.3)
    got_p = port_problem(ref_p)
    ref, ref_trace = ref_alt.solve_joint_trace(ref_p)
    got, trace = alternating.solve_joint_trace(got_p)
    _assert_solution(ref, got)
    np.testing.assert_allclose(trace, ref_trace, atol=SOLVE_TOL)
    assert got.n_iters == alternating.solve_joint(got_p).n_iters
    # the printed eq. (13) collapses a toward 0, where Dinkelbach's inner
    # loop ends at max_iters unconverged; the closed-form power has no
    # inner loop, so the typo path is compared with it
    kw = dict(faithful_eq13_typo=True, power_solver="analytic")
    _assert_solution(ref_alt.solve_joint(ref_p, **kw),
                     alternating.solve_joint(got_p, **kw))


def test_fused_chunked_path_matches_reference_chunked():
    ref_p = ref_problem.sample_problem(8, 50, tau_th=0.5)
    got_p = port_problem(ref_p)
    ref = ref_alt.solve_joint_fused(ref_p, chunk_elements=16)
    got = alternating.solve_joint_fused(got_p, chunk_elements=16)
    _assert_solution(ref, got)
    assert got.n_iters == int(ref.n_iters)
    flat = alternating.solve_joint_fused(got_p, shard=True)
    _assert_solution(ref_alt.solve_joint_fused(ref_p), flat)


def test_unported_options_raise():
    p = problem.sample_problem(0, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="bit_menu"):
        alternating.solve_joint_fused(p, bit_menu=(8, 32))
    with pytest.raises(NotImplementedError, match="init"):
        alternating.solve_joint(p, init=(p.weights, p.weights))
    with pytest.raises(NotImplementedError, match="sanitize"):
        alternating.solve_joint_fused(p, sanitize=True)
    with pytest.raises(ValueError, match="one device"):
        alternating.solve_joint_fused(p, mesh=object())
    with pytest.raises(ValueError, match="per_round"):
        alternating.solve_joint(problem.sample_problem(0, 8, with_fading=True,
                                                       n_rounds=2, device="cpu"),
                                per_round=False)


def test_no_cuda_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        problem.sample_problem(0, 8)


# --------------------------------------------------------------- schedulers

@pytest.mark.parametrize("name", ["probabilistic", "deterministic",
                                  "uniform", "equally_weighted"])
def test_scheduler_states_match_reference(name):
    ref_p = ref_problem.sample_problem(3, 40, tau_th=0.5)
    got_p = port_problem(ref_p)
    kw = {"m": 7} if name == "uniform" else {}
    ref = ref_sched.make_scheduler(name, **kw).precompute(ref_p)
    got = schedulers.make_scheduler(name, **kw).precompute(got_p)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np_(g), np.asarray(r), atol=SOLVE_TOL,
                                   rtol=SOLVE_TOL)
    if name in ("deterministic", "equally_weighted"):
        np.testing.assert_array_equal(np_(got.a), np.asarray(ref.a))


def test_round_preserving_count_ties_match_reference():
    a = np.array([0.3, 0.3, 0.0, 0.3, 0.1, 0.0, 0.3, 0.2], np.float32)
    np.testing.assert_array_equal(
        np_(schedulers._round_preserving_count(t_(a))),
        np.asarray(ref_sched._round_preserving_count(jnp.asarray(a))))
    a2 = np.random.default_rng(0).uniform(0, 0.4, (8, 3)).astype(np.float32)
    for per_round in (False, True):
        np.testing.assert_array_equal(
            np_(schedulers._round_preserving_count(t_(a2), per_round=per_round)),
            np.asarray(ref_sched._round_preserving_count(jnp.asarray(a2),
                                                         per_round=per_round)))


def test_scheduler_draws_follow_the_generator():
    p = problem.sample_problem(1, 30, device="cpu")
    prob = schedulers.ProbabilisticScheduler()
    st = prob.precompute(p)
    d1 = prob.sample(st, torch.Generator().manual_seed(4))
    d2 = prob.sample(st, torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(np_(d1.mask), np_(d2.mask))
    uni = schedulers.UniformScheduler(m=6)
    draw = uni.sample(uni.precompute(p), torch.Generator().manual_seed(0))
    assert int(draw.mask.sum()) == 6
    with pytest.raises(ValueError, match="greedy_channel"):
        schedulers.make_scheduler("lyapunov")
