"""Parity of the port's health boundary and warm starts with the JAX
reference.

The same numpy-seeded problems go through ``repro`` and ``repro_torch``
(on the CPU) in one process, data passed as numpy; the warm state is the
reference's own (``JointSolution.resume`` / ``BatchSolution.resume`` of a
reference solve), handed to the port through ``repro_torch.convert``.
Tolerances:

* the health mask, ``sanitize``'s leaves, ``validate``'s message and the
  selection flags (``a == 0``) exactly: masks and fills involve no
  arithmetic;
* ``element_warm_lambda`` at rtol 1e-6: one float32 ``log`` and a few
  products, where XLA's and torch's ``log`` may differ by an ulp;
* warm solves at 1e-5 on a* and on P* (as atol = rtol: P^min's
  ``expm1`` magnifies an ulp of a*, see ``tests/test_torch_core.py``),
  the reference's own solver tolerance;
* ``converged`` equal; outer ``n_iters`` and inner (Dinkelbach)
  iterations equal, except where a test names the knife edge.  A warm
  state seeds Dinkelbach's lambda only: a^0 is still eq. (13) at P^max
  in both packages (``repro.core.alternating``'s warm-start notes), so
  the first step's eq.-10 gate at P^min(a^0) = P^max is the knife edge
  that XLA's and torch's ``expm1`` can decide apart (``ROADMAP.md``
  queue 3).  Where it is (the bit menu's widths, the sanitised
  ``solve_joint``), the port may take one outer step more or fewer, and
  its inner count then differs by that step's iterations.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alternating as ref_alt
from repro.core import batch as ref_batch
from repro.core import power as ref_power
from repro.core import scenarios as ref_scenarios
from repro_torch.convert import problem_from_numpy, warm_start_from_numpy
from repro_torch.core import alternating, batch, power
from repro_torch.core.alternating import WarmStart

torch.set_num_threads(1)

TENSOR_FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j",
                 "dataset_size", "cycles_per_sample", "cpu_hz", "weights",
                 "fading", "interference", "bits")
CONSTANTS = ("grad_size_bits", "noise_power", "p_max", "tau_th", "kappa",
             "n_rounds")
SOLVE_TOL = 1e-5
LAM_RTOL = 1e-6


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_problem(ref):
    fields = {f: None if getattr(ref, f) is None else np.asarray(getattr(ref, f))
              for f in TENSOR_FIELDS}
    fields.update({c: getattr(ref, c) for c in CONSTANTS})
    return problem_from_numpy(fields, device="cpu")


def port_state(ref_state):
    return warm_start_from_numpy(np.asarray(ref_state.a),
                                 np.asarray(ref_state.power), device="cpu")


def assert_solution(ref, got):
    np.testing.assert_allclose(np_(got.a), np.asarray(ref.a),
                               atol=SOLVE_TOL, rtol=0)
    np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                               atol=SOLVE_TOL, rtol=SOLVE_TOL)
    np.testing.assert_array_equal(np_(got.a) == 0, np.asarray(ref.a) == 0)


def assert_counts(ref, got, knife_edge=False):
    np.testing.assert_array_equal(np.asarray(got.converged),
                                  np.asarray(ref.converged))
    iters = np.asarray(got.n_iters, np.int64)
    ref_iters = np.asarray(ref.n_iters, np.int64)
    if knife_edge and not np.array_equal(iters, ref_iters):
        assert np.all(np.abs(iters - ref_iters) <= 1)
        return
    np.testing.assert_array_equal(iters, ref_iters)
    np.testing.assert_array_equal(np.asarray(got.inner_iters, np.int64),
                                  np.asarray(ref.inner_iters, np.int64))


def _drifting(seed=0, n=16, k=4):
    return ref_scenarios.make_problem("drifting_metro", seed=seed,
                                      n_devices=n, n_rounds=k)


def _with(ref, **leaves):
    """``ref`` with some leaves replaced by float32 numpy arrays."""
    return dataclasses.replace(ref, **{f: jnp.asarray(np.asarray(v, np.float32))
                                       for f, v in leaves.items()})


def _leafy(seed):
    """A healthy drifting problem with interference and bits leaves."""
    return _with(_drifting(seed=seed),
                 interference=np.full((16,), 1e-12, np.float32),
                 bits=np.full((16, 4), 16.0, np.float32))


def _corrupted():
    """A drifting problem hit in every field the health mask reads."""
    ref = _drifting()
    fad = np.array(ref.fading, np.float32)
    fad[1, 0], fad[3, 2], fad[5, 1] = np.nan, np.inf, 0.0
    eb = np.array(ref.energy_budget_j, np.float32)
    eb[2] = -1.0
    bw = np.array(ref.bandwidth_hz, np.float32)
    bw[4] = 0.0
    d = np.array(ref.distance_m, np.float32)
    d[9] = np.inf
    itf = np.full((16,), 1e-12, np.float32)
    itf[11] = -1e-12
    bits = np.full((16, 4), 16.0, np.float32)
    bits[13, 3] = np.nan
    return _with(ref, fading=fad, energy_budget_j=eb, bandwidth_hz=bw,
                 distance_m=d, interference=itf, bits=bits)


# ----------------------------------------------------- the health boundary

@pytest.mark.parametrize("case", ["healthy", "corrupted", "stacked"])
def test_health_mask_sanitize_match_reference(case):
    if case == "healthy":
        ref = _drifting()
    elif case == "corrupted":
        ref = _corrupted()
    else:
        refs = [_corrupted(), _leafy(2)]
        ref = ref_batch.stack_problems(refs).problem
    got = port_problem(ref)
    want = np.asarray(ref.health_mask(xp=np))
    np.testing.assert_array_equal(got.health_mask(xp=np), want)
    np.testing.assert_array_equal(np_(got.health_mask()), want)
    assert isinstance(got.health_mask(xp=np), np.ndarray)
    ref_clean, ref_health = ref.sanitize()
    clean, health = got.sanitize()
    np.testing.assert_array_equal(np_(health), np.asarray(ref_health))
    for f in TENSOR_FIELDS:
        r, g = getattr(ref_clean, f), getattr(clean, f)
        assert (r is None) == (g is None), f
        if r is not None:
            assert g.dtype == torch.float32, f
            np.testing.assert_array_equal(np_(g), np.asarray(r), err_msg=f)
    # an explicit host mask, as the service passes it
    clean_np, _ = got.sanitize(health=want)
    np.testing.assert_array_equal(np_(clean_np.fading), np_(clean.fading))


def test_validate_matches_reference():
    ref, got = _corrupted(), port_problem(_corrupted())
    with pytest.raises(ValueError) as want:
        ref.validate()
    with pytest.raises(ValueError) as err:
        got.validate()
    assert str(err.value) == str(want.value)
    port_problem(_drifting()).validate()          # healthy: no raise


@pytest.mark.parametrize("solver", ["fused", "joint", "batch"])
def test_sanitized_solves_match_reference(solver):
    """``sanitize=True`` through every entry point: unhealthy devices
    deselect themselves (a* = P* = 0) in both packages, the rest agree."""
    ref, got = _corrupted(), port_problem(_corrupted())
    if solver == "fused":
        want = ref_alt.solve_joint_fused(ref, sanitize=True)
        sol = alternating.solve_joint_fused(got, sanitize=True)
    elif solver == "joint":
        want = ref_alt.solve_joint(ref.sanitize()[0])
        sol = alternating.solve_joint(got.sanitize()[0])
    else:
        refs = [_corrupted(), _leafy(2)]
        want = ref_batch.solve_joint_batch(ref_batch.stack_problems(refs),
                                           method="fused", sanitize=True)
        sol = batch.solve_joint_batch(
            batch.stack_problems([port_problem(p) for p in refs], device="cpu"),
            method="fused", sanitize=True)
    assert_solution(want, sol)
    # the global objective test: the knife edge at a^0 (module docstring)
    assert_counts(want, sol, knife_edge=solver == "joint")
    assert bool(torch.isfinite(sol.a).all() and torch.isfinite(sol.power).all())
    bad = ~got.health_mask()
    a = sol.a[0] if solver == "batch" else sol.a
    assert bool((a[bad] == 0).all())


# ------------------------------------------------------ the warm Dinkelbach

@pytest.mark.parametrize("seed", [0, 4])
def test_element_warm_lambda_matches_reference(seed):
    ref = _drifting(seed=seed)
    prev = ref_alt.solve_joint(ref_scenarios.slice_round(ref, 0))
    cur = ref_scenarios.slice_round(ref, 1)
    a0 = np.array(prev.a)
    p0 = np.array(prev.power)
    a0[:3] = 0.0                               # no previous state: cold
    p0[5] = 0.0
    pg = np.array(cur.path_gain())
    bw = np.array(cur.bandwidth_hz)[:, None]
    want = ref_power.element_warm_lambda(jnp.asarray(a0), jnp.asarray(p0),
                                         jnp.asarray(pg), jnp.asarray(bw),
                                         s_bits=cur.grad_size_bits)
    got = power.element_warm_lambda(
        torch.from_numpy(a0), torch.from_numpy(p0), torch.from_numpy(pg),
        torch.from_numpy(bw), s_bits=cur.grad_size_bits)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=LAM_RTOL, atol=0)
    assert bool((got[:3] == 1e-3).all()) and bool((got[5] == 1e-3).all())


# ------------------------------------------------------- warm Algorithm 2

def _warm_pair(seed=0):
    """The reference's round-0 solution and round 1 of the same cell."""
    ref = _drifting(seed=seed)
    r0, r1 = (ref_scenarios.slice_round(ref, k) for k in (0, 1))
    return r0, r1


@pytest.mark.parametrize("entry", ["solve_joint", "solve_joint_trace"])
def test_warm_solve_joint_matches_reference(entry):
    r0, r1 = _warm_pair()
    state = ref_alt.solve_joint(r0).resume
    ref_fn, fn = getattr(ref_alt, entry), getattr(alternating, entry)
    want = ref_fn(r1, init=state)
    got = fn(port_problem(r1), init=port_state(state))
    if entry == "solve_joint_trace":
        (want, ref_trace), (got, trace) = want, got
        np.testing.assert_allclose(trace, ref_trace, atol=SOLVE_TOL, rtol=0)
    assert_solution(want, got)
    assert_counts(want, got)
    cold = alternating.solve_joint(port_problem(r1))
    assert got.inner_iters < cold.inner_iters       # the warm-start claim
    np.testing.assert_array_equal(np_(got.a), np_(cold.a))


@pytest.mark.parametrize("power_solver", ["dinkelbach", "analytic"])
@pytest.mark.parametrize("chunk", [None, 24])
def test_warm_solve_joint_fused_matches_reference(power_solver, chunk):
    r0, r1 = _warm_pair(seed=3)
    state = ref_alt.solve_joint_fused(r0, power_solver=power_solver).resume
    kw = dict(power_solver=power_solver, chunk_elements=chunk)
    want = ref_alt.solve_joint_fused(r1, init=state, **kw)
    got = alternating.solve_joint_fused(port_problem(r1),
                                        init=port_state(state), **kw)
    assert_solution(want, got)
    assert_counts(want, got)
    cold = alternating.solve_joint_fused(port_problem(r1), **kw)
    if power_solver == "dinkelbach":
        assert got.inner_iters < cold.inner_iters
    else:
        assert got.inner_iters == cold.inner_iters == 0
        np.testing.assert_array_equal(np_(got.power), np_(cold.power))


def test_warm_fused_with_bit_menu_matches_reference():
    r0, r1 = _warm_pair(seed=5)
    kw = dict(power_solver="dinkelbach", bit_menu=(8, 16, 32))
    state = ref_alt.solve_joint_fused(r0, **kw).resume
    want = ref_alt.solve_joint_fused(r1, init=state, **kw)
    got = alternating.solve_joint_fused(port_problem(r1),
                                        init=port_state(state), **kw)
    assert_solution(want, got)
    # each width's first step meets the knife edge at a^0 (docstring)
    assert_counts(want, got, knife_edge=True)
    np.testing.assert_array_equal(np_(got.bits), np.asarray(want.bits))


def test_resume_and_tuple_init():
    got = port_problem(_warm_pair()[1])
    sol = alternating.solve_joint(got)
    state = sol.resume
    assert isinstance(state, WarmStart)
    assert state.a is sol.a and state.power is sol.power
    # a plain (a0, p0) pair of numpy arrays works like the NamedTuple
    pair = alternating.solve_joint(got, init=(np_(sol.a), np_(sol.power)))
    named = alternating.solve_joint(got, init=state)
    np.testing.assert_array_equal(np_(pair.a), np_(named.a))
    assert pair.inner_iters == named.inner_iters


# ------------------------------------------------------ batched warm starts

def _ragged_drift():
    """Three drifting cells of ragged size: round 0 and round 1."""
    cells = [_drifting(seed=s, n=n) for s, n in ((0, 12), (1, 16), (2, 9))]
    return ([ref_scenarios.slice_round(c, 0) for c in cells],
            [ref_scenarios.slice_round(c, 1) for c in cells])


@pytest.mark.parametrize("method,power_solver", [
    ("alternating", "dinkelbach"), ("alternating", "analytic"),
    ("fused", "dinkelbach"), ("fused", "analytic")])
def test_warm_solve_joint_batch_matches_reference(method, power_solver):
    rounds0, rounds1 = _ragged_drift()
    kw = dict(method=method, power_solver=power_solver)
    state = ref_batch.solve_joint_batch(ref_batch.stack_problems(rounds0),
                                        **kw).resume
    # instance 1 has no previous state: an all-zero row runs cold
    a0 = np.asarray(state.a).copy()
    p0 = np.asarray(state.power).copy()
    a0[1], p0[1] = 0.0, 0.0
    want = ref_batch.solve_joint_batch(ref_batch.stack_problems(rounds1),
                                       init=(jnp.asarray(a0), jnp.asarray(p0)),
                                       **kw)
    port1 = batch.stack_problems([port_problem(p) for p in rounds1],
                                 device="cpu")
    got = batch.solve_joint_batch(
        port1, init=warm_start_from_numpy(a0, p0, device="cpu"), **kw)
    assert_solution(want, got)
    assert_counts(want, got)
    cold = batch.solve_joint_batch(port1, **kw)
    np.testing.assert_array_equal(np_(got.a), np_(cold.a))
    if method == "alternating" and power_solver == "dinkelbach":
        # per instance: the zero row counts exactly cold, the others drop
        assert int(got.inner_iters[1]) == int(cold.inner_iters[1])
        assert int(got.inner_iters[0]) < int(cold.inner_iters[0])


def test_zero_init_is_exactly_cold():
    _, rounds1 = _ragged_drift()
    port1 = batch.stack_problems([port_problem(p) for p in rounds1],
                                 device="cpu")
    z = torch.zeros(port1.mask.shape + (1,))
    for method in ("alternating", "fused"):
        kw = dict(method=method, power_solver="dinkelbach")
        cold = batch.solve_joint_batch(port1, **kw)
        zero = batch.solve_joint_batch(port1, init=WarmStart(z, z), **kw)
        for f in ("a", "power", "objective", "n_iters", "converged"):
            np.testing.assert_array_equal(np_(getattr(zero, f)),
                                          np_(getattr(cold, f)), err_msg=f)
        np.testing.assert_array_equal(np.asarray(zero.inner_iters),
                                      np.asarray(cold.inner_iters))


@pytest.mark.parametrize("method", ["optimal", "kernel", "fused_kernel"])
def test_init_rejected_where_reference_rejects(method):
    refs = _ragged_drift()[1]
    ref_b = ref_batch.stack_problems(refs)
    port_b = batch.stack_problems([port_problem(p) for p in refs], device="cpu")
    z = np.zeros(tuple(ref_b.mask.shape) + (1,), np.float32)
    with pytest.raises(ValueError, match="init warm-starts") as want:
        ref_batch.solve_joint_batch(ref_b, method=method, init=(z, z))
    with pytest.raises(ValueError, match="init warm-starts") as err:
        batch.solve_joint_batch(port_b, method=method, init=(z, z))
    assert str(err.value) == str(want.value)


def test_batch_resume_is_the_padded_solution():
    refs = _ragged_drift()[0]
    port_b = batch.stack_problems([port_problem(p) for p in refs], device="cpu")
    sol = batch.solve_joint_batch(port_b, method="fused")
    assert isinstance(sol.resume, WarmStart)
    assert sol.resume.a is sol.a and sol.resume.power is sol.power
