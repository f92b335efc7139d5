"""Parity of the port's coupled metro solve (``core.multicell``) with the
JAX reference.

The registry's metros are drawn by both packages from the same seeds
(bit for bit, ``tests/test_torch_batch.py``) and solved on the CPU.
Tolerances:

* the host helpers (``_knapsack_round``, ``_backhaul_project``,
  ``cell_interference``) exactly on the same float64 inputs: they are
  the reference's numpy code;
* zero coupling with no budget: the port's ``solve_coupled`` equal to
  its own uncoupled batched ``fused`` solve bit for bit (the zero
  estimate is elided and the solver's arrays kept untouched);
* against the reference's ``solve_coupled``: a* and P* at 1e-5 (P* as
  atol = rtol), the solver tolerance; ``outer_iters``, ``converged`` and
  ``hit_iter_cap`` equal; the backhaul price exactly (the marginal
  device's float32 weight); the interference estimate and backhaul load
  at rtol 1e-4, float64 sums of a* P* over devices whose float32 a*
  carry the 1e-5 above; the residual within 1e-4 of the reference's, so
  the ``outer_tol`` = 1e-3 test decides alike;
* complementary slackness exactly: ``mu * (load - budget) == 0``.
"""
import numpy as np
import pytest
import torch

from repro.core import multicell as ref_mc
from repro.core import scenarios as ref_scenarios
from repro_torch.convert import coupled_duals_from_numpy
from repro_torch.core import batch, multicell, scenarios
from repro_torch.core.alternating import WarmStart

torch.set_num_threads(1)

SOLVE_TOL = 1e-5
SUM_RTOL = 1e-4
RESIDUAL_ATOL = 1e-4


def np_(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def metros(name, **kw):
    """The same registry metro from both packages."""
    return (ref_scenarios.make_problem(name, **kw),
            scenarios.make_problem(name, device="cpu", **kw))


# small draws of the two registry metros (the reference's own sizes cut
# to 4 cells for the CPU), and a fading metro with per-round duals
CASES = {
    "metro_coupled": dict(seed=0, n_cells=4, n_devices=24),
    "metro_coupled_no_budget": dict(seed=1, n_cells=4, n_devices=16,
                                    backhaul_bits=None,
                                    backhaul_fraction=None),
    "interference_grid": dict(seed=0, n_cells=4, n_devices=12),
    "metro_coupled_fading": dict(seed=2, n_cells=4, n_devices=12,
                                 with_fading=True, n_rounds=3),
}


def _case(name):
    kw = CASES[name]
    scenario = "interference_grid" if name == "interference_grid" \
        else "metro_coupled"
    return metros(scenario, **kw)


def assert_coupled(ref, got):
    np.testing.assert_allclose(np_(got.batch.a), np.asarray(ref.batch.a),
                               atol=SOLVE_TOL, rtol=0)
    np.testing.assert_allclose(np_(got.batch.power),
                               np.asarray(ref.batch.power),
                               atol=SOLVE_TOL, rtol=SOLVE_TOL)
    np.testing.assert_allclose(np_(got.batch.objective),
                               np.asarray(ref.batch.objective),
                               atol=SOLVE_TOL, rtol=0)
    assert got.outer_iters == ref.outer_iters
    assert got.converged == ref.converged
    assert got.hit_iter_cap == ref.hit_iter_cap
    np.testing.assert_array_equal(np.asarray(got.mu), np.asarray(ref.mu))
    np.testing.assert_allclose(got.interference, ref.interference,
                               rtol=SUM_RTOL, atol=0)
    np.testing.assert_allclose(got.backhaul_load, ref.backhaul_load,
                               rtol=SUM_RTOL, atol=0)
    assert abs(got.residual - ref.residual) <= RESIDUAL_ATOL


# ---------------------------------------------------------- host helpers

@pytest.mark.parametrize("budget_share", [0.4, 0.9, 2.0])
def test_knapsack_round_equals_reference(budget_share):
    rng = np.random.default_rng(int(budget_share * 10))
    caps = rng.uniform(0.0, 1.0, 64)
    caps[rng.integers(64, size=8)] = 0.0
    w = rng.uniform(0.0, 1.0, 64)
    w[:4] = w[4]                               # ties: the stable order
    s_bits = 6_374_720.0
    budget = budget_share * caps.sum() * s_bits
    want = ref_mc._knapsack_round(caps, w, s_bits, budget)
    got = multicell._knapsack_round(caps, w, s_bits, budget)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    a, mu, load = got
    assert mu * (load - budget) == 0.0       # complementary slackness


@pytest.mark.parametrize("shape,budget", [((4, 16), None), ((4, 16), 3e7),
                                          ((3, 8, 5), 2e7), ((3, 8, 5), None)])
def test_backhaul_project_and_interference_equal_reference(shape, budget):
    rng = np.random.default_rng(len(shape))
    a_cap = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    power = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    w = rng.uniform(0.0, 0.1, shape[:2])
    want = ref_mc._backhaul_project(a_cap, w, 6_374_720.0, budget)
    got = multicell._backhaul_project(a_cap, w, 6_374_720.0, budget)
    for r, g in zip(want, got):
        np.testing.assert_array_equal(g, r)
        assert np.asarray(g).dtype == np.asarray(r).dtype
    coupling = ref_mc.grid_coupling(shape[0], gain=1e-12)
    np.testing.assert_array_equal(
        multicell.cell_interference(coupling, got[0], power),
        ref_mc.cell_interference(coupling, want[0], power))


# ------------------------------------------------------------ the solve

def test_zero_coupling_bitwise_equals_uncoupled_fused():
    _, mc = metros("metro_coupled", seed=3, n_cells=4, n_devices=16,
                   backhaul_bits=None, backhaul_fraction=None,
                   coupling_gain=0.0)
    sol = multicell.solve_coupled(mc)
    plain = batch.solve_joint_batch(mc.cells, method="fused")
    assert sol.outer_iters == 1 and sol.converged and sol.residual == 0.0
    for f in ("a", "power", "objective", "n_iters", "converged", "mask"):
        np.testing.assert_array_equal(np_(getattr(sol.batch, f)),
                                      np_(getattr(plain, f)), err_msg=f)
    assert sol.batch.inner_iters == plain.inner_iters
    assert not sol.interference.any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_coupled_matches_reference(name):
    ref, got = _case(name)
    want = ref_mc.solve_coupled(ref)
    sol = multicell.solve_coupled(got)
    assert_coupled(want, sol)
    assert sol.converged


def test_iteration_cap_returns_best_iterate_like_reference():
    ref, got = _case("interference_grid")
    want = ref_mc.solve_coupled(ref, outer_iters=3)
    sol = multicell.solve_coupled(got, outer_iters=3)
    assert sol.hit_iter_cap and not sol.converged
    assert_coupled(want, sol)


def test_backhaul_slackness_is_exact():
    _, mc = _case("metro_coupled")
    sol = multicell.solve_coupled(mc)
    budget = mc.backhaul_bits
    assert float(sol.mu) > 0.0
    assert float(sol.mu) * (float(sol.backhaul_load) - budget) == 0.0
    assert float(sol.backhaul_load) == budget
    # the budget binds: the uncoupled demand exceeds it
    plain = batch.solve_joint_batch(mc.cells, method="fused")
    assert float(plain.a.double().sum()) * mc.cells.problem.grad_size_bits \
        > budget


def test_solve_coupled_loop_matches_reference_and_union():
    ref, got = _case("metro_coupled_no_budget")
    want = ref_mc.solve_coupled_loop(ref)
    sol = multicell.solve_coupled_loop(got)
    assert_coupled(want, sol)
    union = multicell.solve_coupled(got)
    np.testing.assert_allclose(np_(union.batch.a), np_(sol.batch.a),
                               atol=SOLVE_TOL, rtol=0)


def test_pad_metro_matches_reference_and_is_transparent():
    ref, got = _case("interference_grid")
    want = ref_mc.pad_metro(ref, n_cells=8, n_max=16)
    padded = multicell.pad_metro(got, n_cells=8, n_max=16)
    np.testing.assert_array_equal(np_(padded.coupling), np.asarray(want.coupling))
    np.testing.assert_array_equal(np_(padded.cells.mask), np.asarray(want.cells.mask))
    assert multicell.pad_metro(got) is got
    sol = multicell.solve_coupled(padded)
    plain = multicell.solve_coupled(got)
    np.testing.assert_allclose(np_(sol.batch.a)[:4, :12], np_(plain.batch.a),
                               atol=SOLVE_TOL, rtol=0)
    assert not np_(sol.batch.a)[4:].any() and not np_(sol.batch.a)[:, 12:].any()


# ------------------------------------------------------------ warm duals

@pytest.mark.parametrize("name", ["metro_coupled", "interference_grid"])
def test_warm_duals_from_the_reference_match_and_take_fewer_steps(name):
    """The reference's converged duals, carried into the port through
    ``convert``, warm-start both packages alike, and the warm tick takes
    fewer outer steps than the cold one."""
    ref, got = _case(name)
    cold_ref = ref_mc.solve_coupled(ref)
    state = cold_ref.resume
    want = ref_mc.solve_coupled(ref, init=state)
    init = coupled_duals_from_numpy(
        state.interference, state.mu, np.asarray(state.warm.a),
        np.asarray(state.warm.power), device="cpu")
    sol = multicell.solve_coupled(got, init=init)
    assert_coupled(want, sol)
    cold = multicell.solve_coupled(got)
    assert sol.outer_iters < cold.outer_iters
    own = multicell.solve_coupled(got, init=cold.resume)
    assert own.outer_iters < cold.outer_iters


def test_resume_and_mismatched_state():
    _, got = _case("metro_coupled")
    cold = multicell.solve_coupled(got)
    state = cold.resume
    assert isinstance(state, multicell.CoupledDuals)
    assert isinstance(state.warm, WarmStart)
    assert state.warm.a is cold.batch.a
    # state of another metro shape is ignored: a cold start
    wrong = multicell.CoupledDuals(interference=np.ones(7), mu=np.ones(3),
                                   warm=WarmStart(torch.ones(7, 2),
                                                  torch.ones(7, 2)))
    again = multicell.solve_coupled(got, init=wrong)
    assert again.outer_iters == cold.outer_iters
    np.testing.assert_array_equal(np_(again.batch.a), np_(cold.batch.a))
