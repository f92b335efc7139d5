"""The port's kernels: plain versions against the reference, wrappers.

On the CPU the wrappers run the kernels' plain PyTorch versions (``ref.py``),
which are held against the reference's oracles (``repro.kernels.*.ref``)
at the tolerances ``tests/test_kernels.py`` uses for kernel vs oracle:
a* at rtol 1e-6 / atol 1e-7, P* at rtol 1e-5 / atol 1e-8 (P^min turns an
ulp of a into up to ~80 ulps of P), and the aggregate at 1e-5 (summation
order: the reference's einsum, the port's clients in order).  The drop-in
solvers are held against ``solve_joint`` / ``solve_joint_optimal`` at
<= 1e-5, the reference's own solver tolerance.

The CUDA kernels themselves are tested in ``tests/test_torch_cuda.py``
(which skips without a card) and by ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alternating as ref_alt
from repro.core import optimal as ref_opt
from repro.core import problem as ref_problem
from repro.kernels.masked_aggregate import ops as ref_agg_ops
from repro.kernels.masked_aggregate import ref as ref_agg
from repro.kernels.selection_solve import ops as ref_solve_ops
from repro.kernels.selection_solve import ref as ref_solve
from repro_torch.convert import problem_from_numpy
from repro_torch.core import problem
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.masked_aggregate import ops as agg_ops
from repro_torch.kernels.masked_aggregate import ref as agg_ref
from repro_torch.kernels.selection_solve import ops as solve_ops
from repro_torch.kernels.selection_solve import ref as solve_ref

torch.set_num_threads(1)

KW = dict(s_bits=6.4e6, tau=0.08, p_max=1.0)
A_TOL = dict(rtol=1e-6, atol=1e-7)
P_TOL = dict(rtol=1e-5, atol=1e-8)
AGG_TOL = dict(rtol=1e-5, atol=1e-5)
SOLVE_TOL = 1e-5


def np_(x):
    return x.detach().cpu().numpy()


def _operands(seed, m=2):
    """The reference kernel tests' operand distributions, [m, 128] f32."""
    rng = np.random.default_rng(seed)
    pg = rng.uniform(1e4, 1e8, (m, 128))
    bw = rng.uniform(5e4, 5e6, (m, 128))
    emax = np.exp(rng.uniform(-7, 4, (m, 128)))
    ec = np.exp(rng.uniform(-8, -2, (m, 128)))
    return [x.astype(np.float32) for x in (pg, bw, emax, ec)]


def _port_problem(ref):
    fields = {f.name: getattr(ref, f.name)
              for f in ref.__dataclass_fields__.values()}
    return problem_from_numpy(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in fields.items()}, device="cpu")


# ------------------------------------------------------- plain versions

@pytest.mark.parametrize("seed", [1, 2])
def test_selection_solve_plain_matches_reference_oracle(seed):
    ops = _operands(seed)
    a_r, p_r = ref_solve.selection_solve_ref(*map(jnp.asarray, ops), **KW)
    a, p = solve_ref.selection_solve_ref(*map(torch.from_numpy, ops), **KW)
    np.testing.assert_allclose(np_(a), np.asarray(a_r), **A_TOL)
    np.testing.assert_allclose(np_(p), np.asarray(p_r), **P_TOL)


@pytest.mark.parametrize("seed,typo,n_iters", [(3, False, 50), (4, False, 7),
                                               (5, True, 50)])
def test_fused_solve_plain_matches_reference_oracle(seed, typo, n_iters):
    ops = _operands(seed)
    a_r, p_r = ref_solve.fused_solve_ref(*map(jnp.asarray, ops), **KW,
                                         n_iters=n_iters,
                                         faithful_eq13_typo=typo)
    a, p = solve_ref.fused_solve_ref(*map(torch.from_numpy, ops), **KW,
                                     n_iters=n_iters, faithful_eq13_typo=typo)
    np.testing.assert_allclose(np_(a), np.asarray(a_r), **A_TOL)
    np.testing.assert_allclose(np_(p), np.asarray(p_r), **P_TOL)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    before = dict(cuda_lib.LAUNCHES)
    ops = [torch.from_numpy(x.reshape(-1)[:77].copy()) for x in _operands(6)]
    a, p = solve_ops.fused_solve(*ops, **KW)
    a_r, p_r = solve_ref.fused_solve_ref(*ops, **KW)
    assert torch.equal(a, a_r) and torch.equal(p, p_r)
    a, p = solve_ops.selection_solve(*ops, **KW)
    a_r, p_r = solve_ref.selection_solve_ref(*ops, **KW)
    assert torch.equal(a, a_r) and torch.equal(p, p_r)
    g = torch.randn(2, 5, 33, generator=torch.Generator().manual_seed(0))
    coef = torch.rand(2, 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(agg_ops.masked_aggregate_batched(g, coef),
                       agg_ref.masked_aggregate_ref(g, coef))
    assert cuda_lib.LAUNCHES == before          # nothing launched, nothing built


# ------------------------------------------------------------ drop-ins

@pytest.mark.parametrize("case", [dict(seed=6, n=100),
                                  dict(seed=2, n=40, with_fading=True,
                                       n_rounds=5)],
                         ids=["static", "fading"])
def test_fused_kernel_solver_matches_reference(case):
    case = dict(case)
    ref_p = ref_problem.sample_problem(case.pop("seed"), case.pop("n"), **case)
    got_p = _port_problem(ref_p)
    got = solve_ops.solve_joint_fused_kernel(got_p)
    assert tuple(got.a.shape) == tuple(ref_p.path_gain().shape)
    for ref in (ref_solve_ops.solve_joint_fused_kernel(ref_p, interpret=True),
                ref_alt.solve_joint(ref_p)):
        np.testing.assert_allclose(np_(got.a), np.asarray(ref.a),
                                   atol=SOLVE_TOL, rtol=0)
        np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                                   atol=SOLVE_TOL, rtol=SOLVE_TOL)
    assert bool(got_p.constraints_satisfied(got.a, got.power, rtol=1e-3).all())


def test_selection_kernel_solver_matches_reference():
    ref_p = ref_problem.sample_problem(5, 100)
    got_p = _port_problem(ref_p)
    got = solve_ops.solve_joint_kernel(got_p)
    for ref in (ref_solve_ops.solve_joint_kernel(ref_p, interpret=True),
                ref_opt.solve_joint_optimal(ref_p)):
        np.testing.assert_allclose(np_(got.a), np.asarray(ref.a),
                                   atol=SOLVE_TOL, rtol=0)
        np.testing.assert_allclose(np_(got.power), np.asarray(ref.power),
                                   atol=SOLVE_TOL, rtol=SOLVE_TOL)
    assert got.n_iters == 60
    assert bool(got_p.constraints_satisfied(got.a, got.power).all())


def test_kernel_solvers_refuse_a_bits_leaf():
    p = problem.sample_problem(0, 8, device="cpu")
    p = dataclasses.replace(p, bits=torch.full((8,), 8.0))
    for solve in (solve_ops.solve_joint_kernel, solve_ops.solve_joint_fused_kernel):
        with pytest.raises(ValueError, match="bits"):
            solve(p)


# ----------------------------------------------------------- aggregate

@pytest.mark.parametrize("n,d", [(8, 33), (64, 512), (100, 249)])
def test_masked_aggregate_plain_matches_reference_oracle(n, d):
    rng = np.random.default_rng(n + d)
    g = rng.normal(size=(2, n, d)).astype(np.float32)
    coef = (rng.uniform(0, 1, (2, n)) * (rng.random((2, n)) > 0.5)).astype(np.float32)
    got = agg_ref.masked_aggregate_ref(torch.from_numpy(g), torch.from_numpy(coef))
    for t in range(2):
        ref = ref_agg.masked_aggregate_ref(jnp.asarray(g[t]), jnp.asarray(coef[t]))
        np.testing.assert_allclose(np_(got[t]), np.asarray(ref), **AGG_TOL)


def test_masked_aggregate_pytree_matches_reference_wrapper():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(10, 33, 7)).astype(np.float32),
            "b": rng.normal(size=(10, 5)).astype(np.float32)}
    coef = rng.uniform(0, 1, 10).astype(np.float32)
    ref = ref_agg_ops.masked_aggregate_pytree(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(coef),
        interpret=True)
    got = agg_ops.masked_aggregate_pytree(
        {k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(coef))
    for k in tree:
        assert tuple(got[k].shape) == tree[k].shape[1:]
        np.testing.assert_allclose(np_(got[k]), np.asarray(ref[k]), **AGG_TOL)


def test_masked_aggregate_trajectory_axis_is_per_trajectory():
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(3, 6, 4, 5, generator=gen)
    coef = torch.rand(3, 6, generator=gen)
    out = agg_ops.masked_aggregate(g, coef)
    assert tuple(out.shape) == (3, 4, 5)
    for t in range(3):
        assert torch.equal(out[t], agg_ops.masked_aggregate(g[t], coef[t]))
    with pytest.raises(ValueError, match="T, N, D"):
        agg_ops.masked_aggregate_batched(g[0], coef)
