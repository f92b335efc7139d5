"""The port's CUDA kernels on the card: each against its plain version.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode).  The file imports torch and ``repro_torch`` only, so
it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: the kernels compute in float32 with the plain versions'
operation order and no FMA contraction, so they are expected to match
bit for bit; the checks allow 1e-5 (the reference's solver tolerance)
on a* and P*, and exact equality for the eq.-4 sums, whose order of
addition is the same.  The drop-in solvers are held against the plain
``solve_joint`` / ``solve_joint_optimal`` at 1e-5.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.alternating import solve_joint
from repro_torch.core.optimal import solve_joint_optimal
from repro_torch.core.problem import sample_problem
from repro_torch.fl import experiments
from repro_torch.fl.scan_engine import init_sweep_params, run_fl_sweep, stack_plans
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.masked_aggregate import ops as agg_ops
from repro_torch.kernels.masked_aggregate import ref as agg_ref
from repro_torch.kernels.selection_solve import ops as solve_ops
from repro_torch.kernels.selection_solve import ref as solve_ref
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

SOLVE_TOL = 1e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _elements(n, tau, seed, dev):
    p = sample_problem(seed, n, tau_th=tau, device=dev)
    els = [x.contiguous() for x in (p.path_gain(), p.bandwidth_hz,
                                    p.energy_budget_j, p.compute_energy())]
    return els, dict(s_bits=p.grad_size_bits, tau=p.tau_th, p_max=p.p_max)


@pytest.mark.parametrize("n,tau,typo", [(100, 0.08, False), (1000, 0.5, False),
                                        (4099, 0.3, True)])
def test_solve_kernels_match_plain_versions(dev, n, tau, typo):
    els, kw = _elements(n, tau, n, dev)
    before = dict(cuda_lib.LAUNCHES)
    a, p = solve_ops.fused_solve(*els, **kw, faithful_eq13_typo=typo)
    a2, p2 = solve_ops.selection_solve(*els, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fused_solve"] == before["fused_solve"] + 1
    assert cuda_lib.LAUNCHES["selection_solve"] == before["selection_solve"] + 1
    for (got_a, got_p), (ref_a, ref_p) in (
            ((a, p), solve_ref.fused_solve_ref(*els, **kw,
                                               faithful_eq13_typo=typo)),
            ((a2, p2), solve_ref.selection_solve_ref(*els, **kw))):
        torch.testing.assert_close(got_a, ref_a, rtol=0, atol=SOLVE_TOL)
        torch.testing.assert_close(got_p, ref_p, rtol=SOLVE_TOL, atol=SOLVE_TOL)


@pytest.mark.parametrize("t,n,d", [(1, 8, 33), (4, 100, 1000), (16, 100, 2490)])
def test_masked_aggregate_matches_plain_version(dev, t, n, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    g = torch.randn(t, n, d, device=dev, generator=gen)
    coef = torch.rand(t, n, device=dev, generator=gen)
    out = agg_ops.masked_aggregate_batched(g, coef)
    torch.testing.assert_close(out, agg_ref.masked_aggregate_ref(g, coef),
                               rtol=0, atol=0)


def test_wrappers_check_operands(dev):
    x = torch.ones(10, device=dev)
    kw = dict(s_bits=6.4e6, tau=0.08, p_max=1.0)
    with pytest.raises(ValueError, match="float32"):
        solve_ops.fused_solve(x.double(), x, x, x, **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        solve_ops.selection_solve(x, x.cpu(), x, x, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        g = torch.ones(2, 3, 8, device=dev).transpose(1, 2)
        agg_ops.masked_aggregate_batched(g, torch.ones(2, 8, device=dev))


@pytest.mark.parametrize("tau", [0.08, 0.5])
def test_drop_in_solvers_match_plain_solvers(dev, tau):
    problem = sample_problem(3, 100, tau_th=tau, device=dev)
    fused, ref = solve_ops.solve_joint_fused_kernel(problem), solve_joint(problem)
    torch.testing.assert_close(fused.a, ref.a, rtol=0, atol=SOLVE_TOL)
    torch.testing.assert_close(fused.power, ref.power, rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)
    exact, ref = solve_ops.solve_joint_kernel(problem), solve_joint_optimal(problem)
    torch.testing.assert_close(exact.a, ref.a, rtol=0, atol=SOLVE_TOL)
    torch.testing.assert_close(exact.power, ref.power, rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)


def test_sweep_with_kernel_aggregate_matches_fused_path(dev):
    """The stacked path's eq.-4 sums run on the kernel; the fused path
    (one backward over the coef-weighted loss) needs none and agrees."""
    spec = dataclasses.replace(experiments.MILD_BIAS, n_devices=12, n_train=300,
                               n_test=60, n_rounds=3, eval_every=3, n_runs=1,
                               solver="fused_kernel")
    plans, _, cfgs, train, test = experiments.build_scenario_plans(spec, device=dev)
    before = cuda_lib.LAUNCHES["masked_aggregate"]
    runs = [run_fl_sweep(stack_plans(plans), train, test,
                         dataclasses.replace(cfgs[0], aggregate=agg),
                         init_sweep_params(cfgs, device=dev), device=dev)
            for agg in ("stacked", "fused")]
    assert cuda_lib.LAUNCHES["masked_aggregate"] == before + 8 * spec.n_rounds
    for a, b in zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)):
        torch.testing.assert_close(a, b, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    for h0, h1 in zip(runs[0].histories, runs[1].histories):
        assert (h0.participants == h1.participants).all()
