"""The port's CUDA kernels on the card: each against its plain version.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode).  The file imports torch and ``repro_torch`` only, so
it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: the kernels compute in float32 with the plain versions'
operation order and no FMA contraction, so they are expected to match
bit for bit; the checks allow 1e-5 (the reference's solver tolerance)
on a* and P*, and exact equality for the eq.-4 sums, plain and
quantised, whose order of addition is the same.  The drop-in solvers are
held against the plain ``solve_joint`` / ``solve_joint_optimal`` at
1e-5.  The loop engine and the sweep under an 8-bit uplink draw the same
noise, but their gradients may differ by float rounding on the card, so
an element may round one level apart: all but 1e-3 of the parameters
agree at 1e-5, each within one level per round.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.alternating import solve_joint
from repro_torch.core.optimal import solve_joint_optimal
from repro_torch.core.problem import sample_problem
from repro_torch.core.schedulers import ProbabilisticScheduler
from repro_torch.fl import experiments
from repro_torch.fl.engine import FLConfig, quantize_levels, run_fl
from repro_torch.fl.scan_engine import (init_sweep_params, run_fl_scan,
                                        run_fl_sweep, stack_plans)
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.masked_aggregate import ops as agg_ops
from repro_torch.kernels.masked_aggregate import ref as agg_ref
from repro_torch.kernels.selection_solve import ops as solve_ops
from repro_torch.kernels.selection_solve import ref as solve_ref
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

SOLVE_TOL = 1e-5
FLIP_SHARE = 1e-3
NOT_WHOLE = 7.9999995
CNN_LEAVES = (72, 8, 1152, 16, 195216, 249, 2490, 10)

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


def test_quantized_wrapper_checks_operands(dev):
    g = torch.ones(2, 3, 8, device=dev)
    c = torch.ones(2, 3, device=dev)
    with pytest.raises(ValueError, match="one CUDA device"):
        agg_ops.quantized_masked_aggregate_batched(g, c, g.cpu(), c, c)
    with pytest.raises(ValueError, match="float32"):
        agg_ops.quantized_masked_aggregate_batched(g, c, g, c.double(), c)
    with pytest.raises(ValueError, match="contiguous"):
        u = torch.ones(2, 8, 3, device=dev).transpose(1, 2)
        agg_ops.quantized_masked_aggregate_batched(g, c, u, c, c)
    with pytest.raises(ValueError, match="expected g and noise"):
        agg_ops.quantized_masked_aggregate_batched(g, c, g, c[:, :2], c)


@pytest.mark.parametrize("t,n", [(1, 1), (1, 100), (18, 1), (18, 100)])
def test_quantized_aggregate_matches_plain_version(dev, t, n):
    """Bit for bit over every CNN leaf size and two ragged ones, at widths
    1, 4, 8, 32, one that is not whole and a per-client mix, with an
    all-zero client row and noise at 0 and just below 1."""
    gen = torch.Generator(device=dev).manual_seed(t * 1000 + n)
    mix = torch.tensor([1.0, 4.0, 8.0, 16.0, 32.0, NOT_WHOLE], device=dev)[
        torch.randint(0, 6, (t, n), device=dev, generator=gen)]
    widths = [torch.full((t, n), b, device=dev)
              for b in (1.0, 4.0, 8.0, 32.0, NOT_WHOLE)] + [mix]
    for d in (33, 1000) + CNN_LEAVES:
        g = torch.randn(t, n, d, device=dev, generator=gen)
        if n > 1:
            g[:, n // 2] = 0.0
        u = torch.rand(t, n, d, device=dev, generator=gen)
        u[..., ::7] = 0.0
        u[..., 3::7] = float(torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)))
        coef = torch.rand(t, n, device=dev, generator=gen)
        for bits in widths:
            levels = agg_ref.quantizer_levels(bits)
            scale = agg_ops.row_scale(g, levels)
            before = cuda_lib.LAUNCHES["quantized_masked_aggregate"]
            out = agg_ops.quantized_masked_aggregate_batched(g, coef, u, scale,
                                                             levels)
            assert cuda_lib.LAUNCHES["quantized_masked_aggregate"] == before + 1
            torch.testing.assert_close(
                out, agg_ref.quantized_masked_aggregate_ref(g, coef, u, scale,
                                                            levels),
                rtol=0, atol=0)


def test_quantized_loop_matches_sweep_on_the_card(dev):
    spec = dataclasses.replace(experiments.HIGH_BIAS, n_devices=12, n_train=300,
                               n_test=60)
    problem, train, parts, test = experiments.make_problem_and_data(spec, 0, dev)
    cfg = FLConfig(n_rounds=3, eval_every=3, batch_per_client=4,
                   aggregate="stacked", uplink_bits=8, seed=1)
    sch = ProbabilisticScheduler(solver="fused")
    before = cuda_lib.LAUNCHES["quantized_masked_aggregate"]
    loop = run_fl(problem, sch, train, parts, test, cfg, device=dev)
    n_loop = cuda_lib.LAUNCHES["quantized_masked_aggregate"] - before
    scan = run_fl_scan(problem, sch, train, parts, test, cfg, device=dev)
    assert n_loop == 8 * int((loop.history.participants > 0).sum())
    assert (cuda_lib.LAUNCHES["quantized_masked_aggregate"] - before - n_loop
            == 8 * cfg.n_rounds)
    assert (loop.history.participants == scan.history.participants).all()
    assert loop.history.participants.sum() > 0
    diff = torch.cat([(a - b).abs().ravel() for a, b in
                      zip(tree_leaves(loop.params), tree_leaves(scan.params))])
    ref = torch.cat([a.abs().ravel() for a in tree_leaves(loop.params)])
    level = cfg.n_rounds * cfg.lr * 10.0 / quantize_levels(8)
    assert float((diff > SOLVE_TOL + SOLVE_TOL * ref).float().mean()) <= FLIP_SHARE
    assert float(diff.max()) <= SOLVE_TOL + level


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
