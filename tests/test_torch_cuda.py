"""The port's CUDA kernels on the card: each against its plain version.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode).  The file imports torch, ``repro_torch`` and the
root's ``chip_smoke.py`` only, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: the kernels compute in float32 with the plain versions'
operation order and no FMA contraction, so the solve kernels are held to
their plain versions bit for bit (NaN at the same places; each element's
loop stops once its state stops changing, which gives the fixed trip
count's outputs exactly), on sampled problems, adversarial elements and
a ragged mixed batch with its padded slots, and the eq.-4 sums, plain
and quantised, whose order of addition is the same, exactly; the decode attention
(swa_decode) at rtol = atol = 2e-5, the reference's float32 tolerance for
its decode kernel (online softmax against the dense one), with gemma2's
softcap too, and without one bit for bit the outputs it gave before it
took one; the SSD scan
(ssd_scan) at 1e-4 against the sequential recurrence and 2e-4 against the
plain chunked form, the reference's tolerances for its kernel
(``tests/test_kernels.py``; sums in another order).  The drop-in
solvers are
held against the plain ``solve_joint`` / ``solve_joint_optimal`` at
1e-5.  The loop engine and the sweep under an 8-bit uplink draw the same
noise, but their gradients may differ by float rounding on the card, so
an element may round one level apart: all but 1e-3 of the parameters
agree at 1e-5, each within one level per round.
"""
import dataclasses

import pytest
import torch

import chip_smoke

from repro_torch.analysis import HostSyncBudget, hotpaths
from repro_torch.analysis.rank import sweep_rank_contract
from repro_torch.configs import ARCHS
from repro_torch.core.alternating import solve_joint
from repro_torch.core.batch import solve_joint_batch
from repro_torch.core.optimal import solve_joint_optimal
from repro_torch.core.problem import sample_problem
from repro_torch.core.scenarios import make_batch, make_mixed_batch
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
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.swa_decode import ops as swa_ops
from repro_torch.kernels.swa_decode import ref as swa_ref
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

SOLVE_TOL = 1e-5
FLIP_SHARE = 1e-3
NOT_WHOLE = 7.9999995
CNN_LEAVES = (72, 8, 1152, 16, 195216, 249, 2490, 10)
DECODE_TOL = 2e-5
SSD_SEQ_TOL = 1e-4
SSD_TOL = 2e-4
MODEL_TOL = 1e-4

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


def _solve_kernels_match_plain_versions(els, kw, n_iters, typo):
    before = dict(cuda_lib.LAUNCHES)
    fkw = dict(kw, n_iters=n_iters, faithful_eq13_typo=typo)
    fused = solve_ops.fused_solve(*els, **fkw)
    exact = solve_ops.selection_solve(*els, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["fused_solve"] == before["fused_solve"] + 1
    assert cuda_lib.LAUNCHES["selection_solve"] == before["selection_solve"] + 1
    # bit for bit, NaN (of any payload) at the same places
    for got, want in ((fused, solve_ref.fused_solve_ref(*els, **fkw)),
                      (exact, solve_ref.selection_solve_ref(*els, **kw))):
        assert [chip_smoke.bit_err(torch, g, w)
                for g, w in zip(got, want)] == [0.0, 0.0]


@pytest.mark.parametrize("n,tau,typo,n_iters", [
    (100, 0.08, False, 50), (1000, 0.5, False, 50), (4099, 0.3, True, 50),
    (4099, 0.3, False, 7), (1000, 0.08, True, 2), (100, 0.5, False, 1)])
def test_solve_kernels_match_plain_versions(dev, n, tau, typo, n_iters):
    els, kw = _elements(n, tau, n, dev)
    _solve_kernels_match_plain_versions(els, kw, n_iters, typo)


@pytest.mark.parametrize("typo", [False, True], ids=["eq13", "typo"])
@pytest.mark.parametrize("n_iters", [1, 2, 7, 50])
def test_solve_kernels_match_plain_versions_on_adversarial_elements(
        dev, n_iters, typo):
    els, kw = chip_smoke.adversarial_elements(torch, 4099, n_iters, dev)
    _solve_kernels_match_plain_versions(els, kw, n_iters, typo)


@pytest.mark.parametrize("typo,n_iters", [(False, 50), (True, 50), (False, 7)])
def test_solve_kernels_match_plain_versions_on_a_padded_mixed_batch(
        dev, typo, n_iters):
    batch = make_mixed_batch(chip_smoke.MIXED_SCENARIOS, seed=0, device=dev)
    assert not bool(batch.mask.all())
    _solve_kernels_match_plain_versions(*chip_smoke.batch_operands(batch),
                                        n_iters, typo)


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


def _equal_with_nan(got, want) -> bool:
    """NaN at the same places, every other value equal."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan]))


def _unaligned(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("t", [1, 18])
def test_row_scale_kernel_matches_row_scale(dev, t):
    """The scale kernel against ``row_scale``, bit for bit, over every CNN
    leaf size and two ragged ones, with a NaN, an inf, a -inf and an
    all-zero row, mixed widths, and a row that starts off a 16-byte
    boundary."""
    n = 100
    gen = torch.Generator(device=dev).manual_seed(t)
    bits = torch.tensor([1.0, 4.0, 8.0, 16.0, 32.0, NOT_WHOLE], device=dev)[
        torch.randint(0, 6, (t, n), device=dev, generator=gen)]
    levels = agg_ref.quantizer_levels(bits)
    for d in CNN_LEAVES + (33, 1001):
        g = torch.randn(t, n, d, device=dev, generator=gen)
        g[:, 1] = 0.0
        g[:, 2, d // 2] = float("nan")
        g[:, 3, d - 1] = float("inf")
        g[:, 4, 0] = -float("inf")
        plain = agg_ops.row_scale(g, levels)
        for x in (g, _unaligned(g)):
            before = cuda_lib.LAUNCHES["row_scale"]
            got = agg_ops.row_scale_batched(x, levels)
            assert cuda_lib.LAUNCHES["row_scale"] == before + 1
            assert _equal_with_nan(got, plain), d
        assert bool(torch.isnan(plain[:, 2]).all())
        assert bool(torch.isinf(plain[:, 3:5]).all())
    with pytest.raises(ValueError, match="expected g"):
        agg_ops.row_scale_batched(g, levels[:, :2])


@pytest.mark.parametrize("live", [0, 1, "22pct", "all"])
@pytest.mark.parametrize("t,n", [(1, 100), (18, 100), (2, 300)])
def test_quantized_kernel_skips_zero_coefficient_rows_exactly(dev, live, t, n):
    """No live client, one, about 22 % and all of them (N = 300 spans two
    of a block's row lists): the kernel, which reads only the rows with a
    nonzero coefficient, against its plain version, bit for bit, with its
    scale from the scale kernel; one launch of each per wrapper call."""
    gen = torch.Generator(device=dev).manual_seed(n + t)
    keep = {0: 0, 1: 1, "22pct": round(0.22 * n), "all": n}[live]
    bits = torch.tensor([4.0, 8.0, 16.0, 32.0], device=dev)[
        torch.randint(0, 4, (t, n), device=dev, generator=gen)]
    levels = agg_ref.quantizer_levels(bits)
    for d in (33, 1000, 2490, 195216):
        g = torch.randn(t, n, d, device=dev, generator=gen)
        u = torch.rand(t, n, d, device=dev, generator=gen)
        coef = torch.rand(t, n, device=dev, generator=gen) + 0.01
        order = torch.rand(t, n, device=dev, generator=gen).argsort(dim=1)
        coef.scatter_(1, order[:, keep:], 0.0)
        assert int((coef != 0).sum()) == t * keep
        for x, noise in ((g, u), (_unaligned(g), _unaligned(u))):
            scale = agg_ops.row_scale_batched(x, levels)
            out = agg_ops.quantized_masked_aggregate_batched(x, coef, noise,
                                                             scale, levels)
            plain = agg_ref.quantized_masked_aggregate_ref(x, coef, noise,
                                                           scale, levels)
            assert torch.equal(out, plain), d
        before = dict(cuda_lib.LAUNCHES)
        wrapped = agg_ops.quantized_masked_aggregate(g, coef, u, bits)
        assert cuda_lib.LAUNCHES["row_scale"] == before["row_scale"] + 1
        assert (cuda_lib.LAUNCHES["quantized_masked_aggregate"]
                == before["quantized_masked_aggregate"] + 1)
        assert torch.equal(wrapped, out)
        if keep == 0:
            assert not bool(out.any())


@pytest.mark.parametrize("bad", ["nan", "inf", "underflow"])
def test_quantized_kernel_keeps_nan_of_nonfinite_zero_coefficient_rows(dev, bad):
    """A client whose coefficient is 0 but whose row holds a NaN or an inf
    (its scale is then NaN or inf), or an all-zero row at a width whose
    scale underflows to 0: 0 * Q(g) is NaN there, so the kernel must read
    that row.  Trajectories 0 and 1 hold such a row, trajectory 2 none;
    NaN exactly where the plain version has NaN, every other value equal."""
    t, n = 3, 100
    gen = torch.Generator(device=dev).manual_seed(7)
    for d in (33, 1000, 195216):
        g = torch.randn(t, n, d, device=dev, generator=gen)
        u = torch.rand(t, n, d, device=dev, generator=gen)
        coef = torch.rand(t, n, device=dev, generator=gen)
        coef = coef * (coef > 0.78)
        bits = torch.full((t, n), 8.0, device=dev)
        for k, row in ((0, 5), (1, 60)):
            coef[k, row] = 0.0
            if bad == "underflow":
                g[k, row] = 0.0
                bits[k, row] = 127.0       # L = 2^126 - 1: 1e-12 / L is 0
            else:
                g[k, row, d // 3] = float(bad)
        before = dict(cuda_lib.LAUNCHES)
        out = agg_ops.quantized_masked_aggregate(g, coef, u, bits)
        assert cuda_lib.LAUNCHES["row_scale"] == before["row_scale"] + 1
        assert (cuda_lib.LAUNCHES["quantized_masked_aggregate"]
                == before["quantized_masked_aggregate"] + 1)
        levels = agg_ref.quantizer_levels(bits)
        plain = agg_ref.quantized_masked_aggregate_ref(
            g, coef, u, agg_ops.row_scale(g, levels), levels)
        assert _equal_with_nan(out, plain), d
        assert bool(torch.isnan(plain[:2]).any())
        assert bool(torch.isfinite(plain[2]).all())


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


BATCHES = {
    "rayleigh_fading": lambda dev: make_batch("rayleigh_fading", 8, seed=1,
                                              device=dev),
    "mixed": lambda dev: make_mixed_batch(
        ["paper_static", "bandwidth_starved", "sparse_energy_starved",
         "hetero_bandwidth"], seed=2, device=dev),
    "b_eq_nmax": lambda dev: make_batch("paper_static", 33, seed=3,
                                        n_devices=33, device=dev),
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batch_kernel_methods_match_plain_methods(dev, name):
    """One launch of each kernel over a whole batch, held against
    ``method="optimal"`` / ``"fused"`` and, bit for bit, against each
    instance's own kernel solve; padded slots come back 0."""
    batch = BATCHES[name](dev)
    before = dict(cuda_lib.LAUNCHES)
    kern = solve_joint_batch(batch, method="kernel")
    fused_k = solve_joint_batch(batch, method="fused_kernel")
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["selection_solve"] == before["selection_solve"] + 1
    assert cuda_lib.LAUNCHES["fused_solve"] == before["fused_solve"] + 1
    for got, plain in ((kern, solve_joint_batch(batch, method="optimal")),
                       (fused_k, solve_joint_batch(batch, method="fused"))):
        torch.testing.assert_close(got.a, plain.a, rtol=0, atol=SOLVE_TOL)
        torch.testing.assert_close(got.power, plain.power, rtol=SOLVE_TOL,
                                   atol=SOLVE_TOL)
        torch.testing.assert_close(got.objective, plain.objective, rtol=0,
                                   atol=SOLVE_TOL)
        pad = ~batch.mask
        assert not bool(got.a[pad].any()) and not bool(got.power[pad].any())
    for b, problem in enumerate(batch.unstack()):
        for got, one in ((kern, solve_ops.solve_joint_kernel(problem)),
                         (fused_k, solve_ops.solve_joint_fused_kernel(problem))):
            assert torch.equal(got.instance(b).a, one.a)
            assert torch.equal(got.instance(b).power, one.power)
            assert bool(problem.constraints_satisfied(
                got.instance(b).a, got.instance(b).power, rtol=1e-3).all())


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


def _ring_positions(w, qpos, dev):
    """Slot s holds the latest position p <= qpos with p % W == s."""
    latest = qpos - (qpos - torch.arange(w, device=dev)) % w
    return torch.where(latest >= 0, latest, -1).to(torch.int32)


def _decode_case(dev, b, w, hkv, g, dh, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hkv, g, dh, device=dev, generator=gen) * dh ** -0.5
    k = torch.randn(b, w, hkv, dh, device=dev, generator=gen)
    v = torch.randn(b, w, hkv, dh, device=dev, generator=gen)
    return q, k, v


@pytest.mark.parametrize("w,hkv,g,dh,window", [
    (512, 4, 4, 64, None), (1024, 2, 8, 128, 300), (512, 1, 4, 128, 128),
    (256, 8, 1, 64, None)])
def test_swa_decode_matches_plain_version(dev, w, hkv, g, dh, window):
    """The reference kernel tests' shapes: the last 3 slots empty."""
    q, k, v = _decode_case(dev, 2, w, hkv, g, dh, w + hkv)
    pos = torch.where(torch.arange(w, device=dev) < w - 3,
                      torch.arange(w, device=dev), -1).to(torch.int32)
    before = cuda_lib.LAUNCHES["swa_decode"]
    out = swa_ops.swa_decode(q, k, v, pos, w + 5, window=window)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["swa_decode"] == before + 1
    torch.testing.assert_close(
        out, swa_ref.swa_decode_ref(q, k, v, pos, w + 5, window=window),
        rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("w", [88, 96, 97, 512, 664, 4096])
@pytest.mark.parametrize("window", [None, 512])
def test_swa_decode_gemma3_shapes_match_plain_version(dev, w, window):
    """gemma3's MQA heads (Hkv 1, G 4, dh 256), a ring filling, full and
    wrapped (qpos past W), any W; W = 88 is the serving run's 64 + 24."""
    q, k, v = _decode_case(dev, 4, w, 1, 4, 256, w)
    for qpos in (w // 2, w - 1, w + 37):
        pos = _ring_positions(w, qpos, dev)
        out = swa_ops.swa_decode(q, k, v, pos, qpos, window=window)
        torch.testing.assert_close(
            out, swa_ref.swa_decode_ref(q, k, v, pos, qpos, window=window),
            rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("w,window,qpos", [
    (512, None, 100),           # a ring filling: splits past slot 100 empty
    (512, 128, 2000),           # a window: most splits hold no valid slot
    (97, None, 300),            # a W none of the split counts divides
    (664, None, 1327),          # gemma3's global ring, full
])
@pytest.mark.parametrize("nsplit", [1, 2, 7, 33, 64])
def test_swa_decode_splits_match_plain_version(dev, w, window, qpos, nsplit):
    """Split counts from one to many, with empty splits and splits that
    hold no valid slot: the kernel against its plain version and against
    the split written out (``swa_decode_split_ref``)."""
    q, k, v = _decode_case(dev, 4, w, 1, 4, 256, w + nsplit)
    pos = _ring_positions(w, qpos, dev)
    out = swa_ops._launch(q, k, v, pos, qpos, window, nsplit)
    torch.testing.assert_close(
        out, swa_ref.swa_decode_ref(q, k, v, pos, qpos, window=window),
        rtol=DECODE_TOL, atol=DECODE_TOL)
    torch.testing.assert_close(
        out, swa_ref.swa_decode_split_ref(q, k, v, pos, qpos, window=window,
                                          nsplit=nsplit),
        rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("nsplit", [1, 3])
def test_swa_decode_ragged_head_dim_matches_plain_version(dev, nsplit):
    """dh = 30: the kernel's 4-byte loads and stores, one split and many."""
    q, k, v = _decode_case(dev, 3, 130, 2, 3, 30, nsplit)
    pos = _ring_positions(130, 200, dev)
    torch.testing.assert_close(
        swa_ops._launch(q, k, v, pos, 200, None, nsplit),
        swa_ref.swa_decode_ref(q, k, v, pos, 200, window=None),
        rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("nsplit", [1, 4, 64])
def test_swa_decode_without_valid_slots_is_zero(dev, nsplit):
    q, k, v = _decode_case(dev, 2, 256, 2, 4, 64, nsplit)
    pos = torch.full((256,), -1, dtype=torch.int32, device=dev)
    out = swa_ops._launch(q, k, v, pos, 5, None, nsplit)
    assert bool((out == 0).all())


@pytest.mark.parametrize("b,w,window,qpos", [
    (2, 1, None, 0),            # a single slot
    (16, 32768, 512, 40000),    # a long ring under a window
    (16, 32768, None, 40000),
])
def test_swa_decode_edge_shapes_match_plain_version(dev, b, w, window, qpos):
    q, k, v = _decode_case(dev, b, w, 1, 4, 256, w)
    pos = _ring_positions(w, qpos, dev)
    torch.testing.assert_close(
        swa_ops.swa_decode(q, k, v, pos, qpos, window=window),
        swa_ref.swa_decode_ref(q, k, v, pos, qpos, window=window),
        rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("b,w,nsplit", [(4, 664, 21), (16, 32768, 17), (3, 97, 5)])
def test_swa_decode_repeats_bit_for_bit(dev, b, w, nsplit):
    """Consecutive launches at one shape give the same bits: the merge
    runs in split order and the counter is left at 0 for the next."""
    q, k, v = _decode_case(dev, b, w, 1, 4, 256, 7)
    pos = _ring_positions(w, 2 * w - 1, dev)
    outs = [swa_ops._launch(q, k, v, pos, 2 * w - 1, None, nsplit)
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_swa_decode_streams_keep_their_own_counters(dev):
    """Launches queued on two streams at once, each at many splits: every
    output matches the one made alone, since each stream has its own
    last-block counters."""
    q, k, v = _decode_case(dev, 4, 4096, 1, 4, 256, 11)
    pos = _ring_positions(4096, 8191, dev)
    alone = swa_ops._launch(q, k, v, pos, 8191, None, 64)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    torch.cuda.synchronize()
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(swa_ops._launch(q, k, v, pos, 8191, None, 64))
    torch.cuda.synchronize()
    assert all(torch.equal(alone, o) for o in outs)


# llama4-scout's heads: 8 KV heads, G 5 (an odd group: the MAXG = 8
# instance), dh 128; the serving cache of 88 and the local window of 8,192
@pytest.mark.parametrize("w,qpos,nsplit", [(88, 60, 1), (88, 150, 3),
                                           (8192, 16383, 1), (8192, 9000, 7),
                                           (8192, 16383, 64)])
@pytest.mark.parametrize("window", [8192, None])
def test_swa_decode_llama4_heads_match_plain_version(dev, w, qpos, nsplit,
                                                     window):
    q, k, v = _decode_case(dev, 4, w, 8, 5, 128, w + nsplit)
    pos = _ring_positions(w, qpos, dev)
    plain = swa_ref.swa_decode_ref(q, k, v, pos, qpos, window=window)
    torch.testing.assert_close(swa_ops._launch(q, k, v, pos, qpos, window, nsplit),
                               plain, rtol=DECODE_TOL, atol=DECODE_TOL)
    torch.testing.assert_close(swa_ops.swa_decode(q, k, v, pos, qpos, window=window),
                               plain, rtol=DECODE_TOL, atol=DECODE_TOL)


def test_swa_decode_wrapper_checks_operands(dev):
    q, k, v = _decode_case(dev, 1, 8, 1, 4, 64, 0)
    pos = torch.arange(8, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        swa_ops.swa_decode(q, k.double(), v, pos, 7, window=None)
    with pytest.raises(ValueError, match="int32"):
        swa_ops.swa_decode(q, k, v, pos.long(), 7, window=None)
    with pytest.raises(ValueError, match="expected q"):
        swa_ops.swa_decode(q, k[:, :4], v, pos, 7, window=None)
    with pytest.raises(ValueError, match="G <= 8"):
        q16, k16, v16 = _decode_case(dev, 1, 8, 1, 16, 64, 0)
        swa_ops.swa_decode(q16, k16, v16, pos, 7, window=None)


# gemma2's heads (16 KV heads, G 2, dh 128) and zamba2's (32, G 1, dh 112)
@pytest.mark.parametrize("hkv,g,dh", [(16, 2, 128), (32, 1, 112)])
@pytest.mark.parametrize("window", [4096, None])
@pytest.mark.parametrize("nsplit", [1, 7, 64])
@pytest.mark.parametrize("hot", [1.0, 30.0])
def test_swa_decode_softcap_matches_plain_version(dev, hkv, g, dh, window,
                                                  nsplit, hot):
    """Kernel 6 with gemma2's softcap (50) on a ragged ring of 4,100 slots
    wrapped past qpos 9,000, against its plain version and the split
    written out; the queries as drawn and scaled by 30, where the tanh
    bends the scores hard."""
    q, k, v = _decode_case(dev, 2, 4100, hkv, g, dh, nsplit + hkv)
    q = q * hot
    pos = _ring_positions(4100, 9000, dev)
    out = swa_ops._launch(q, k, v, pos, 9000, window, nsplit, 50.0)
    kw = dict(window=window, softcap=50.0)
    torch.testing.assert_close(
        out, swa_ref.swa_decode_ref(q, k, v, pos, 9000, **kw),
        rtol=DECODE_TOL, atol=DECODE_TOL)
    torch.testing.assert_close(
        out, swa_ref.swa_decode_split_ref(q, k, v, pos, 9000, nsplit=nsplit, **kw),
        rtol=DECODE_TOL, atol=DECODE_TOL)


def test_swa_decode_softcap_goes_through_the_wrapper(dev):
    """``decode_attention`` and ``swa_decode`` pass the softcap to the
    launch: one launch each, the capped output apart from the uncapped."""
    q, k, v = _decode_case(dev, 4, 88, 16, 2, 128, 3)
    q = q * 30
    pos = _ring_positions(88, 120, dev)
    before = cuda_lib.LAUNCHES["swa_decode"]
    capped = swa_ops.swa_decode(q, k, v, pos, 120, window=4096, softcap=50.0)
    layer = swa_ops.decode_attention(
        (q * 128 ** 0.5).reshape(4, 1, 32, 128), k, v, pos, 120, window=4096,
        n_heads=32, softcap=50.0)
    assert cuda_lib.LAUNCHES["swa_decode"] == before + 2
    plain = swa_ref.swa_decode_ref(q, k, v, pos, 120, window=4096, softcap=50.0)
    torch.testing.assert_close(capped, plain, rtol=DECODE_TOL, atol=DECODE_TOL)
    torch.testing.assert_close(layer.reshape(capped.shape), plain,
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    free = swa_ops.swa_decode(q, k, v, pos, 120, window=4096)
    assert float((free - capped).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="softcap"):
        swa_ops._launch(q, k, v, pos, 120, None, 1, 0.0)


def test_swa_decode_without_softcap_is_unchanged(dev):
    """Without a softcap the kernel gives, bit for bit, the outputs it
    gave before it took one (``chip_smoke.DECODE_DIGESTS``)."""
    assert chip_smoke.decode_digests(torch, dev) == list(chip_smoke.DECODE_DIGESTS)


@pytest.mark.parametrize("d_model", [64, 256])
def test_decode_step_on_the_card_matches_forward(dev, d_model):
    """A reduced gemma3 (local rings of 64, global layers) teacher-forced
    for 130 steps through the kernel, against forward's plain attention."""
    cfg = ARCHS["gemma3-1b"].reduced(n_layers=14, d_model=d_model)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 130), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    full, _ = T.forward(cfg, params, {"tokens": tokens})
    cache = T.init_cache(cfg, 2, 130, device=dev)
    before = cuda_lib.LAUNCHES["swa_decode"]
    for i in range(130):
        logits, cache = T.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
    assert cuda_lib.LAUNCHES["swa_decode"] == before + 130 * cfg.n_layers


@pytest.mark.parametrize("name,n_layers", [("gemma2-27b", 5), ("zamba2-7b", 13),
                                           ("h2o-danube-3-4b", 3)])
def test_reduced_archs_decode_on_the_card_matches_forward(dev, name, n_layers):
    """gemma2 (the softcapped decode), zamba2 (the shared block over two
    occurrences, kernel 5 in forward) and danube reduced, teacher-forced
    for 160 steps through kernel 6 against forward."""
    cfg = ARCHS[name].reduced(n_layers=n_layers)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 160), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    full, _ = T.forward(cfg, params, {"tokens": tokens})
    cache = T.init_cache(cfg, 2, 160, device=dev)
    n_attn = sum(k[0] in ("attn", "gattn", "shared_attn")
                 for k in T.layer_plan(cfg).all_layers())
    before = cuda_lib.LAUNCHES["swa_decode"]
    for i in range(160):
        logits, cache = T.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
    assert cuda_lib.LAUNCHES["swa_decode"] == before + 160 * n_attn


def _moe_variant(name, n_layers, g5):
    cfg = ARCHS[name].reduced(n_layers=n_layers)
    if g5:                        # 10 query heads over 2 KV heads: G = 5
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, n_heads=10, n_kv_heads=2, d_head=32))
    return cfg


@pytest.mark.parametrize("name,n_layers,g5", [
    ("deepseek-v2-lite-16b", 3, False), ("llama4-scout-17b-a16e", 8, False),
    ("llama4-scout-17b-a16e", 8, True)])
def test_reduced_moe_archs_on_the_card_match_the_cpu(dev, name, n_layers, g5):
    """deepseek (MLA, MoE with shared experts) and llama4 (kernel 6 on its
    local and global layers, at G = 1 and 5) reduced: forward's logits and
    aux and 130 teacher-forced decode steps on the card against the same
    on the CPU, at the CPU tests' 1e-4, after checking that the CPU's
    routing margins exceed 1e-5 (``test_torch_moe_mla.py``)."""
    cfg = _moe_variant(name, n_layers, g5)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda x: x.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 130),
                           generator=torch.Generator().manual_seed(1))
    routes = []
    with chip_smoke.recorded_routes(routes):
        full, aux = T.forward(cfg, params, {"tokens": tokens})
    assert min(float(m.min()) for _, m in routes) > 1e-5
    full_dev, aux_dev = T.forward(cfg, card, {"tokens": tokens.to(dev)})
    torch.testing.assert_close(full_dev.cpu(), full, rtol=MODEL_TOL, atol=MODEL_TOL)
    torch.testing.assert_close(aux_dev.cpu(), aux, rtol=MODEL_TOL, atol=MODEL_TOL)
    cache = T.init_cache(cfg, 2, 130, device="cpu")
    cache_dev = T.init_cache(cfg, 2, 130, device=dev)
    n_attn = sum(k[0] in ("attn", "gattn") for k in T.layer_plan(cfg).all_layers())
    before = cuda_lib.LAUNCHES["swa_decode"]
    for i in range(130):
        logits, cache = T.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        got, cache_dev = T.decode_step(cfg, card, cache_dev,
                                       tokens[:, i:i + 1].to(dev), i)
        torch.testing.assert_close(got.cpu(), logits, rtol=MODEL_TOL, atol=MODEL_TOL)
    assert cuda_lib.LAUNCHES["swa_decode"] == before + 130 * n_attn
    for a, b in zip(tree_leaves(cache_dev), tree_leaves(cache)):
        torch.testing.assert_close(a.cpu(), b, rtol=MODEL_TOL, atol=MODEL_TOL)


def test_batched_server_on_the_card_launches_the_kernel(dev):
    cfg = ARCHS["gemma3-1b"].reduced()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    reqs = [Request(rid=i, prompt=torch.arange(4 + i).numpy() % cfg.vocab,
                    max_new=5) for i in range(3)]
    before = cuda_lib.LAUNCHES["swa_decode"]
    stats = BatchedServer(cfg, params, 2, cache_len=69, device=dev).run(reqs)
    assert all(len(r.out) == 5 for r in reqs)
    assert (cuda_lib.LAUNCHES["swa_decode"] - before
            == stats["decode_steps"] * cfg.n_layers)


def _ssd_case(dev, b, s, h, p, n, seed, init=False):
    """Mamba-shaped operands at the reference kernel tests' ranges."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, device=dev, generator=gen)
    x = torch.randn(b, s, h, p, device=dev, generator=gen)
    dt = u((b, s, h), 0.001, 0.1)
    a = -u((h,), 0.5, 4.0)
    bm = torch.randn(b, s, n, device=dev, generator=gen) * 0.3
    cm = torch.randn(b, s, n, device=dev, generator=gen) * 0.3
    d = torch.randn(h, device=dev, generator=gen)
    s0 = torch.randn(b, h, p, n, device=dev, generator=gen) if init else None
    return x, dt, a, bm, cm, d, s0


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 128, 16, 32, 16, 32),     # the reduced mamba2
    (1, 256, 4, 64, 128, 256),    # mamba2-780m's widths, a single chunk
    (2, 512, 3, 64, 128, 256),
    (1, 192, 3, 48, 100, 96),     # ragged: tiles padded in P, N and cs
    (3, 40, 5, 7, 5, 8),
    (1, 130, 2, 33, 1, 65),
])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_matches_plain_versions(dev, b, s, h, p, n, chunk, init):
    """y and the final state against the plain chunked form; y against
    the sequential recurrence (which starts from a zero state)."""
    x, dt, a, bm, cm, d, s0 = _ssd_case(dev, b, s, h, p, n, s + p + n, init)
    before = cuda_lib.LAUNCHES["ssd_scan"]
    y, state = ssd_ops.ssd_apply(x, dt, a, bm, cm, d, chunk=chunk,
                                 init_state=s0, return_state=True)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["ssd_scan"] == before + 1
    plain_y, plain_state = ssd_ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk, s0)
    torch.testing.assert_close(y, plain_y, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(state, plain_state, rtol=SSD_TOL, atol=SSD_TOL)
    if not init:
        seq = ssd_ref.ssd_scan_ref(
            x.permute(0, 2, 1, 3).reshape(b * h, s, p),
            dt.permute(0, 2, 1).reshape(b * h, s), a.repeat(b),
            bm.repeat_interleave(h, dim=0), cm.repeat_interleave(h, dim=0),
            d.repeat(b))
        torch.testing.assert_close(
            y, seq.reshape(b, h, s, p).permute(0, 2, 1, 3),
            rtol=SSD_SEQ_TOL, atol=SSD_SEQ_TOL)


@pytest.mark.parametrize("b,s", [(1, 4096), (4, 1024)])
def test_ssd_scan_prefill_shapes_match_plain_versions(dev, b, s):
    """mamba2-780m's widths (48 heads of 64, d_state 128, chunk 256) at the
    two prefills' batches, cut in S: against the chunked form and the four
    passes written out, y and the final state."""
    x, dt, a, bm, cm, d, _ = _ssd_case(dev, b, s, 48, 64, 128, s + b)
    y, state = ssd_ops.ssd_apply(x, dt, a, bm, cm, d, chunk=256,
                                 return_state=True)
    for plain in (ssd_ref.ssd_chunked_ref, ssd_ref.ssd_passes_ref):
        plain_y, plain_state = plain(x, dt, a, bm, cm, d, 256)
        torch.testing.assert_close(y, plain_y, rtol=SSD_TOL, atol=SSD_TOL)
        torch.testing.assert_close(state, plain_state, rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 1024, 48, 64, 128, 256),
                                             (3, 40, 5, 7, 5, 8)])
def test_ssd_scan_repeats_bit_for_bit(dev, b, s, h, p, n, chunk):
    """Consecutive launches at one shape give the same bits: no pass sums
    in an order that depends on timing."""
    x, dt, a, bm, cm, d, s0 = _ssd_case(dev, b, s, h, p, n, 11, init=True)
    runs = [ssd_ops.ssd_apply(x, dt, a, bm, cm, d, chunk=chunk, init_state=s0,
                              return_state=True) for _ in range(3)]
    for y, state in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(state, runs[0][1])


def test_ssd_scan_handles_large_decay(dev):
    """dt * a of tens per step, as at mamba2-780m's widths: above the
    diagonal exp(cum[l] - cum[s]) overflows, and must not leak NaN."""
    x, dt, a, bm, cm, d, _ = _ssd_case(dev, 1, 512, 4, 64, 128, 9)
    dt = dt * 300.0
    a = a * 4.0
    y, state = ssd_ops.ssd_apply(x, dt, a, bm, cm, d, chunk=256,
                                 return_state=True)
    plain_y, plain_state = ssd_ref.ssd_chunked_ref(x, dt, a, bm, cm, d, 256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    torch.testing.assert_close(y, plain_y, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(state, plain_state, rtol=SSD_TOL, atol=SSD_TOL)


def test_ssd_scan_wrapper_checks_operands(dev):
    x, dt, a, bm, cm, d, s0 = _ssd_case(dev, 1, 64, 2, 8, 4, 0, init=True)
    with pytest.raises(ValueError, match="float32"):
        ssd_ops.ssd_apply(x.double(), dt, a, bm, cm, d, chunk=32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_ops.ssd_apply(x, dt, a, bm.cpu(), cm, d, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_apply(x, dt, a, bm, cm, d, chunk=32,
                          init_state=s0.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="not divisible"):
        ssd_ops.ssd_apply(x, dt, a, bm, cm, d, chunk=48)
    with pytest.raises(ValueError, match="chunk <= 256"):
        big = _ssd_case(dev, 1, 512, 1, 8, 4, 0)[:6]
        ssd_ops.ssd_apply(*big, chunk=512)
    with pytest.raises(ValueError, match="P <= 64"):
        ssd_ops.ssd_apply(*_ssd_case(dev, 1, 32, 1, 65, 4, 0)[:6], chunk=32)
    with pytest.raises(ValueError, match="N <= 128"):
        ssd_ops.ssd_apply(*_ssd_case(dev, 1, 32, 1, 8, 129, 0)[:6], chunk=32)


def test_ssd_scan_forward_is_unchanged(dev):
    """Kernel 5's forward gives, bit for bit, the outputs it gave before
    its backward came (``chip_smoke.SSD_DIGESTS``)."""
    assert chip_smoke.ssd_digests(torch, dev) == list(chip_smoke.SSD_DIGESTS)


@pytest.mark.parametrize("b,s,h,p,n,chunk,init,cot", [
    (2, 128, 16, 32, 16, 32, True, True),     # the reduced mamba2
    (2, 512, 3, 64, 128, 256, True, True),    # mamba2-780m's widths
    (1, 192, 3, 48, 100, 96, False, True),    # ragged: tiles padded in P, N and cs
    (3, 40, 5, 7, 5, 8, True, False),
    (1, 130, 2, 33, 1, 65, False, False),
])
def test_ssd_scan_backward_matches_plain_backward(dev, b, s, h, p, n, chunk, init,
                                                  cot):
    """The backward kernel against the plain backward passes on the same
    forward scratch, each gradient within SSD_BWD_TOL of its max-norm; a
    second call the same bits; one launch counted a call."""
    ops_, s0 = chip_smoke.ssd_operands(torch, dev, b, s, h, p, n, s + p + n, init)
    before = cuda_lib.LAUNCHES["ssd_scan_bwd"]
    got, want = chip_smoke.ssd_backward_pair(torch, ops_, s0, chunk, 3, cot)
    again, _ = chip_smoke.ssd_backward_pair(torch, ops_, s0, chunk, 3, cot)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["ssd_scan_bwd"] == before + 2
    for name, u, v, w in zip(chip_smoke.SSD_GRADS, got, want, again):
        assert chip_smoke.grad_err(u, v) <= chip_smoke.SSD_BWD_TOL, name
        assert torch.equal(u, w), name


def test_ssd_scan_backward_under_stress_decays(dev):
    """dt x 300 and A x 4 at mamba2's widths: finite gradients, a's within
    SSD_BWD_STRESS_DA_TOL (chip_smoke.py says why), the others within
    SSD_BWD_TOL."""
    (x, dt, a, bm, cm, d), _ = chip_smoke.ssd_operands(torch, dev, 1, 512, 4, 64,
                                                       128, 9)
    got, want = chip_smoke.ssd_backward_pair(
        torch, (x, dt * 300.0, a * 4.0, bm, cm, d), None, 256, 4)
    for name, u, v in zip(chip_smoke.SSD_GRADS, got, want):
        assert bool(torch.isfinite(u).all()), name
        tol = (chip_smoke.SSD_BWD_STRESS_DA_TOL if name == "da"
               else chip_smoke.SSD_BWD_TOL)
        assert chip_smoke.grad_err(u, v) <= tol, name


def test_ssd_apply_trains_through_the_kernels_on_the_card(dev):
    """Autograd through ``ssd_apply`` on the card: the output's node is
    ``SSDScanFnBackward``, the forward and backward kernels launch once
    each, and the gradients are the backward kernel's on the forward's
    own scratch."""
    ops_, s0 = chip_smoke.ssd_operands(torch, dev, 2, 128, 4, 32, 16, 5, init=True)
    leaves = [t.clone().requires_grad_(True) for t in (*ops_, s0)]
    gen = torch.Generator(device=dev).manual_seed(6)
    dy = torch.randn((2, 128, 4, 32), device=dev, generator=gen)
    d_final = torch.randn((2, 4, 32, 16), device=dev, generator=gen)
    cuda_lib.reset_launch_counts()
    y, state = ssd_ops.ssd_apply(*leaves[:6], chunk=32, init_state=leaves[6],
                                 return_state=True)
    assert y.grad_fn.name() == "SSDScanFnBackward"
    got = torch.autograd.grad((y, state), leaves, (dy, d_final))
    assert cuda_lib.LAUNCHES["ssd_scan"] == cuda_lib.LAUNCHES["ssd_scan_bwd"] == 1
    with torch.no_grad():
        _, _, cum, states, scores = ssd_ops._forward_card(*ops_, 32, s0)
        want = ssd_ops._backward_card(dy, d_final, *ops_, 32, cum, states, scores)
    for name, u, v in zip(chip_smoke.SSD_GRADS, got, want):
        assert torch.equal(u, v), name


def test_mamba_prefill_on_the_card_launches_the_kernel(dev):
    """A reduced mamba2 (4 stacked layers, 16 heads of 32, chunk 32): the
    prefill on the card launches the kernel once per layer and agrees with
    the plain path on the CPU, and teacher-forced decode (the recurrence)
    agrees with it."""
    cfg = ARCHS["mamba2-780m"].reduced(n_layers=4)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tokens = torch.randint(0, cfg.vocab, (2, 96), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    before = cuda_lib.LAUNCHES["ssd_scan"]
    full = make_prefill_step(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["ssd_scan"] == before + cfg.n_layers
    plain = make_prefill_step(cfg)(tree_map(lambda t: t.cpu(), params),
                                   {"tokens": tokens.cpu()})
    torch.testing.assert_close(full.cpu(), plain, rtol=MODEL_TOL, atol=MODEL_TOL)
    cache = T.init_cache(cfg, 2, 96, device=dev)
    for i in range(96):
        logits, cache = T.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        torch.testing.assert_close(logits[:, 0], full[:, i], rtol=MODEL_TOL,
                                   atol=MODEL_TOL)
    assert cuda_lib.LAUNCHES["ssd_scan"] == before + cfg.n_layers


def test_batched_server_serves_mamba_on_the_card(dev):
    cfg = ARCHS["mamba2-780m"].reduced()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    reqs = [Request(rid=i, prompt=torch.arange(4 + i).numpy() % cfg.vocab,
                    max_new=5) for i in range(3)]
    stats = BatchedServer(cfg, params, 2, cache_len=69, device=dev).run(reqs)
    assert all(len(r.out) == 5 for r in reqs) and stats["tokens"] == 15


# ------------------------------------------------- the fleet control plane
# The service and the coupled solve launch no kernel of their own (their
# methods are "fused" and "alternating"); these tests hold the card's run
# against the port's own CPU run of the same seeded input: the batch log
# and the non-iteration counters exactly (under a virtual clock the close
# decisions depend on the trace alone), a* and P* at 1e-5 (P* as atol =
# rtol), as the solves are held.

def _served(device, method, power_solver, kind):
    from repro_torch.serve import (FleetControlService, ServiceConfig,
                                   bursty_trace, drive, make_cells,
                                   poisson_trace)
    cells = make_cells(3, n_devices=40, n_rounds=4, seed=11, device=device)
    if kind == "poisson":
        trace = poisson_trace(cells, rate_hz=400.0, n_requests=36, seed=3,
                              deadline_s=0.05)
    else:
        trace = bursty_trace(cells, burst_rate_hz=2000.0, burst_len=8,
                             n_bursts=4, idle_s=0.02, seed=3,
                             deadline_s=0.05)
    svc = FleetControlService(ServiceConfig(
        max_batch=4, cost_smoothing=0.0, record_batches=True, method=method,
        power_solver=power_solver), device=device)
    return svc, drive(svc, trace, clock="virtual").responses


@pytest.mark.parametrize("method,power_solver,kind", [
    ("fused", None, "poisson"), ("fused", "dinkelbach", "bursty"),
    ("alternating", None, "poisson")])
def test_service_on_the_card_matches_the_cpu_run(dev, method, power_solver,
                                                 kind):
    svc, got = _served(dev, method, power_solver, kind)
    cpu, want = _served(torch.device("cpu"), method, power_solver, kind)
    assert svc.batch_log == cpu.batch_log and len(svc.batch_log) > 1
    counts, cpu_counts = (s.stats.counter_summary() for s in (svc, cpu))
    for key in ("outer_iters", "inner_iters"):
        counts.pop(key), cpu_counts.pop(key)
    assert counts == cpu_counts
    want = {r.seq: r for r in want}
    for r in got:
        w = want[r.seq]
        assert r.warm_started == w.warm_started and r.converged
        torch.testing.assert_close(torch.from_numpy(r.solution.a),
                                   torch.from_numpy(w.solution.a),
                                   rtol=0, atol=SOLVE_TOL)
        torch.testing.assert_close(torch.from_numpy(r.solution.power),
                                   torch.from_numpy(w.solution.power),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL)


@pytest.mark.parametrize("name,kw", [
    ("metro_coupled", dict(n_cells=8, n_devices=64)),
    ("interference_grid", dict(n_cells=16, n_devices=32)),
    ("metro_coupled", dict(n_cells=4, n_devices=16, coupling_gain=0.0,
                           backhaul_fraction=None))])
def test_solve_coupled_on_the_card_matches_the_cpu_run(dev, name, kw):
    from repro_torch.core.multicell import solve_coupled
    from repro_torch.core.scenarios import make_problem
    mc = make_problem(name, seed=0, device=dev, **kw)
    sol = solve_coupled(mc)
    cpu = solve_coupled(make_problem(name, seed=0, device="cpu", **kw))
    assert sol.converged and sol.outer_iters == cpu.outer_iters
    torch.testing.assert_close(sol.batch.a.cpu(), cpu.batch.a, rtol=0,
                               atol=SOLVE_TOL)
    torch.testing.assert_close(sol.batch.power.cpu(), cpu.batch.power,
                               rtol=SOLVE_TOL, atol=SOLVE_TOL)
    warm = solve_coupled(mc, init=sol.resume)
    assert warm.outer_iters < sol.outer_iters or sol.outer_iters == 1
    if kw.get("coupling_gain") == 0.0:          # the bitwise identity
        plain = solve_joint_batch(mc.cells, method="fused")
        assert torch.equal(sol.batch.a, plain.a)
        assert torch.equal(sol.batch.power, plain.power)


def test_chaos_drive_on_the_card_leaks_nothing(dev):
    from repro_torch.serve import (FAULT_KINDS, FaultPlan, FleetControlService,
                                   ServiceConfig, chaos_drive, make_cells,
                                   poisson_trace)
    cells = make_cells(3, n_devices=40, n_rounds=4, seed=11, device=dev)
    trace = poisson_trace(cells, rate_hz=400.0, n_requests=40, seed=2)
    svc = FleetControlService(ServiceConfig(cost_smoothing=0.0), device=dev)
    rep = chaos_drive(svc, trace, FaultPlan(kinds=FAULT_KINDS, seed=2,
                                            fault_rate=0.5, device_rate=0.25))
    assert len(rep.report.responses) == len(trace)
    assert rep.nan_escapes == 0 and rep.n_unhealthy_devices > 0


# ------------------------------------------------------------ closed loop

CLOSED_LOOP = dict(n_devices=16, n_rounds=4, n_train=256, n_test=64,
                   eval_every=2)
CLOSED_LOOP_GATED = ("expected_participants", "mean_participants", "mean_bits",
                     "total_energy_j", "completion_time_s")


@pytest.mark.parametrize("faulted", [False, True])
def test_closed_loop_on_the_card_matches_the_cpu_run(dev, faulted, tmp_path):
    """The control trace at 1e-5 with equal counts, and every strategy's
    accounting at 1e-5 relative: the masks come from CPU generators and
    the minibatches from numpy on both devices."""
    from repro_torch.fl.closed_loop import ClosedLoopConfig, run_closed_loop_grid
    from repro_torch.serve import FaultPlan
    fp = FaultPlan(seed=3, device_rate=0.25, drop_rate=0.3) if faulted else None
    outs = []
    for where in (dev, torch.device("cpu")):
        cfg = ClosedLoopConfig(**CLOSED_LOOP, fault_plan=fp,
                               checkpoint_dir=str(tmp_path / where.type)
                               if faulted else None)
        outs.append(run_closed_loop_grid(cfg, device=where))
    card, cpu = outs
    for key in ("warm_rounds", "inner_iters", "outer_iters"):
        assert card["control"][key] == cpu["control"][key], key
    for name, row in cpu["strategies"].items():
        for key in CLOSED_LOOP_GATED:
            assert card["strategies"][name][key] == pytest.approx(
                row[key], rel=SOLVE_TOL), (name, key)
    if faulted:
        assert card["faults"]["n_unhealthy_devices"] > 0


def test_closed_loop_resume_on_the_card_is_bit_for_bit(dev, tmp_path):
    from repro_torch.core.scenarios import make_problem
    from repro_torch.fl.closed_loop import solve_rounds
    from repro_torch.serve import FleetControlService, ServiceConfig
    prob = make_problem("drifting_metro", seed=0, n_devices=100, n_rounds=8,
                        device="cpu")
    ref = solve_rounds(prob, FleetControlService(ServiceConfig(), device=dev))
    svc = FleetControlService(ServiceConfig(), device=dev)
    run, calls = svc.run, [0]

    def crashy(reqs=None):
        if calls[0] >= 3:
            raise RuntimeError("simulated crash")
        calls[0] += 1
        return run(reqs)
    svc.run = crashy
    with pytest.raises(RuntimeError, match="simulated crash"):
        solve_rounds(prob, svc, checkpoint_dir=str(tmp_path))
    res = solve_rounds(prob, FleetControlService(ServiceConfig(), device=dev),
                       checkpoint_dir=str(tmp_path))
    assert torch.equal(res.a, ref.a) and torch.equal(res.power, ref.power)
    assert (res.warm_rounds, res.inner_iters, res.outer_iters) == (
        ref.warm_rounds, ref.inner_iters, ref.outer_iters)


def test_quantized_kernel_on_drop_zeroed_coefficients(dev, monkeypatch):
    """The faulted joint_bits sweep's rounds: their stacked gradients,
    their coefficients (zero exactly where an attempted upload was lost,
    positive for the survivors) and their widths, the kernel against its
    plain version, bit for bit."""
    from repro_torch.fl import closed_loop, scan_engine
    from repro_torch.fl.closed_loop import ClosedLoopConfig, run_closed_loop_grid
    from repro_torch.serve import FaultPlan
    captured, plans = [], []
    orig = scan_engine.quantized_aggregate_pytree
    sweep = closed_loop.run_fl_sweep

    def capture(gstack, coef, bits, *, generator=None, noise=None):
        if noise is None:
            noise = agg_ops.uniform_noise_like(gstack, generator)
        captured.append((gstack, coef, bits, noise))
        return orig(gstack, coef, bits, noise=noise)

    def record(plan, *a, **kw):
        plans.append(plan)
        return sweep(plan, *a, **kw)
    monkeypatch.setattr(scan_engine, "quantized_aggregate_pytree", capture)
    monkeypatch.setattr(closed_loop, "run_fl_sweep", record)
    cfg = ClosedLoopConfig(**CLOSED_LOOP, n_seeds=2, fault_plan=FaultPlan(
        seed=3, device_rate=0.25, drop_rate=0.3))
    run_closed_loop_grid(cfg, strategies=("joint_bits",), device=dev)
    assert len(plans) == 1 and plans[0].drops is not None
    assert len(captured) == cfg.n_rounds
    n_lost = 0
    for k, (gstack, coef, bits, noise) in enumerate(captured):
        attempted = plans[0].masks[:, k].to(coef.device)
        lost = attempted & plans[0].drops[:, k].to(coef.device)
        assert bool((coef[lost] == 0).all()), k
        assert bool((coef[attempted & ~lost] > 0).all()), k
        n_lost += int(lost.sum())
        assert set(bits.unique().tolist()) <= {8.0, 16.0, 32.0}
        for g, u in zip(tree_leaves(gstack), tree_leaves(noise)):
            t, n = coef.shape
            flat = g.reshape(t, n, -1).contiguous()
            uf = u.reshape(t, n, -1).contiguous()
            levels = agg_ref.quantizer_levels(bits).contiguous()
            scale = agg_ops.row_scale(flat, levels)
            out = agg_ops.quantized_masked_aggregate_batched(flat, coef, uf,
                                                             scale, levels)
            plain = agg_ref.quantized_masked_aggregate_ref(flat, coef, uf,
                                                           scale, levels)
            assert torch.equal(out, plain), k
    assert n_lost > 0


# ------------------------------------------------------- training on the card
# Kernel 5 trains through its hand-written backward (``SSDScanFn``); kernel
# 6 has none, and under autograd its wrapper raises rather than return an
# output without ``grad_fn`` (which would drop every gradient before it).
# The training paths are held against the port's own CPU step at the CPU
# tests' tolerances (``tests/test_torch_train.py``): loss 1e-5, grad_norm
# 1e-4, parameters within lr a step and all but 1e-3 of them within 1e-5.

def test_swa_decode_refuses_autograd_on_the_card(dev):
    q, k, v = chip_smoke.decode_operands(torch, dev, 2, 64, 1, 4, 64, seed=0)
    qpos = 70
    pos = chip_smoke.ring_positions(torch, 64, qpos, dev)
    with pytest.raises(NotImplementedError, match="kernel 6"):
        swa_ops.swa_decode(q.clone().requires_grad_(True), k, v, pos, qpos,
                           window=None)
    swa_ops.swa_decode(q, k, v, pos, qpos, window=None)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-780m", 2), ("zamba2-7b", 13)])
def test_ssm_train_step_on_the_card_matches_the_cpu(dev, arch, n_layers):
    """A reduced mamba2 and zamba2 (two stacked units of five Mamba2
    mixers and the shared block, and a tail), two steps: every mixer
    launches kernel 5's backward once a step, and its forward once, or
    twice in a stacked unit under remat "full" (``mixer_launches``)."""
    cfg = ARCHS[arch].reduced(n_layers=n_layers)
    launches = chip_smoke.train_against_cpu(torch, dev, cfg, (2, 64, 2), arch, "")
    assert launches == dict(zip(("ssd_scan", "ssd_scan_bwd"),
                                chip_smoke.mixer_launches(cfg, 2)))


def test_dense_train_step_on_the_card_matches_the_cpu(dev):
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    cfg = get_arch("demo-100m").reduced()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    step, opt = make_train_step(cfg, lr=3e-4, q_chunk=128)
    state, host_state = opt.init(params), opt.init(host)
    gen = torch.Generator().manual_seed(2)
    before = dict(cuda_lib.LAUNCHES)
    for _ in range(3):
        tokens = torch.randint(0, cfg.vocab, (4, 64), generator=gen)
        w = torch.rand(4, generator=gen)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
                 "loss_weights": w / w.sum()}
        params, state, m = step(params, state,
                                {k: t.to(dev) for k, t in batch.items()})
        host, host_state, hm = step(host, host_state, batch)
        torch.testing.assert_close(m["loss"].cpu(), hm["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(m["grad_norm"].cpu(), hm["grad_norm"],
                                   rtol=1e-4, atol=0)
    apart = total = 0
    for a, b in zip(tree_leaves(params), tree_leaves(host)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 3 * 3e-4
        apart += int((d > 1e-5).sum())
        total += d.numel()
    assert apart <= 1e-3 * total
    assert dict(cuda_lib.LAUNCHES) == before     # no kernel on this path


# ------------------------------------------------------- the analysis gate

@pytest.mark.parametrize("k", [0, 1, 3])
def test_sync_debug_counts_each_item(dev, k):
    x = torch.arange(4.0, device=dev)
    with HostSyncBudget(None, strict=False) as hs:
        for _ in range(k):
            x.sum().item()
    assert hs.count == hs.syncs == k
    assert [r.kind for r in hs.sync_reads] == ["sync_debug"] * k
    assert hs.sites() == hs.sites(hs.sync_reads)


def test_explicit_synchronize_is_counted_and_restored(dev):
    synchronize = torch.cuda.synchronize
    with HostSyncBudget(None, strict=False) as hs:
        torch.cuda.synchronize()
    assert torch.cuda.synchronize is synchronize
    assert torch.cuda.get_sync_debug_mode() == 0
    assert (hs.count, hs.syncs) == (0, 1)
    assert hs.sync_reads[0].kind == "synchronize"


def test_reads_and_syncs_agree_on_solve_joint_fused(dev):
    result = hotpaths.measure("solve_joint_fused", dev)
    assert result["steady_reads"] == result["steady_syncs"] >= 2
    assert result["steady_read_sites"] == result["steady_sync_sites"]


def test_no_build_or_load_after_a_warmup_that_loads_the_library(
        dev, monkeypatch):
    monkeypatch.setattr(cuda_lib, "_library", None)
    result = hotpaths.measure("scan_engine_sweep", dev)
    assert result["warmup_loads"] == 1
    assert result["steady_builds"] == result["steady_loads"] == 0
    assert result["steady_launches"] == {"masked_aggregate": 8 * 3}


@pytest.mark.parametrize("name", sorted(hotpaths.HOT_PATHS))
def test_hot_path_holds_its_budget_on_the_card(dev, name):
    result = hotpaths.measure(name, dev)
    assert hotpaths.check_budget(name, result,
                                 hotpaths.load_budgets()[name]) == [], result


def test_rank_sweep_on_the_card_is_clean(dev):
    findings, stats = sweep_rank_contract(device=dev)
    assert findings == [], "\n".join(map(str, findings))
    assert stats["n_combos"] == 486
