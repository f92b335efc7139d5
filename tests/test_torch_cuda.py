"""The port's CUDA kernels on the card: each against its plain version.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode).  The file imports torch and ``repro_torch`` only, so
it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: the kernels compute in float32 with the plain versions'
operation order and no FMA contraction, so they are expected to match
bit for bit; the checks allow 1e-5 (the reference's solver tolerance)
on a* and P*, and exact equality for the eq.-4 sums, plain and
quantised, whose order of addition is the same; the decode attention
(swa_decode) at rtol = atol = 2e-5, the reference's float32 tolerance for
its decode kernel (online softmax against the dense one); the SSD scan
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
