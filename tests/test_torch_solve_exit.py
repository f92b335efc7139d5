"""Kernels 1-2's early exit, modelled on the CPU, against the fixed trip count.

``fused_solve_kernel`` and ``selection_solve_kernel``
(``src/repro_torch/csrc/selection_solve.cu``) stop each element at the
first step that leaves its loop's state bitwise unchanged (the fused
fixed point's a; the bisection's lo and hi), or at the fixed trip count,
and run no bisection where a = 1 is feasible.  The CUDA kernels cannot
run here, so this file writes each kernel's loop, exit included, with
the plain ops of ``kernels/selection_solve/ref.py`` and
``core/alternating.py`` (``fused_exit_model``, ``selection_exit_model``:
test-local, not part of the package) and holds it to the fixed-trip
plain versions bit for bit (the float32 bits, NaN included), on registry
batches (static, fading, a ragged mixed batch with padded slots),
adversarial elements and Hypothesis draws, at ``n_iters`` in
{1, 2, 7, 50} with the printed eq. (13) on and off.  One case holds the
models to the reference's Pallas kernels in interpret mode at
``tests/test_torch_kernels.py``'s tolerances (a* rtol 1e-6 / atol 1e-7,
P* rtol 1e-5 / atol 1e-8).  The step counts that ``chip_smoke.py``
prices the kernels' bound on (``needed_steps``) are held to the models'.
The kernels themselves are held to the plain versions bit for bit on the
card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from hypothesis.extra import numpy as hnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.selection_solve import kernel as ref_kernel  # noqa: E402
from repro_torch.core.alternating import (FleetElements, _fused_step,  # noqa: E402
                                          fused_init)
from repro_torch.core.problem import LN2  # noqa: E402
from repro_torch.core.scenarios import make_batch, make_mixed_batch  # noqa: E402
from repro_torch.kernels.selection_solve import ref  # noqa: E402

torch.set_num_threads(1)

KW = dict(s_bits=6.4e6, tau=0.08, p_max=1.0)
A_TOL = dict(rtol=1e-6, atol=1e-7)
P_TOL = dict(rtol=1e-5, atol=1e-8)
N_ITERS = (1, 2, 7, 50)


def bits(x):
    return x.view(torch.int32)


def fused_exit_model(pg, bw, emax, ec, *, s_bits, tau, p_max,
                     n_iters=ref.N_ALT, faithful_eq13_typo=False):
    """Kernel 1's loop: ``fused_init``'s a^0, then steps of ``_fused_step``
    until one leaves a's bits unchanged or ``max(n_iters, 1)`` have run;
    an element that stops keeps its a and P.  Returns (a, P, steps)."""
    el = FleetElements(pg=pg, bw=bw, emax=emax, ec=ec)
    kw = dict(s_bits=float(s_bits), tau=float(tau), p_max=float(p_max),
              faithful_eq13_typo=bool(faithful_eq13_typo))
    step = functools.partial(_fused_step, el=el, power_solver="analytic", **kw)
    a, p = fused_init(el, **kw)
    live = torch.ones(pg.shape, dtype=torch.bool)
    steps = torch.zeros(pg.shape, dtype=torch.int64)
    for _ in range(max(n_iters, 1)):
        prev = a
        a_new, p_new, _ = step(a)
        a, p = torch.where(live, a_new, a), torch.where(live, p_new, p)
        steps += live
        live &= bits(a) != bits(prev)
    return a, p, steps


def selection_exit_model(pg, bw, emax, ec, *, s_bits, tau, p_max):
    """Kernel 2's loop: no bisection where a = 1 is feasible, else steps
    until one leaves (lo, hi) unchanged (mid has the bits of the end it
    replaces) or ``N_BISECT`` have run; then ``selection_solve_ref``'s a*
    and P*.  Returns (a, P, steps)."""
    args = (pg, bw, emax, ec, s_bits, tau, p_max)
    ones = torch.ones_like(pg)
    feas1 = ref._feasible(ones, *args)
    lo, hi = torch.zeros_like(pg), ones
    live = ~feas1
    steps = torch.zeros(pg.shape, dtype=torch.int64)
    for _ in range(ref.N_BISECT):
        mid = 0.5 * (lo + hi)
        ok = ref._feasible(mid, *args)
        moved = torch.where(ok, lo, hi)
        lo = torch.where(live & ok, mid, lo)
        hi = torch.where(live & ~ok, mid, hi)
        steps += live
        live &= bits(mid) != bits(moved)
    a = torch.where(feas1, 1.0, lo)
    expo = torch.clamp(a * s_bits / (bw * tau), max=120.0)
    p = torch.clamp(torch.expm1(expo * LN2) / pg, 0.0, p_max)
    return a, p, steps


def assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(bits(g), bits(w))


def check_fused(els, kw, n_iters, typo):
    fkw = dict(kw, n_iters=n_iters, faithful_eq13_typo=typo)
    a, p, steps = fused_exit_model(*els, **fkw)
    assert_same_bits((a, p), ref.fused_solve_ref(*els, **fkw))
    assert int(steps.min()) >= 1 and int(steps.max()) <= max(n_iters, 1)
    return a, p, steps


def check_selection(els, kw):
    a, p, steps = selection_exit_model(*els, **kw)
    assert_same_bits((a, p), ref.selection_solve_ref(*els, **kw))
    return a, p, steps


# ------------------------------------------------------------ operands

def registry(source):
    """A registry batch's flat element operands, as the kernel methods
    hand them to the kernels, and its mask (False on padded slots)."""
    batch = {"static": lambda: make_batch("paper_static", 4, seed=0, device="cpu"),
             "fading": lambda: make_batch("rayleigh_fading", 2, seed=1,
                                          device="cpu"),
             "mixed": lambda: make_mixed_batch(chip_smoke.MIXED_SCENARIOS,
                                               seed=0, device="cpu")}[source]()
    els, kw = chip_smoke.batch_operands(batch)
    mask = batch.mask.reshape(-1)      # [B, N_max], each slot's rounds after it
    return els, kw, mask.repeat_interleave(els[0].numel() // mask.numel())


def adversarial():
    """``chip_smoke.adversarial_elements``: NaN, +-inf, +-0, negative and
    subnormal gains, zero budgets, elements feasible at a = 1, and NaN or
    inf bandwidths, budgets and compute energies, on the CPU."""
    return chip_smoke.adversarial_elements(torch, 1024, 0, "cpu")


# ------------------------------------------------------------- the models

@pytest.mark.parametrize("typo", [False, True], ids=["eq13", "typo"])
@pytest.mark.parametrize("n_iters", N_ITERS)
@pytest.mark.parametrize("source", ["static", "fading", "mixed"])
def test_fused_exit_is_the_fixed_trip_count_on_registry_batches(source, n_iters,
                                                                typo):
    els, kw, mask = registry(source)
    _, _, steps = check_fused(els, kw, n_iters, typo)
    if n_iters == 50:
        # the exit is taken: about 1.5 of 50 steps an element, padded
        # slots (a zero budget) after one
        assert float(steps.double().mean()) < 3.0
        assert bool((steps[~mask] == 1).all())


@pytest.mark.parametrize("source", ["static", "fading", "mixed"])
def test_selection_exit_is_the_fixed_trip_count_on_registry_batches(source):
    els, kw, mask = registry(source)
    _, _, steps = check_selection(els, kw)
    # a feasible element's bracket closes to adjacent floats within ~35
    # steps; a padded slot's hi halves towards 2^-60 and never stops
    assert float(steps[mask].double().mean()) < 40.0
    assert bool((steps[~mask] == ref.N_BISECT).all())


@pytest.mark.parametrize("typo", [False, True], ids=["eq13", "typo"])
@pytest.mark.parametrize("n_iters", N_ITERS)
def test_fused_exit_is_the_fixed_trip_count_on_adversarial_elements(n_iters,
                                                                   typo):
    els, kw = adversarial()
    a, _, _ = check_fused(els, kw, n_iters, typo)
    assert bool(torch.isnan(a).any())       # the NaN cases reach the output


def test_selection_exit_is_the_fixed_trip_count_on_adversarial_elements():
    els, kw = adversarial()
    a, _, steps = check_selection(els, kw)
    one = ref._feasible(torch.ones_like(els[0]), *els, kw["s_bits"], kw["tau"],
                        kw["p_max"])
    assert bool(one.any()) and bool((a[one] == 1.0).all())
    assert bool((steps[one] == 0).all()) and int(steps.max()) == ref.N_BISECT


def _finite_or_not(lo, hi):
    lo, hi = float(np.float32(lo)), float(np.float32(hi))
    return st.one_of(st.floats(lo, hi, width=32),
                     st.floats(width=32, allow_nan=True, allow_infinity=True))


def _operands(lo, hi):
    return hnp.arrays(np.float32, 16, elements=_finite_or_not(lo, hi))


@settings(max_examples=60, deadline=None, database=None)
@given(pg=_operands(1e4, 1e12), bw=_operands(5e4, 1e9),
       emax=_operands(0.0, 1e3), ec=_operands(1e-6, 0.2),
       s_bits=st.floats(1e3, 1e8), tau=st.floats(1e-3, 2.0),
       p_max=st.floats(1e-3, 10.0), n_iters=st.sampled_from(N_ITERS),
       typo=st.booleans())
def test_exit_models_are_the_fixed_trip_count_on_any_input(pg, bw, emax, ec,
                                                           s_bits, tau, p_max,
                                                           n_iters, typo):
    els = [torch.from_numpy(x) for x in (pg, bw, emax, ec)]
    kw = dict(s_bits=s_bits, tau=tau, p_max=p_max)
    check_fused(els, kw, n_iters, typo)
    check_selection(els, kw)


@pytest.mark.parametrize("kernel", ["fused", "selection"])
def test_exit_models_match_the_reference_pallas_kernels(kernel):
    """The reference's Pallas kernels in interpret mode, on [2, 128] tiles
    of its kernel tests' distributions with elements feasible at a = 1."""
    rng = np.random.default_rng(11)
    pg, bw = rng.uniform(1e4, 1e8, (2, 128)), rng.uniform(5e4, 5e6, (2, 128))
    emax = np.exp(rng.uniform(-7, 4, (2, 128)))
    ec = np.exp(rng.uniform(-8, -2, (2, 128)))
    pg[:, ::9], bw[:, ::9], emax[:, ::9] = 1e12, 1e9, 1e3
    ops = [x.astype(np.float32) for x in (pg, bw, emax, ec)]
    els = [torch.from_numpy(x.reshape(-1)) for x in ops]
    if kernel == "fused":
        want = ref_kernel.fused_solve_tiled(*map(jnp.asarray, ops), **KW,
                                            n_iters=7, rows=2, interpret=True)
        a, p, _ = fused_exit_model(*els, **KW, n_iters=7)
    else:
        want = ref_kernel.selection_solve_tiled(*map(jnp.asarray, ops), **KW,
                                                rows=2, interpret=True)
        a, p, steps = selection_exit_model(*els, **KW)
        assert bool((steps == 0).any())
    np.testing.assert_allclose(a.numpy(), np.asarray(want[0]).reshape(-1), **A_TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(want[1]).reshape(-1), **P_TOL)


@pytest.mark.parametrize("source", ["mixed", "adversarial"])
def test_chip_smoke_counts_the_steps_the_models_take(source):
    """``chip_smoke.needed_steps`` (the plain version step by step, which
    prices the kernels' bound on the card) counts each element's steps as
    the models take them."""
    els, kw = adversarial() if source == "adversarial" else registry(source)[:2]
    for name, model in (("fused_solve", fused_exit_model),
                        ("selection_solve", selection_exit_model)):
        assert torch.equal(chip_smoke.needed_steps(torch, name, els, kw),
                           model(*els, **kw)[2])
