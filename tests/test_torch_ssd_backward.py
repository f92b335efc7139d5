"""The SSD scan's backward (``kernels.ssd_scan.ops.SSDScanFn``) against
the JAX reference's autodiff, on the CPU, where the Function runs its
plain backward passes (``ref.ssd_bwd_passes_ref``); the CUDA kernel
itself is held against those passes in ``tests/test_torch_cuda.py`` and
by ``chip_smoke.py``.

Inputs and cotangents are drawn with numpy from a seed.  Each gradient is
compared in max-norm: max|got - want| over max|want| (a gradient below
float32's smallest normal counts as zero).  Tolerances:

* against ``jax.vjp`` of the reference's unchunked ``ssd_chunked``, both
  in float32: 1e-5 (the same gradient by another order of operations;
  measured at most 1.4e-6);
* the Function in float64 against ``torch.autograd`` of
  ``ssd_chunked_ref`` in float64: 1e-12 (measured at most 2e-15);
* under the stress decays (dt x 300, A x 4): dx, dB, dC and dD against
  the reference at 1e-5; dt's and a's gradients at 1e-3, a's against
  ``jax.vjp`` of the reference's ``ssd_chunked`` in float64 (under
  ``jax.enable_x64``).  Their float32 inputs are only as good as the
  forward's float32 cumsum of decays of hundreds per step (ulp about
  2e-3 at |cum| near 3e4), which puts the port's a-gradient at 2.4e-4 /
  3.3e-4 (zero / drawn initial state) of the reference's float64 one;
  the reference's own float32 a-gradient adds the rounding of the
  diagonal's terms, which cancel exactly and which the port leaves out
  (7.9e-3 / 4.6e-3 from its float64 one, so it is not the yardstick
  there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_M
from repro_torch.configs import ARCHS
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan.ops import SSDScanFn, ssd_apply
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T

torch.set_num_threads(1)

REF_TOL = 1e-5
F64_TOL = 1e-12
STRESS_TOL = 1e-3
GRADS = ("dx", "ddt", "da", "dB", "dC", "dD", "d_init")
# (B, S, H, P, N, chunk): four chunks; ragged widths over three
SHAPES = [(2, 64, 3, 8, 16, 16), (1, 192, 2, 24, 20, 64)]


def _draw(b, s, h, p, n, seed, init, stress=False):
    """Operands as the reference's kernel tests draw them (init_state or
    None), and the cotangents of y and the final state."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, h).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    d = rng.normal(size=h).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    d_final = rng.normal(size=(b, h, p, n)).astype(np.float32)
    if stress:
        dt, a = dt * np.float32(300.0), a * np.float32(4.0)
    return [x, dt, a, bm, cm, d, s0], dy, d_final


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), np.finfo(np.float32).tiny)
    return float(np.abs(got - want).max() / scale)


def _port_grads(operands, dy, d_final, chunk, dtype=torch.float32):
    """The port's gradients through ``ssd_apply`` (None for an absent
    init_state)."""
    leaves = [None if v is None else torch.from_numpy(v).to(dtype).requires_grad_(True)
              for v in operands]
    y, state = ssd_apply(*leaves[:6], chunk=chunk, init_state=leaves[6],
                         return_state=True)
    assert y.grad_fn.name() == "SSDScanFnBackward"
    live = [t for t in leaves if t is not None]
    got = torch.autograd.grad(
        (y, state), live, (torch.from_numpy(dy).to(dtype),
                           torch.from_numpy(d_final).to(dtype)))
    return [g.detach().numpy() for g in got]


def _ref_grads(operands, dy, d_final, chunk, x64=False):
    """``jax.vjp`` of the reference's ``ssd_chunked``: in float32, or with
    ``x64`` on the same values in float64."""
    dtype = jnp.float64 if x64 else jnp.float32
    init = operands[6] is not None

    def f(*args):
        return ref_M.ssd_chunked(*args[:6], chunk=chunk,
                                 init_state=args[6] if init else None)
    with jax.enable_x64(x64):
        live = [jnp.asarray(v, dtype) for v in operands if v is not None]
        _, vjp = jax.vjp(f, *live)
        cot = (jnp.asarray(dy, dtype), jnp.asarray(d_final, dtype))
        return [np.asarray(g) for g in vjp(cot)]


def _f64_grads(operands, dy, d_final, chunk):
    """``torch.autograd`` of the plain chunked form in float64."""
    leaves = [torch.from_numpy(v).double().requires_grad_(True)
              for v in operands if v is not None]
    init = operands[6] is not None
    y, state = ssd_chunked_ref(*leaves[:6], chunk, leaves[6] if init else None)
    got = torch.autograd.grad((y, state), leaves,
                              (torch.from_numpy(dy).double(),
                               torch.from_numpy(d_final).double()))
    return [g.numpy() for g in got]


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("shape", SHAPES, ids=["4_chunks", "ragged"])
def test_backward_matches_reference_vjp(shape, init):
    """Every gradient, with a nonzero cotangent of the final state."""
    b, s, h, p, n, chunk = shape
    operands, dy, d_final = _draw(b, s, h, p, n, s + chunk, init)
    got = _port_grads(operands, dy, d_final, chunk)
    want = _ref_grads(operands, dy, d_final, chunk)
    assert len(got) == len(want) == (7 if init else 6)
    for name, u, v in zip(GRADS, got, want):
        assert u.shape == v.shape, name
        assert _err(u, v) <= REF_TOL, (name, _err(u, v))


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
@pytest.mark.parametrize("shape", SHAPES, ids=["4_chunks", "ragged"])
def test_backward_in_float64_matches_autograd(shape, init):
    b, s, h, p, n, chunk = shape
    operands, dy, d_final = _draw(b, s, h, p, n, 3 * s + chunk, init)
    got = _port_grads(operands, dy, d_final, chunk, dtype=torch.float64)
    want = _f64_grads(operands, dy, d_final, chunk)
    for name, u, v in zip(GRADS, got, want):
        assert _err(u, v) <= F64_TOL, (name, _err(u, v))


@pytest.mark.parametrize("init", [False, True], ids=["zero_state", "init_state"])
def test_backward_under_stress_decays(init):
    """dt x 300 and A x 4: above the diagonal exp(cum[l] - cum[s])
    overflows and must not leak into a gradient."""
    operands, dy, d_final = _draw(1, 256, 2, 16, 12, 5, init, stress=True)
    got = _port_grads(operands, dy, d_final, 64)
    want = _ref_grads(operands, dy, d_final, 64)
    exact = _ref_grads(operands, dy, d_final, 64, x64=True)
    assert all(w.dtype == np.float64 for w in exact)
    assert all(np.isfinite(u).all() for u in got)
    for name, u, v, w in zip(GRADS, got, want, exact):
        if name == "da":
            assert _err(u, w) <= STRESS_TOL, (name, _err(u, w))
        elif name == "ddt":
            assert _err(u, v) <= STRESS_TOL, (name, _err(u, v))
        else:
            assert _err(u, v) <= REF_TOL, (name, _err(u, v))


@pytest.mark.parametrize("wanted", [(0,), (1, 2), (3, 4, 6), (5,)],
                         ids=["x", "dt_a", "b_c_init", "d"])
def test_backward_returns_none_where_not_needed(wanted):
    """The node's backward returns a gradient for exactly the operands
    that require one (and none for the chunk), each equal to the one
    computed with every operand requiring its gradient."""
    operands, dy, d_final = _draw(1, 32, 2, 4, 8, 0, init=True)
    every = [torch.from_numpy(v).requires_grad_(True) for v in operands]
    some = [torch.from_numpy(v).requires_grad_(i in wanted)
            for i, v in enumerate(operands)]
    cot = (torch.from_numpy(dy), torch.from_numpy(d_final))
    full = SSDScanFn.apply(*every, 8)[0].grad_fn.apply(*cot)
    part = SSDScanFn.apply(*some, 8)[0].grad_fn.apply(*cot)
    assert len(part) == 8 and part[7] is None
    for i in range(7):
        if i in wanted:
            assert torch.equal(part[i], full[i])
        else:
            assert part[i] is None


def test_backward_without_state_cotangent():
    """A caller that drops the final state passes no cotangent for it:
    the gradients equal those with a zero one."""
    operands, dy, _ = _draw(2, 64, 3, 8, 16, 4, init=True)
    zeros = np.zeros((2, 3, 8, 16), np.float32)
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in operands]
    y = ssd_apply(*leaves[:6], chunk=16, init_state=leaves[6])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = _port_grads(operands, dy, zeros, 16)
    for name, u, v in zip(GRADS, got, want):
        assert np.array_equal(u.numpy(), v), name


def test_mamba2_train_step_reaches_the_function(monkeypatch):
    """A reduced mamba2's train step under autograd goes through the
    Function: every scan's output has its node, the backward runs the
    plain passes once per layer (the forward twice, under remat "full"),
    and nothing raises."""
    cfg = ARCHS["mamba2-780m"].reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    nodes, passes = [], []
    real_apply, real_bwd = SSDScanFn.apply, ops.ssd_bwd_passes_ref

    def recording_apply(*args):
        out = real_apply(*args)
        nodes.append(out[0].grad_fn.name() if out[0].grad_fn else None)
        return out

    def counting_bwd(*args):
        passes.append(1)
        return real_bwd(*args)

    monkeypatch.setattr(SSDScanFn, "apply", recording_apply)
    monkeypatch.setattr(ops, "ssd_bwd_passes_ref", counting_bwd)
    step, opt = make_train_step(cfg, q_chunk=128)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 64)))
    new, _, metrics = step(params, opt.init(params),
                           {"tokens": tokens, "labels": tokens})
    assert nodes == ["SSDScanFnBackward"] * (2 * cfg.n_layers)
    assert len(passes) == cfg.n_layers
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    a_log = new["stack"]["l0"]["mamba"]["A_log"]
    assert not torch.equal(a_log, params["stack"]["l0"]["mamba"]["A_log"])
