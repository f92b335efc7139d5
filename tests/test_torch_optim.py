"""Parity of the port's optimizers (``repro_torch.optim.optimizers``) with
the JAX reference's.

Both packages take the same gradients, drawn from a numpy seed, on a
small tree shaped like the transformer's (dict keys out of sorted order,
a list, a stacked leaf).  Tolerance: 1e-6 (relative and absolute) on
every leaf after every step: the same float32 arithmetic, operation for
operation, where only ``pow``'s and ``sqrt``'s last bits and the norm's
order of summation may differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as ref_O
from repro_torch.convert import adam_state_from_numpy, params_from_numpy
from repro_torch.optim import optimizers as O
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng, scale=1.0):
    return {"stack": {"w": (rng.normal(size=(3, 4, 5)) * scale).astype(np.float32)},
            "embed": (rng.normal(size=(6, 4)) * scale).astype(np.float32),
            "tail": [{"b": (rng.normal(size=(5,)) * scale).astype(np.float32)}]}


def _check(got, want):
    got_l, want_l = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _run(ref_opt, opt, steps=4, seed=0, grad_scale=1.0):
    rng = np.random.default_rng(seed)
    params = _tree(rng, 0.1)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    p = params_from_numpy(params, device="cpu")
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for _ in range(steps):
        grads = _tree(rng, grad_scale)
        ref_u, ref_s = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                      ref_s, ref_p)
        u, s = opt.update(params_from_numpy(grads, device="cpu"), s, p)
        _check(u, ref_u)
        ref_p = ref_O.apply_updates(ref_p, ref_u)
        p = O.apply_updates(p, u)
        _check(p, ref_p)
    return ref_s, s


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])
def test_adamw_matches_reference(weight_decay, grad_scale):
    kw = dict(lr=3e-4, weight_decay=weight_decay)
    ref_s, s = _run(ref_O.adamw(**kw), O.adamw(**kw), grad_scale=grad_scale)
    assert isinstance(s, O.AdamState) and s._fields == ref_s._fields
    assert s.count.dtype == torch.int32 and s.count.ndim == 0
    assert int(s.count) == int(ref_s.count) == 4
    _check(s.mu, ref_s.mu)
    _check(s.nu, ref_s.nu)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    ref_s, s = _run(ref_O.sgd(0.05, momentum), O.sgd(0.05, momentum))
    if momentum == 0.0:
        assert s == () == ref_s
    else:
        _check(s, ref_s)


@pytest.mark.parametrize("scale", [10.0, 1e-2])
def test_clip_by_global_norm_matches_reference(scale):
    """Above the limit (scaled down) and below it (unchanged)."""
    grads = _tree(np.random.default_rng(3), scale)
    ref_g, ref_n = ref_O.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), 1.0)
    got, n = O.clip_by_global_norm(params_from_numpy(grads, device="cpu"), 1.0)
    np.testing.assert_allclose(float(n), float(ref_n), rtol=1e-6)
    _check(got, ref_g)
    if scale < 1:
        _check(got, grads)


def test_moments_are_float32_for_bfloat16_params():
    p = params_from_numpy(_tree(np.random.default_rng(4)), device="cpu")
    p = {k: v for k, v in p.items() if k != "tail"}
    p["embed"] = p["embed"].to(torch.bfloat16)
    s = O.adamw(1e-3).init(p)
    assert all(x.dtype == torch.float32 for x in tree_leaves((s.mu, s.nu)))
    g = {"stack": {"w": torch.ones(3, 4, 5)},
         "embed": torch.ones(6, 4, dtype=torch.bfloat16)}
    u, s = O.adamw(1e-3).update(g, s, p)
    assert O.apply_updates(p, u)["embed"].dtype == torch.bfloat16


def test_adam_state_from_numpy():
    """The reference's state after a few steps enters the port leaf for
    leaf, and the next step agrees."""
    kw = dict(lr=1e-3)
    ref_opt, opt = ref_O.adamw(**kw), O.adamw(**kw)
    rng = np.random.default_rng(5)
    ref_p = jax.tree_util.tree_map(jnp.asarray, _tree(rng, 0.1))
    ref_s = ref_opt.init(ref_p)
    for _ in range(3):
        g = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
        u, ref_s = ref_opt.update(g, ref_s, ref_p)
        ref_p = ref_O.apply_updates(ref_p, u)
    np_tree = jax.tree_util.tree_map(np.asarray, ref_s)
    s = adam_state_from_numpy(np_tree, device="cpu")
    assert int(s.count) == 3 and s.count.dtype == torch.int32
    _check(s.mu, ref_s.mu)
    _check(s.nu, ref_s.nu)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_p), device="cpu")
    g = _tree(rng)
    ref_u, _ = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, g), ref_s, ref_p)
    u, _ = opt.update(params_from_numpy(g, device="cpu"), s, p)
    _check(u, ref_u)
