"""Parity of the port's MLA and MoE blocks with the JAX reference, and of
the two archs that use them: deepseek-v2-lite-16b (MLA, a dense first
layer, then MoE layers with 2 shared experts) and llama4-scout-17b-a16e
(three chunked-local RoPE layers and one global NoPE layer a period, an
MoE with one shared expert on every layer).

Both packages run the same inputs in one process: numpy draws from a
seed, and the reference's parameters carried across as numpy
(``convert.params_from_numpy``).  Tolerances:

* ``mla_apply``, ``mla_decode_step``, ``moe_apply`` (output and its three
  aux values) and ``lm_loss`` (total, ce, load balance, z-loss, dropped
  share): 1e-5; ``lm_loss``'s gradients 1e-4 of each leaf's max-norm, as
  ``test_torch_train.py``'s;
* whole-model logits and aux at 1e-4, for forward and for every
  teacher-forced decode step;
* the server's completions token for token, after checking that every
  emitted token wins its argmax by more than 1e-3 in the reference.

Routing is discrete: where a token's k-th and (k+1)-th router
probabilities are within rounding of each other, the two packages may
pick different experts, and its outputs then differ far beyond any
tolerance.  So every test that routes random data first asserts that the
reference's top-k margins (k-th minus (k+1)-th probability of every
token, at every MoE layer) exceed 1e-5: the two packages' router
probabilities on the same rows are at most 6e-7 apart (measured on the
reduced models' forward inputs), and the smallest margin these tests
meet is 7.5e-5 (deepseek's server replay).  The ``moe_apply`` cases route
through a router that reads a random permutation of well-spaced scores
per token (the margins hold by construction, the choices stay random);
exact ties have a test of their own, where both packages put the lower
expert index first.

The reduced configs: deepseek at 3 layers (the dense MLA prefix and two
stacked MLA+MoE units, 4 experts top-2 with shared experts), llama4 at 8
(two stacked periods, 4 experts top-1, a window of 64 that the decode
runs wrap) and llama4 with 10 query heads over 2 KV heads, so that its
decode takes G = 5 through the decode kernel's plain version.  Their
capacity factor is 8.0 (no drop); ``lm_loss`` is also held at 1.0,
where tokens drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import MLAConfig as RefMLAConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.launch import serve as ref_serve
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import transformer as ref_T
from repro.models import zoo as ref_zoo
from repro_torch.configs import ARCHS, NOT_PORTED, get_arch
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.swa_decode import ops as swa_ops
from repro_torch.launch import serve
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      value_and_grad)
from repro_torch.models import mla, moe
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.tree import tree_leaves, tree_leaves_with_path

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL = 1e-4
MARGIN = 1e-3          # the server's argmax
ROUTE_MARGIN = 1e-5    # the router's k-th against (k+1)-th probability
DEEPSEEK, LLAMA4 = "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"
MOE_ARCHS = (DEEPSEEK, LLAMA4)
# the reference's param_count at full width: (all, active_only=True)
FULL_PARAMS = {DEEPSEEK: (15_496_769_024, 2_451_435_008),
               LLAMA4: (106_736_358_400, 16_139_392_000)}
# llama4's card run: one 4-layer period of its 48 layers
LLAMA4_4_PARAMS = 9_843_880_960
# the whole-model cases: (arch, reduced layers, llama4's 10 heads over 2)
MODELS = {"deepseek": (DEEPSEEK, 3, False), "llama4": (LLAMA4, 8, False),
          "llama4-g5": (LLAMA4, 8, True)}
STEPS = 130            # decode steps (and forward's length): past the rings of 64


def np_(x):
    return x.detach().cpu().numpy()


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


class RouteMargins:
    """The reference's ``moe_apply`` wrapped, inside the block, to record
    every call's top-k margins (through ``jax.debug.callback``, so jitted
    and scanned calls report too)."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        self._orig = orig = ref_moe.moe_apply

        def spy(params, x, cfg, act="silu"):
            probs = jax.nn.softmax((x @ params["router"]).astype(jnp.float32), -1)
            top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
            jax.debug.callback(lambda m: self.seen.append(np.asarray(m)),
                               top[:, cfg.top_k - 1] - top[:, cfg.top_k])
            return orig(params, x, cfg, act)

        ref_moe.moe_apply = spy
        return self

    def __exit__(self, *exc):
        ref_moe.moe_apply = self._orig

    def check(self, calls: int):
        """At least ``calls`` MoE calls seen, every margin above the bound."""
        jax.effects_barrier()
        assert len(self.seen) >= calls, len(self.seen)
        low = min(float(m.min()) for m in self.seen)
        assert low > ROUTE_MARGIN, low


# ---------------------------------------------------------- the registry

def test_registry_holds_the_moe_archs():
    for name in MOE_ARCHS:
        assert get_arch(name) is ARCHS[name]
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(REF_ARCHS[name])
    assert NOT_PORTED == ("internvl2-2b", "whisper-large-v3")
    assert sorted(ARCHS) == sorted(set(REF_ARCHS) - set(NOT_PORTED))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_param_tree_matches_reference_at_full_width(name):
    """The "meta" tree against ``jax.eval_shape`` of the reference's (every
    path and shape), and the decode cache's leaves."""
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    ref = jax.eval_shape(lambda k: ref_T.init_params(ref_cfg, k),
                         jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator(), device="meta")
    assert _shapes(got) == _shapes(ref)
    assert all(x.device.type == "meta" for x in tree_leaves(got))
    cache = T.init_cache(cfg, 2, 64, device="meta")
    ref_cache = jax.eval_shape(lambda: ref_T.init_cache(ref_cfg, 2, 64, jnp.float32))
    assert [tuple(x.shape) for x in tree_leaves(cache)] == \
        [x.shape for x in jax.tree_util.tree_leaves(ref_cache)]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_counts_match_reference(name):
    """``param_count``, ``active_only=True`` and ``n_active_params`` equal
    the reference's for every ported arch, and the two MoE archs' known
    integers."""
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    total, active = zoo.param_count(cfg), zoo.param_count(cfg, active_only=True)
    assert total == ref_zoo.param_count(ref_cfg) == cfg.n_params()
    assert active == ref_zoo.param_count(ref_cfg, active_only=True) \
        == cfg.n_active_params()
    if name in FULL_PARAMS:
        assert (total, active) == FULL_PARAMS[name]
    else:
        assert active == total


def test_llama4_card_cut_count():
    """One whole period (three local RoPE layers, one global NoPE layer),
    unrolled: a single unit is not stacked."""
    cfg = dataclasses.replace(ARCHS[LLAMA4], n_layers=4)
    plan = T.layer_plan(cfg)
    assert plan.reps == 0 and [k[0] for k in plan.prefix] == \
        ["attn", "attn", "attn", "gattn"]
    assert zoo.param_count(cfg) == LLAMA4_4_PARAMS


def test_leaves_with_path_name_the_experts():
    tree = {"b": [{"experts": {"w1": 1}}, 2], "a": mla.MLACache(3, 4, 5)}
    assert tree_leaves_with_path(tree) == [
        (("a", "c_kv"), 3), (("a", "k_rope"), 4), (("a", "pos"), 5),
        (("b", 0, "experts", "w1"), 1), (("b", 1), 2)]
    assert [leaf for _, leaf in tree_leaves_with_path(tree)] == tree_leaves(tree)


# ------------------------------------------------------------------- MLA

MLA_KW = dict(kv_lora_rank=64, rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
MLA_D, MLA_H, MLA_THETA = 64, 4, 10_000.0


def _mla_params(seed):
    p = np_tree(ref_mla.mla_init(jax.random.PRNGKey(seed), MLA_D, MLA_H,
                                 RefMLAConfig(**MLA_KW)))
    return p, params_from_numpy(p, "cpu")


@pytest.mark.parametrize("s,q_chunk", [(64, 16), (64, 64), (64, 1024), (60, 16)])
def test_mla_apply_matches_reference(s, q_chunk):
    """Chunked (64 = 4 x 16), one chunk, and the rule's unchunked cases:
    a chunk longer than the sequence and a sequence it does not tile."""
    ref_p, p = _mla_params(0)
    x = np.random.default_rng(1).normal(size=(2, s, MLA_D)).astype(np.float32)
    ref = ref_mla.mla_apply(ref_p, jnp.asarray(x), jnp.arange(s, dtype=jnp.int32),
                            MLA_H, RefMLAConfig(**MLA_KW), MLA_THETA, q_chunk)
    got = mla.mla_apply(p, torch.from_numpy(x), torch.arange(s, dtype=torch.int32),
                        MLA_H, MLAConfig(**MLA_KW), MLA_THETA, q_chunk)
    np.testing.assert_allclose(np_(got), np.asarray(ref), **LAYER_TOL)


def test_mla_decode_step_matches_reference_past_cache_len():
    """24 steps into a cache of 16: positions 16..23 write the last slot,
    as the reference's clamped ``dynamic_update_slice``; every step's
    output and the final cache against the reference's."""
    ref_p, p = _mla_params(2)
    ref_cfg, cfg = RefMLAConfig(**MLA_KW), MLAConfig(**MLA_KW)
    xs = np.random.default_rng(3).normal(size=(24, 2, 1, MLA_D)).astype(np.float32)
    ref_cache = ref_mla.mla_cache_init(2, 16, ref_cfg, jnp.float32)
    cache = mla.mla_cache_init(2, 16, cfg, device="cpu")
    ref_step = jax.jit(lambda c, x, pos: ref_mla.mla_decode_step(
        ref_p, x, pos, c, MLA_H, ref_cfg, MLA_THETA))
    for i in range(24):
        ref_y, ref_cache = ref_step(ref_cache, jnp.asarray(xs[i]), jnp.int32(i))
        y, cache = mla.mla_decode_step(p, torch.from_numpy(xs[i]), i, cache,
                                       MLA_H, cfg, MLA_THETA)
        np.testing.assert_allclose(np_(y), np.asarray(ref_y), **LAYER_TOL)
    assert np_(cache.pos).tolist() == list(range(15)) + [23]
    for a, b in zip(cache, ref_cache):
        np.testing.assert_allclose(np_(a), np.asarray(b), **LAYER_TOL)


def test_mla_decode_matches_forward():
    """The absorbed decode against the decompressed forward, token by
    token (the port against itself, both paths)."""
    _, p = _mla_params(4)
    cfg = MLAConfig(**MLA_KW)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 20, MLA_D)).astype(np.float32))
    full = mla.mla_apply(p, x, torch.arange(20, dtype=torch.int32), MLA_H, cfg,
                         MLA_THETA)
    cache = mla.mla_cache_init(2, 20, cfg, device="cpu")
    for i in range(20):
        y, cache = mla.mla_decode_step(p, x[:, i:i + 1], i, cache, MLA_H, cfg,
                                       MLA_THETA)
        torch.testing.assert_close(y[:, 0], full[:, i], **LAYER_TOL)


# ------------------------------------------------------------------- MoE

MOE_D, MOE_T = 64, 128


def _moe_case(e, k, cf, shared, seed, scores="spaced"):
    """The reference's MoE parameters with its router replaced by the
    identity on the first E features (d 64), and 128 tokens whose first E
    features are, per token, a random permutation of E scores: spaced
    evenly over [-2, 2] (every top-k margin is then at least about 1e-3),
    or drawn from {-1, 0, 1} ("ties": many exactly equal
    probabilities).  Returns both configs, both parameter trees and x."""
    kw = dict(n_experts=e, top_k=k, d_ff_expert=48, n_shared=int(shared),
              d_ff_shared=32 if shared else 0, capacity_factor=cf)
    ref_cfg, cfg = RefMoEConfig(**kw), MoEConfig(**kw)
    p = np_tree(ref_moe.moe_init(jax.random.PRNGKey(seed), MOE_D, ref_cfg))
    p["router"] = np.eye(MOE_D, e, dtype=np.float32)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(MOE_T, MOE_D)).astype(np.float32)
    if scores == "spaced":
        row = np.linspace(-2.0, 2.0, e, dtype=np.float32)
    else:
        row = rng.integers(-1, 2, e).astype(np.float32)
    x[:, :e] = np.stack([rng.permutation(row) for _ in range(MOE_T)])
    return ref_cfg, cfg, p, params_from_numpy(p, "cpu"), x


def _ref_margins(p, x, k):
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], -1)
    top = jax.lax.top_k(probs, k + 1)[0]
    return np.asarray(top[:, k - 1] - top[:, k])


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("e,k", [(4, 1), (8, 2), (64, 6)])
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_apply_matches_reference(cf, e, k, shared, act):
    """Output and (load balance, z-loss, dropped share) against the
    reference's.  The dropped share is also each expert's load beyond its
    capacity, summed, over T k: tokens drop at capacity factor 1.0 for
    every (E, k), at 1.25 for 64 experts (C = 16 either way), never at 8."""
    ref_cfg, cfg, ref_p, p, x = _moe_case(e, k, cf, shared, seed=e + k)
    assert _ref_margins(ref_p, x, k).min() > ROUTE_MARGIN
    ref_out, ref_aux = ref_moe.moe_apply(ref_p, jnp.asarray(x), ref_cfg, act)
    out, aux = moe.moe_apply(p, torch.from_numpy(x), cfg, act)
    np.testing.assert_allclose(np_(out), np.asarray(ref_out), **LAYER_TOL)
    for got, want in zip(aux, ref_aux):
        np.testing.assert_allclose(float(got), float(want), **LAYER_TOL)
    c = moe.capacity(MOE_T, cfg)
    assert c == ref_moe.capacity(MOE_T, ref_cfg)
    *_, idx = moe.route(p, torch.from_numpy(x), cfg)
    load = np.bincount(np_(idx).ravel(), minlength=e)
    over = np.maximum(load - c, 0).sum()
    assert float(aux.dropped_frac) == np.float32(over / (MOE_T * k))
    assert (over > 0) == (cf == 1.0 or (e == 64 and cf == 1.25))


def test_moe_ties_route_as_reference():
    """Exactly equal probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them, so the choices, their queue positions
    and the outputs match the reference's."""
    ref_cfg, cfg, ref_p, p, x = _moe_case(8, 2, 1.0, True, seed=11,
                                          scores="ties")
    assert (_ref_margins(ref_p, x, 2) == 0).sum() > 10
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ ref_p["router"], -1), 2)
    *_, idx = moe.route(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(np_(idx), np.asarray(ref_idx))
    ref_out, ref_aux = ref_moe.moe_apply(ref_p, jnp.asarray(x), ref_cfg)
    out, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(np_(out), np.asarray(ref_out), **LAYER_TOL)
    for got, want in zip(aux, ref_aux):
        np.testing.assert_allclose(float(got), float(want), **LAYER_TOL)
    assert float(aux.dropped_frac) > 0.0


@pytest.mark.parametrize("t", [1, 4, 8, 100, 1024, 4096])
def test_capacity_matches_reference(t):
    for name in MOE_ARCHS:
        for cf in (1.0, 1.25, 8.0, REF_ARCHS[name].moe.n_experts
                   / REF_ARCHS[name].moe.top_k):
            ref_cfg = dataclasses.replace(REF_ARCHS[name].moe, capacity_factor=cf)
            cfg = dataclasses.replace(ARCHS[name].moe, capacity_factor=cf)
            assert moe.capacity(t, cfg) == ref_moe.capacity(t, ref_cfg)
            if cf * cfg.top_k >= cfg.n_experts:      # C >= T: no token drops
                assert moe.capacity(t, cfg) >= t


# ------------------------------------------------------------ whole models

def _variant(cfg, g5: bool):
    """llama4 reduced with 10 query heads over 2 KV heads (G = 5)."""
    if not g5:
        return cfg
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, n_heads=10, n_kv_heads=2, d_head=32))


@pytest.fixture(scope="module", params=sorted(MODELS))
def small_model(request):
    """One reduced arch in both packages, with the reference's weights."""
    name, n_layers, g5 = MODELS[request.param]
    ref_cfg = _variant(REF_ARCHS[name].reduced(n_layers=n_layers), g5)
    cfg = _variant(ARCHS[name].reduced(n_layers=n_layers), g5)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(ref_params), device="cpu")
    return request.param, ref_cfg, cfg, ref_params, params


def _n_moe(cfg):
    return sum(k[1] == "moe" for k in T.layer_plan(cfg).all_layers())


def test_reduced_plans(small_model):
    """The reduced configs hold what the tests claim of them."""
    case, _, cfg, _, params = small_model
    plan = T.layer_plan(cfg)
    if case == "deepseek":
        assert plan.prefix == (("mla", "dense"),) and plan.reps == 2
        assert plan.unit == (("mla", "moe"),)
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared) == (4, 2, 2)
        assert "shared" in params["stack"]["l0"]["moe"]
    else:
        assert plan.reps == 2 and [k[0] for k in plan.unit] == \
            ["attn", "attn", "attn", "gattn"]
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.attn.window) == (4, 1, 64)
        assert cfg.attn.nope_on_global
        g = cfg.attn.n_heads // cfg.attn.n_kv_heads
        assert g == (5 if case == "llama4-g5" else 1)
    assert cfg.moe.capacity_factor == 8.0


def test_forward_matches_reference(small_model):
    """Logits and the MoE aux (summed over the layers) at 1e-4."""
    _, ref_cfg, cfg, ref_params, params = small_model
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, STEPS)).astype(np.int32)
    with RouteMargins() as margins:
        ref, ref_aux = ref_T.forward(ref_cfg, ref_params,
                                     {"tokens": jnp.asarray(tokens)}, remat=False)
        margins.check(_n_moe(cfg))
    got, aux = T.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)
    np.testing.assert_allclose(np_(aux), np.asarray(ref_aux), **MODEL_TOL)
    assert float(aux[0]) > 0 and float(aux[1]) > 0 and float(aux[2]) == 0
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)


def test_teacher_forced_decode_matches_reference(small_model, monkeypatch):
    """Every decode step's logits against the reference's, the caches at
    the end (llama4's local rings of 64 wrapped, deepseek's latent
    caches), and the steps against the port's own forward.  llama4's
    attention layers decode through the decode kernel's wrapper at G =
    n_heads / n_kv_heads; deepseek's MLA calls it never."""
    case, ref_cfg, cfg, ref_params, params = small_model
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, STEPS)).astype(np.int32)
    groups = []
    swa = swa_ops.swa_decode

    def spy(q, *a, **kw):
        groups.append(q.shape[2])
        return swa(q, *a, **kw)

    monkeypatch.setattr(swa_ops, "swa_decode", spy)
    ref_step = jax.jit(lambda c, t, pos: ref_T.decode_step(ref_cfg, ref_params,
                                                           c, t, pos))
    ref_cache = ref_T.init_cache(ref_cfg, 2, STEPS, dtype=jnp.float32)
    cache = T.init_cache(cfg, 2, STEPS, device="cpu")
    step = make_serve_step(cfg)
    outs = []
    with RouteMargins() as margins:
        for i in range(STEPS):
            tok = tokens[:, i:i + 1]
            ref, ref_cache = ref_step(ref_cache, jnp.asarray(tok), jnp.int32(i))
            got, cache = step(params, cache, {"tokens": torch.from_numpy(tok).long(),
                                              "pos": i})
            np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)
            outs.append(got)
        margins.check(STEPS * _n_moe(cfg))
    ours, theirs = tree_leaves(cache), jax.tree_util.tree_leaves(ref_cache)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np_(a), np.asarray(b), **MODEL_TOL)
    n_attn = sum(k[0] in ("attn", "gattn") for k in T.layer_plan(cfg).all_layers())
    g = cfg.attn.n_heads // cfg.attn.n_kv_heads
    assert groups == [g] * (STEPS * n_attn) and n_attn == (0 if case == "deepseek" else 8)
    full, _ = T.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(torch.cat(outs, dim=1)), np_(full), **MODEL_TOL)


def _check_grads(got, want):
    got = dict(tree_leaves_with_path(got))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        g, w = got.pop(key).numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= GRAD_RTOL * max(np.abs(w).max(), 1e-30), key
    assert not got


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_lm_loss_and_grads_match_reference(small_model, cf):
    """Weighted loss with -100 labels: total, ce, load balance, z-loss and
    dropped share at 1e-5, every gradient at 1e-4 of its max-norm; at
    capacity factor 1.0 tokens drop."""
    _, ref_cfg, cfg, ref_params, params = small_model
    ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
        ref_cfg.moe, capacity_factor=cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           capacity_factor=cf))
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    batch["labels"][0, :5] = -100
    w = rng.uniform(size=2).astype(np.float32)
    batch["loss_weights"] = w / w.sum()
    with RouteMargins() as margins:
        (ref_loss, ref_parts), ref_g = jax.value_and_grad(
            lambda p: ref_zoo.lm_loss(ref_cfg, p, {k: jnp.asarray(v) for k, v
                                                   in batch.items()}),
            has_aux=True)(ref_params)
        margins.check(_n_moe(cfg))
    (loss, parts), g = value_and_grad(
        lambda p: zoo.lm_loss(cfg, p, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}), params)
    np.testing.assert_allclose(float(loss), float(ref_loss), **LAYER_TOL)
    assert sorted(parts) == sorted(ref_parts)
    for k in ref_parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]), **LAYER_TOL)
    assert (float(parts["moe_dropped"]) > 0) == (cf == 1.0)
    _check_grads(g, ref_g)


def test_remat_keeps_the_aux(small_model):
    """Under remat "full" and "dots" the stacked units return (x, aux)
    through ``torch.utils.checkpoint``: loss, aux and gradients bit for
    bit those without remat."""
    _, _, cfg, _, params = small_model
    rng = np.random.default_rng(10)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))),
         "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    out = {}
    for remat in (False, "full", "dots"):
        (loss, parts), g = value_and_grad(
            lambda p: zoo.lm_loss(cfg, p, b, remat=remat), params)
        out[remat] = [loss, parts["load_balance"], parts["z_loss"]] + tree_leaves(g)
    assert float(out[False][1]) > 0
    for remat in ("full", "dots"):
        for a, w in zip(out[remat], out[False]):
            assert torch.equal(a, w)


# ------------------------------------------------------------- the server

def _requests(cls, n, vocab, gen, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, rng.integers(4, 24)).astype(np.int32),
                max_new=gen) for i in range(n)]


def _reference_margins(ref_cfg, ref_params, reqs, batch, cache_len):
    """Teacher-force the reference's decode_step over each wave's padded
    prompts and the reference's own completions; return the top-two logit
    margin of every emitted token of a real request."""
    step = jax.jit(lambda c, t, pos: ref_T.decode_step(ref_cfg, ref_params, c, t, pos))
    margins = []
    for w0 in range(0, len(reqs), batch):
        wave = reqs[w0:w0 + batch]
        wave = wave + [wave[-1]] * (batch - len(wave))
        real = len(reqs[w0:w0 + batch])
        max_prompt = max(len(r.prompt) for r in wave)
        prompts = np.stack([np.pad(r.prompt, (max_prompt - len(r.prompt), 0))
                            for r in wave])
        outs = np.array([r.out for r in wave], np.int32)
        feed = np.concatenate([prompts, outs[:, :-1]], axis=1)
        cache = ref_T.init_cache(ref_cfg, batch, cache_len, dtype=jnp.float32)
        for i in range(feed.shape[1]):
            logits, cache = step(cache, jnp.asarray(feed[:, i:i + 1]), jnp.int32(i))
            if i >= max_prompt - 1:
                top = np.sort(np.asarray(logits[:real, -1]), axis=-1)
                emitted = np.argmax(np.asarray(logits[:real, -1]), axis=-1)
                assert (emitted == outs[:real, i - max_prompt + 1]).all()
                margins.extend(top[:, -1] - top[:, -2])
    return np.array(margins)


def test_batched_server_matches_reference(small_model):
    """5 requests at gen 6 in waves of 2, cache 64 + gen: the reference's
    routing margins and argmax margins first, then the completions token
    for token."""
    _, ref_cfg, cfg, ref_params, params = small_model
    gen, batch = 6, 2
    ref_reqs = _requests(ref_serve.Request, 5, cfg.vocab, gen, seed=0)
    reqs = _requests(serve.Request, 5, cfg.vocab, gen, seed=0)
    ref_stats = ref_serve.BatchedServer(ref_cfg, ref_params, batch,
                                        cache_len=64 + gen).run(ref_reqs)
    with RouteMargins() as route:
        margins = _reference_margins(ref_cfg, ref_params, ref_reqs, batch, 64 + gen)
        route.check(_n_moe(cfg))
    assert len(margins) == 5 * gen and margins.min() > MARGIN, margins.min()
    stats = serve.BatchedServer(cfg, params, batch, cache_len=64 + gen,
                                device="cpu").run(reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(len(r.out) == gen for r in reqs)
    assert stats["decode_steps"] == ref_stats["decode_steps"]
    assert stats["tokens"] == ref_stats["tokens"] == 5 * gen


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_main_serves_each_arch_on_the_cpu(name, capsys):
    stats = serve.main(["--arch", name, "--requests", "3", "--batch", "2",
                        "--gen", "4", "--device", "cpu"])
    assert stats["requests"] == 3 and stats["tokens"] == 12
    assert f"reduced {name}-reduced on cpu" in capsys.readouterr().out
