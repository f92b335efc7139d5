"""Parity of the port's serving path (gemma3's dense decoder) with the JAX
reference.

Both packages run the same inputs in one process: numpy draws from a
seed, and the reference's parameters carried across as numpy.
Tolerances:

* the decode kernel's plain version and ``decode_attention`` against the
  reference's oracle and its Pallas kernel (interpret mode) at rtol =
  atol = 2e-5, the reference's own float32 kernel tolerance
  (``tests/test_kernels.py``);
* layers at 1e-5: float32 products summed in another order;
* whole-model logits at 1e-4: 14 layers of those differences;
* the server's completions token for token, after checking that every
  emitted token wins its argmax by more than 1e-3 in the reference, so a
  flip would be a fault and not a near-tie.

On the CPU the decode step runs the kernel's plain version; the CUDA
kernel itself is tested in ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels.swa_decode.kernel import swa_decode_tiled as ref_swa_tiled
from repro.kernels.swa_decode.ref import swa_decode_ref as ref_swa_ref
from repro.launch import serve as ref_serve
from repro.models import layers as ref_L
from repro.models import transformer as ref_T
from repro.models import zoo as ref_zoo
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels.swa_decode.ops import (decode_attention, split_count,
                                                swa_decode)
from repro_torch.kernels.swa_decode.ref import (swa_decode_ref,
                                                swa_decode_split_ref)
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
GEMMA3_1B_PARAMS = 999_826_048
# 6-layer unit (five local layers, window 64, one global) x 2 + a tail of
# two local layers: both mask branches and both RoPE bases
SMALL = dict(n_layers=14, d_model=64)


def np_(x):
    return x.detach().cpu().numpy()


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs():
    return REF_ARCHS["gemma3-1b"].reduced(**SMALL), ARCHS["gemma3-1b"].reduced(**SMALL)


@pytest.fixture(scope="module")
def small_model():
    """The reduced gemma3 in both packages, with the reference's weights."""
    ref_cfg, cfg = _cfgs()
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


# ------------------------------------------------------------- the kernel

def _decode_operands(w, hkv, g, dh, seed, b=2):
    """The reference kernel tests' operands: q [B, 1, H, dh] unscaled,
    k/v [B, W, Hkv, dh], the last 3 slots empty, qpos = W + 5."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, hkv * g, dh)).astype(np.float32)
    k = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, w, hkv, dh)).astype(np.float32)
    pos = np.where(np.arange(w) < w - 3, np.arange(w), -1).astype(np.int32)
    qg = (q[:, 0] * np.float32(dh ** -0.5)).reshape(b, hkv, g, dh)
    return q, qg, k, v, pos, w + 5


@pytest.mark.parametrize("w,hkv,g,dh,window", [
    (512, 4, 4, 64, None),
    (1024, 2, 8, 128, 300),
    (512, 1, 4, 128, 128),
    (256, 8, 1, 64, None),
])
def test_decode_plain_version_matches_reference(w, hkv, g, dh, window):
    q, qg, k, v, pos, qpos = _decode_operands(w, hkv, g, dh, w + hkv)
    ref = np.asarray(ref_swa_ref(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.int32(qpos), window=window))
    tiled = np.asarray(ref_swa_tiled(jnp.asarray(qg), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(pos),
                                     jnp.int32(qpos), window=window,
                                     kv_blk=128, interpret=True))
    t = [torch.from_numpy(x) for x in (qg, k, v, pos)]
    plain = np_(swa_decode_ref(*t, qpos, window=window))
    wrapped = np_(swa_decode(*t, qpos, window=window))
    via_layer = np_(decode_attention(torch.from_numpy(q), *t[1:], qpos,
                                     window=window, n_heads=hkv * g))
    np.testing.assert_array_equal(wrapped, plain)
    for got in (plain, via_layer.reshape(plain.shape)):
        np.testing.assert_allclose(got, ref, **KERNEL_TOL)
        np.testing.assert_allclose(got, tiled, **KERNEL_TOL)


@pytest.mark.parametrize("w,window,qpos", [(97, None, 40), (97, 64, 300),
                                           (664, 512, 700)])
def test_decode_ragged_cache_matches_reference(w, window, qpos):
    """A W the reference kernel's kv_blk rule forbids (and a wrapped
    ring), against the reference's oracle."""
    q, qg, k, v, _, _ = _decode_operands(w, 1, 4, 256, w)
    # slot s holds the latest position p <= qpos with p % W == s
    latest = qpos - (qpos - np.arange(w)) % w
    pos = np.where(latest >= 0, latest, -1).astype(np.int32)
    ref = np.asarray(ref_swa_ref(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.int32(qpos), window=window))
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, pos)),
                           qpos, window=window, n_heads=4)
    np.testing.assert_allclose(np_(got).reshape(ref.shape), ref, **KERNEL_TOL)


def _ring(w, qpos):
    """pos_buf of a ring of W slots after positions 0..qpos: slot s holds
    the latest position p <= qpos with p % W == s, or -1."""
    latest = qpos - (qpos - np.arange(w)) % w
    return np.where(latest >= 0, latest, -1).astype(np.int32)


@pytest.mark.parametrize("w,window,qpos,nsplit", [
    (97, None, 300, 1),         # one split: the whole ring
    (97, None, 300, 5),         # 5 does not divide 97
    (97, 64, 300, 7),           # a window: some splits hold no valid slot
    (97, None, 40, 6),          # a ring filling: the last splits are empty
    (10, None, 12, 4),          # the last split has no slot at all
    (664, 512, 700, 20),        # gemma3's global ring at full width
    (1, None, 0, 1),            # a single slot
])
def test_decode_split_matches_reference(w, window, qpos, nsplit):
    """The kernel's split decomposition written out
    (``swa_decode_split_ref``) against the reference's oracle at 2e-5."""
    _, qg, k, v, _, _ = _decode_operands(w, 1, 4, 64, w + nsplit)
    pos = _ring(w, qpos)
    ref = np.asarray(ref_swa_ref(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.int32(qpos), window=window))
    t = [torch.from_numpy(x) for x in (qg, k, v, pos)]
    got = np_(swa_decode_split_ref(*t, qpos, window=window, nsplit=nsplit))
    np.testing.assert_allclose(got, ref, **KERNEL_TOL)


@pytest.mark.parametrize("nsplit", [1, 3, 8])
def test_decode_split_without_valid_slots_is_zero(nsplit):
    """No valid slot at all: the kernel's output is 0, as the reference's
    Pallas kernel (interpret mode) gives, where the dense oracle would
    average V over the -1e30 scores."""
    _, qg, k, v, _, _ = _decode_operands(256, 1, 4, 64, nsplit)
    pos = np.full(256, -1, np.int32)
    tiled = np.asarray(ref_swa_tiled(*map(jnp.asarray, (qg, k, v, pos)),
                                     jnp.int32(5), window=None, kv_blk=128,
                                     interpret=True))
    got = np_(swa_decode_split_ref(*(torch.from_numpy(x) for x in (qg, k, v, pos)),
                                   5, window=None, nsplit=nsplit))
    np.testing.assert_array_equal(tiled, np.zeros_like(tiled))
    np.testing.assert_array_equal(got, tiled)


@pytest.mark.parametrize("bh,w,n_sm,want", [
    (4, 512, 132, 16),          # gemma3's serving step: 32 slots a split
    (4, 664, 132, 21),          # the last split shorter
    (4, 88, 132, 3),
    (16, 32768, 132, 17),       # about two blocks per SM
    (4, 33, 132, 2),
    (4, 32, 132, 1),            # a small ring: one split
    (1, 1, 132, 1),
    (1, 1 << 20, 132, 64),      # at most 64 splits
])
def test_split_count(bh, w, n_sm, want):
    assert split_count(bh, w, n_sm) == want


# ----------------------------------------------------------------- layers

def test_rmsnorm_rope_and_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 32)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    np.testing.assert_allclose(
        np_(L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))),
        np.asarray(ref_L.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        **LAYER_TOL)
    positions = np.arange(100, 109, dtype=np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            np_(L.rope(torch.from_numpy(x), torch.from_numpy(positions), theta)),
            np.asarray(ref_L.rope(jnp.asarray(x), jnp.asarray(positions), theta)),
            **LAYER_TOL)
    mlp = np_tree(ref_L.mlp_init(jax.random.PRNGKey(1), 32, 96))
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    for act in ("gelu", "silu"):
        np.testing.assert_allclose(
            np_(L.mlp_apply(params_from_numpy(mlp, "cpu"),
                            torch.from_numpy(h), act)),
            np.asarray(ref_L.mlp_apply(mlp, jnp.asarray(h), act)), **LAYER_TOL)


def _attn_setup(window, d_model=32, h=4, kvh=2, dh=16):
    spec_kw = dict(n_heads=h, n_kv_heads=kvh, d_head=dh, theta=1e4,
                   window=window, softcap=None, qk_norm=True, use_rope=True)
    ref_spec, spec = ref_L.AttnLayerSpec(**spec_kw), L.AttnLayerSpec(**spec_kw)
    p = np_tree(ref_L.attn_init(jax.random.PRNGKey(2), d_model, ref_spec))
    rng = np.random.default_rng(3)
    for name in ("q_norm", "k_norm"):
        p[name]["scale"] = rng.uniform(0.5, 1.5, dh).astype(np.float32)
    return ref_spec, spec, p, params_from_numpy(p, "cpu"), rng


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("window,q_chunk", [(None, 1024), (8, 1024), (8, 16)])
def test_attn_apply_matches_reference(grouped, window, q_chunk):
    ref_spec, spec, ref_p, p, rng = _attn_setup(window)
    x = rng.normal(size=(2, 32, 32)).astype(np.float32)
    positions = np.arange(32, dtype=np.int32)
    try:
        ref_L.set_gqa_grouped(grouped)
        L.set_gqa_grouped(grouped)
        ref = ref_L.attn_apply(ref_p, jnp.asarray(x), jnp.asarray(positions),
                               ref_spec, q_chunk)
        got = L.attn_apply(p, torch.from_numpy(x), torch.from_numpy(positions),
                           spec, q_chunk)
    finally:
        ref_L.set_gqa_grouped(False)
        L.set_gqa_grouped(False)
    np.testing.assert_allclose(np_(got), np.asarray(ref), **LAYER_TOL)


@pytest.mark.parametrize("window", [None, 64])
def test_attn_decode_step_ring_matches_reference(window):
    """2 x 64 steps into a 128-slot cache (window None) or a 64-slot ring
    (window 64), which then wraps once."""
    ref_spec, spec, ref_p, p, rng = _attn_setup(window)
    steps, cache_len = 128, 128
    xs = rng.normal(size=(steps, 2, 1, 32)).astype(np.float32)
    ref_cache = ref_L.kv_cache_init(2, cache_len, ref_spec, jnp.float32)
    cache = L.kv_cache_init(2, cache_len, spec, device="cpu")
    ref_step = jax.jit(lambda c, x, pos: ref_L.attn_decode_step(
        ref_p, x, pos, c, ref_spec))
    for i in range(steps):
        ref_y, ref_cache = ref_step(ref_cache, jnp.asarray(xs[i]), jnp.int32(i))
        y, cache = L.attn_decode_step(p, torch.from_numpy(xs[i]), i, cache, spec)
        np.testing.assert_allclose(np_(y), np.asarray(ref_y), **LAYER_TOL)
    np.testing.assert_array_equal(np_(cache.pos), np.asarray(ref_cache.pos))
    np.testing.assert_allclose(np_(cache.k), np.asarray(ref_cache.k), **LAYER_TOL)
    np.testing.assert_allclose(np_(cache.v), np.asarray(ref_cache.v), **LAYER_TOL)


@pytest.mark.parametrize("s", [40, 64, 100])
def test_kv_cache_from_prefill_matches_reference(s):
    ref_spec, spec, *_ = _attn_setup(64)
    rng = np.random.default_rng(s)
    k, v = (rng.normal(size=(2, s, 2, 16)).astype(np.float32) for _ in range(2))
    ref = ref_L.kv_cache_from_prefill(jnp.asarray(k), jnp.asarray(v), ref_spec, 128)
    got = L.kv_cache_from_prefill(torch.from_numpy(k), torch.from_numpy(v), spec, 128)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np_(a), np.asarray(b))


def test_decode_step_refuses_softcap():
    """The refusal that remains: the non-causal decode (whisper's), with
    or without a softcap (gemma2's softcapped decode is ported)."""
    _, spec, _, p, _ = _attn_setup(None)
    cache = L.kv_cache_init(1, 8, spec, device="cpu")
    for softcap in (None, 50.0):
        with pytest.raises(NotImplementedError, match="non-causal"):
            L.attn_decode_step(p, torch.zeros(1, 1, 32), 0, cache,
                               spec._replace(softcap=softcap, causal=False))


# ------------------------------------------------------- the parameter tree

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_param_tree_matches_reference_at_full_width():
    ref_cfg = REF_ARCHS["gemma3-1b"]
    ref = jax.eval_shape(lambda k: ref_T.init_params(ref_cfg, k),
                         jax.random.PRNGKey(0))
    got = T.init_params(ARCHS["gemma3-1b"], torch.Generator(), device="meta")
    assert _shapes(got) == _shapes(ref)
    assert len(got["tail"]) == 2 and got["stack"]["l0"]["attn"]["wq"].shape[0] == 4
    assert all(x.device.type == "meta" for x in tree_leaves(got))
    assert zoo.param_count(ARCHS["gemma3-1b"]) == GEMMA3_1B_PARAMS
    assert ARCHS["gemma3-1b"].n_params() == GEMMA3_1B_PARAMS
    assert zoo.grad_size_bits(ARCHS["gemma3-1b"]) == 32.0 * GEMMA3_1B_PARAMS


def test_param_tree_round_trips_through_numpy(small_model):
    ref_cfg, cfg, ref_params, params = small_model
    back = params_to_numpy(params)
    assert _shapes(back) == _shapes(ref_params)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(ref_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_registry_and_unported_blocks():
    assert get_arch("gemma3-1b") is ARCHS["gemma3-1b"]
    with pytest.raises(KeyError, match="not ported yet"):
        get_arch("whisper-large-v3")
    with pytest.raises(KeyError, match="unknown"):
        get_arch("no-such-arch")
    cfg = ARCHS["gemma3-1b"].reduced()
    bad = dataclasses.replace(cfg, enc_layers=2)
    with pytest.raises(NotImplementedError, match="whisper"):
        T.init_params(bad, torch.Generator(), device="meta")


def test_make_batch_matches_reference():
    ref_cfg, cfg = _cfgs()
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=16, global_batch=3)
    ref = ref_zoo.make_batch(ref_cfg, shape, np.random.default_rng(5))
    got = zoo.make_batch(cfg, shape, np.random.default_rng(5), device="cpu")
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(np_(got[key]), np.asarray(ref[key]))


# ------------------------------------------------------------ whole model

def test_forward_matches_reference(small_model):
    ref_cfg, cfg, ref_params, params = small_model
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 130)).astype(np.int32)
    ref, _ = ref_T.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)},
                           remat=False)
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)


def test_teacher_forced_decode_matches_reference(small_model):
    """130 decode steps into a cache of 130: the local rings of 64 wrap
    twice, the global layers' cache fills.  Every step's logits against
    the reference's, and against the port's own forward."""
    ref_cfg, cfg, ref_params, params = small_model
    steps = 130
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, (2, steps)).astype(np.int32)
    ref_step = jax.jit(lambda c, t, pos: ref_T.decode_step(ref_cfg, ref_params,
                                                           c, t, pos))
    ref_cache = ref_T.init_cache(ref_cfg, 2, steps, dtype=jnp.float32)
    cache = T.init_cache(cfg, 2, steps, device="cpu")
    step = make_serve_step(cfg)
    outs = []
    for i in range(steps):
        tok = tokens[:, i:i + 1]
        ref, ref_cache = ref_step(ref_cache, jnp.asarray(tok), jnp.int32(i))
        got, cache = step(params, cache, {"tokens": torch.from_numpy(tok).long(),
                                          "pos": i})
        np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)
        outs.append(got)
    full, _ = T.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(torch.cat(outs, dim=1)), np_(full), **MODEL_TOL)


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
    ref_cfg, cfg, ref_params, params = small_model
    gen, batch = 6, 2
    ref_reqs = _requests(ref_serve.Request, 5, cfg.vocab, gen, seed=0)
    reqs = _requests(serve.Request, 5, cfg.vocab, gen, seed=0)
    ref_stats = ref_serve.BatchedServer(ref_cfg, ref_params, batch,
                                        cache_len=64 + gen).run(ref_reqs)
    margins = _reference_margins(ref_cfg, ref_params, ref_reqs, batch, 64 + gen)
    assert len(margins) == 5 * gen and margins.min() > MARGIN, margins.min()
    stats = serve.BatchedServer(cfg, params, batch, cache_len=64 + gen,
                                device="cpu").run(reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert all(len(r.out) == gen for r in reqs)
    assert stats["decode_steps"] == ref_stats["decode_steps"]
    assert stats["tokens"] == ref_stats["tokens"] == 5 * gen


def test_entry_points_default_to_the_card():
    """No CPU fallback: device=None means the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = ARCHS["gemma3-1b"].reduced(**SMALL)
    params = T.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.BatchedServer(cfg, params, 2, 16, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.make_batch(cfg, INPUT_SHAPES["train_4k"], np.random.default_rng(0))


def test_main_serves_on_the_cpu(capsys):
    stats = serve.main(["--requests", "3", "--batch", "2", "--gen", "4",
                        "--device", "cpu"])
    assert stats["requests"] == 3 and stats["tokens"] == 12
    assert "served 3 requests" in capsys.readouterr().out


# ------------------------------------------------------------------ trees

class _Pair(NamedTuple):
    a: object
    b: object


def test_tree_walks_lists_tuples_and_namedtuples():
    tree = {"z": [1, 2], "a": _Pair(a=3, b=(4, {"y": 5, "x": 6})), "m": 7}
    assert tree_leaves(tree) == [3, 4, 6, 5, 7, 1, 2]
    assert tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert isinstance(doubled["a"], _Pair) and isinstance(doubled["a"].b, tuple)
    assert isinstance(doubled["z"], list)
    assert doubled == {"z": [2, 4], "a": _Pair(a=6, b=(8, {"y": 10, "x": 12})),
                       "m": 14}
    cache = L.kv_cache_init(2, 8, L.AttnLayerSpec(2, 1, 4, 1e4, None, None,
                                                  False, True), device="cpu")
    stacked = tree_map(lambda x: torch.stack([x, x]), {"kv": cache})
    assert isinstance(stacked["kv"], L.KVCache)
    assert stacked["kv"].k.shape == (2, 2, 8, 1, 4)
    assert [x.shape for x in tree_leaves(stacked)] == [(2, 2, 8, 1, 4),
                                                       (2, 2, 8, 1, 4), (2, 8)]
