"""Parity of the port's remaining attention archs with the JAX reference:
h2o-danube-3-4b and phi3-medium-14b (``("attn",)`` periods), gemma2-27b
(local/global pairs with attention and final-logit softcaps, GeGLU) and
zamba2-7b (Mamba2 layers and a shared attention+MLP block every 6th).

Both packages run the same inputs in one process: numpy draws from a
seed, and the reference's parameters carried across as numpy
(``convert.params_from_numpy``).  Tolerances, as ``test_torch_serve.py``'s:

* the softcapped decode (the kernel's plain versions and
  ``decode_attention``) against the reference's ``_attend_block`` at
  rtol = atol = 2e-5, the reference's float32 decode-kernel tolerance;
* the softcapped ``attn_decode_step`` at 1e-5 (layers);
* whole-model logits at 1e-4, for forward and for every teacher-forced
  decode step;
* the server's completions token for token, after checking that every
  emitted token wins its argmax by more than 1e-3 in the reference.

The reduced configs: danube and phi3 at 3 layers; gemma2 at 5 (two
local/global pairs stacked and a local tail); zamba2 at 13 (two stacked
units of five Mamba2 layers and a shared block, whose two occurrences
share one set of weights, and a Mamba2 tail).  Every reduced config has
d_model 256, 4 query heads over 4 KV heads and (danube, gemma2, zamba2)
a window of 64, which the decode runs wrap.

On the CPU the decode step runs the decode kernel's plain version and
the Mamba2 prefill the SSD scan's; the CUDA kernels are tested in
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.launch import serve as ref_serve
from repro.models import layers as ref_L
from repro.models import transformer as ref_T
from repro_torch.configs import ARCHS, NOT_PORTED, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.swa_decode.ops import decode_attention, swa_decode
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
# the reference's param_count at full width
FULL_PARAMS = {"h2o-danube-3-4b": 3_838_959_360,
               "phi3-medium-14b": 14_145_704_960,
               "gemma2-27b": 27_226_704_384,
               "zamba2-7b": 8_640_318_160}
# gemma2-27b's card run: 24 of its 46 layers (12 local/global pairs)
GEMMA2_24_PARAMS = 14_769_418_752
# zamba2-7b's 13 shared_attn layers each carry an ln2 and a dense MLP of
# their own, as the reference's tree has them, that nothing reads
ZAMBA2_DEAD_MLP_PARAMS = 13 * 3 * 3584 * 14336
REDUCED = {"h2o-danube-3-4b": 3, "phi3-medium-14b": 3, "gemma2-27b": 5,
           "zamba2-7b": 13}
NAMES = sorted(REDUCED)
# decode steps (and forward's length): past the 64-slot rings; zamba2's a
# multiple of its reduced chunk (32)
STEPS = {"h2o-danube-3-4b": 130, "phi3-medium-14b": 130, "gemma2-27b": 130,
         "zamba2-7b": 160}


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


# ---------------------------------------------------------- the registry

def test_registry_holds_the_four_archs():
    for name in NAMES:
        assert get_arch(name) is ARCHS[name]
        assert name not in NOT_PORTED
        ours, ref = dataclasses.asdict(ARCHS[name]), dataclasses.asdict(REF_ARCHS[name])
        assert ours == ref


@pytest.mark.parametrize("name", NAMES)
def test_param_tree_matches_reference_at_full_width(name):
    """The "meta" tree against ``jax.eval_shape`` of the reference's, the
    count against the reference's, and the decode cache's leaves."""
    cfg, ref_cfg = ARCHS[name], REF_ARCHS[name]
    ref = jax.eval_shape(lambda k: ref_T.init_params(ref_cfg, k),
                         jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator(), device="meta")
    assert _shapes(got) == _shapes(ref)
    assert all(x.device.type == "meta" for x in tree_leaves(got))
    assert zoo.param_count(cfg) == FULL_PARAMS[name]
    assert cfg.n_params() == FULL_PARAMS[name]
    cache = T.init_cache(cfg, 2, 64, device="meta")
    ref_cache = jax.eval_shape(lambda: ref_T.init_cache(ref_cfg, 2, 64, jnp.float32))
    assert [tuple(x.shape) for x in tree_leaves(cache)] == \
        [x.shape for x in jax.tree_util.tree_leaves(ref_cache)]


def test_zamba2_keeps_the_reference_tree():
    """One shared block beside the stack; each stacked ``shared_attn``
    layer (``l5``) with its own Mamba2 mixer and the unread ln2/MLP."""
    cfg = ARCHS["zamba2-7b"]
    got = T.init_params(cfg, torch.Generator(), device="meta")
    plan = T.layer_plan(cfg)
    assert plan.reps == 13 and len(plan.tail) == 3
    assert sorted(got["shared_attn"]) == ["attn", "ln1", "ln2", "mlp"]
    assert sorted(got["stack"]["l5"]) == ["ln", "ln2", "mamba", "mlp"]

    def count(tree):
        return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))
    assert count(got["stack"]["l5"]["mlp"]) == ZAMBA2_DEAD_MLP_PARAMS == 2_003_828_736
    assert count(got["stack"]["l5"]["ln2"]) == 13 * 3584


def test_gemma2_card_cut_count():
    cfg = dataclasses.replace(ARCHS["gemma2-27b"], n_layers=24)
    plan = T.layer_plan(cfg)
    assert (plan.reps, plan.tail) == (12, ())
    assert zoo.param_count(cfg) == GEMMA2_24_PARAMS


# ------------------------------------------------------ the softcapped decode

def _ring(w, qpos):
    """pos_buf of a ring of W slots after positions 0..qpos: slot s holds
    the latest position p <= qpos with p % W == s, or -1."""
    latest = qpos - (qpos - np.arange(w)) % w
    return np.where(latest >= 0, latest, -1).astype(np.int32)


@pytest.mark.parametrize("softcap", [50.0, 5.0])
@pytest.mark.parametrize("w,hkv,g,dh,window,qpos,nsplit", [
    (97, 16, 2, 128, None, 300, 5),      # gemma2's heads, a wrapped ring
    (97, 16, 2, 128, 64, 300, 7),        # under a window: empty splits
    (200, 2, 1, 112, None, 120, 6),      # zamba2's G and dh, a filling ring
    (64, 4, 4, 120, 64, 64, 1),          # danube's G and dh
])
def test_softcapped_plain_versions_match_reference(w, hkv, g, dh, window,
                                                   qpos, nsplit, softcap):
    """``swa_decode_ref``, ``swa_decode_split_ref``, the wrapper and
    ``decode_attention`` with a softcap against the reference decode's
    ``_attend_block``.  The queries are scaled up, to scores of spread
    about 12, which the tanh bends at 50 and mostly saturates at 5."""
    rng = np.random.default_rng(w + hkv + int(softcap))
    h = hkv * g
    q = (rng.normal(size=(2, 1, h, dh)) * 12).astype(np.float32)
    k = rng.normal(size=(2, w, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(2, w, hkv, dh)).astype(np.float32)
    pos = _ring(w, qpos)
    spec = ref_L.AttnLayerSpec(n_heads=h, n_kv_heads=hkv, d_head=dh, theta=1e4,
                               window=window, softcap=softcap, qk_norm=False,
                               use_rope=False)
    ref = np.asarray(ref_L._attend_block(
        jnp.asarray(q), ref_L._repeat_kv(jnp.asarray(k), h),
        ref_L._repeat_kv(jnp.asarray(v), h), jnp.asarray([qpos], jnp.int32),
        jnp.asarray(pos), spec)).reshape(2, hkv, g, dh)
    qg = torch.from_numpy((q[:, 0] * np.float32(dh ** -0.5)).reshape(2, hkv, g, dh))
    t = [torch.from_numpy(x) for x in (k, v, pos)]
    plain = np_(swa_decode_ref(qg, *t, qpos, window=window, softcap=softcap))
    split = np_(swa_decode_split_ref(qg, *t, qpos, window=window,
                                     nsplit=nsplit, softcap=softcap))
    wrapped = np_(swa_decode(qg, *t, qpos, window=window, softcap=softcap))
    layer = np_(decode_attention(torch.from_numpy(q), *t, qpos, window=window,
                                 n_heads=h, softcap=softcap)).reshape(ref.shape)
    np.testing.assert_array_equal(wrapped, plain)
    for got in (plain, split, layer):
        np.testing.assert_allclose(got, ref, **KERNEL_TOL)
    # the cap acts: without it the outputs are far apart
    uncapped = np_(swa_decode_ref(qg, *t, qpos, window=window))
    assert np.abs(uncapped - ref).max() > 1e-2


def test_softcap_must_be_positive():
    qg = torch.zeros(1, 1, 1, 8)
    k = v = torch.zeros(1, 4, 1, 8)
    pos = torch.arange(4, dtype=torch.int32)
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="softcap"):
            swa_decode(qg, k, v, pos, 3, window=None, softcap=bad)


@pytest.mark.parametrize("softcap", [50.0, 1.5])
@pytest.mark.parametrize("window", [None, 64])
def test_softcapped_attn_decode_step_matches_reference(window, softcap):
    """128 steps of a GQA layer (4 query heads over 2 KV heads) with a
    logit softcap into a 128-slot cache (window None) or a 64-slot ring
    that wraps once; at 1.5 the tanh bends most scores."""
    spec_kw = dict(n_heads=4, n_kv_heads=2, d_head=16, theta=1e4,
                   window=window, softcap=softcap, qk_norm=True, use_rope=True)
    ref_spec, spec = ref_L.AttnLayerSpec(**spec_kw), L.AttnLayerSpec(**spec_kw)
    p = np_tree(ref_L.attn_init(jax.random.PRNGKey(2), 32, ref_spec))
    params = params_from_numpy(p, "cpu")
    rng = np.random.default_rng(3)
    steps = 128
    xs = (rng.normal(size=(steps, 2, 1, 32)) * 2).astype(np.float32)
    ref_cache = ref_L.kv_cache_init(2, steps, ref_spec, jnp.float32)
    cache = L.kv_cache_init(2, steps, spec, device="cpu")
    ref_step = jax.jit(lambda c, x, pos: ref_L.attn_decode_step(
        p, x, pos, c, ref_spec))
    for i in range(steps):
        ref_y, ref_cache = ref_step(ref_cache, jnp.asarray(xs[i]), jnp.int32(i))
        y, cache = L.attn_decode_step(params, torch.from_numpy(xs[i]), i, cache,
                                      spec)
        np.testing.assert_allclose(np_(y), np.asarray(ref_y), **LAYER_TOL)
    np.testing.assert_array_equal(np_(cache.pos), np.asarray(ref_cache.pos))
    np.testing.assert_allclose(np_(cache.k), np.asarray(ref_cache.k), **LAYER_TOL)


# ------------------------------------------------------------ whole models

@pytest.fixture(scope="module", params=NAMES)
def small_model(request):
    """One reduced arch in both packages, with the reference's weights."""
    name = request.param
    ref_cfg = REF_ARCHS[name].reduced(n_layers=REDUCED[name])
    cfg = ARCHS[name].reduced(n_layers=REDUCED[name])
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(ref_params), device="cpu")
    return name, ref_cfg, cfg, ref_params, params


def test_reduced_plans(small_model):
    """The reduced configs hold what the tests claim of them."""
    name, _, cfg, _, params = small_model
    plan = T.layer_plan(cfg)
    kinds = [k[0] for k in plan.all_layers()]
    if name == "gemma2-27b":
        assert (plan.reps, plan.tail) == (2, (("attn", "dense"),))
        assert cfg.attn.logit_softcap == 50.0 and cfg.final_logit_softcap == 30.0
    elif name == "zamba2-7b":
        assert plan.reps == 2 and kinds.count("shared_attn") == 2
        assert "shared_attn" in params and cfg.attn.window == 64
    else:
        assert kinds == ["attn"] * 3 and plan.reps == 3


def test_forward_matches_reference(small_model):
    name, ref_cfg, cfg, ref_params, params = small_model
    s = STEPS[name]
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, s)).astype(np.int32)
    ref, _ = ref_T.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)},
                           remat=False)
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)


def test_teacher_forced_decode_matches_reference(small_model):
    """Every decode step's logits against the reference's, the caches at
    the end (the rings wrapped, zamba2's conv windows and states), and the
    steps against the port's own forward."""
    name, ref_cfg, cfg, ref_params, params = small_model
    steps = STEPS[name]
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
    ours, theirs = tree_leaves(cache), jax.tree_util.tree_leaves(ref_cache)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(np_(a), np.asarray(b), **MODEL_TOL)
    full, _ = T.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(torch.cat(outs, dim=1)), np_(full), **MODEL_TOL)


def test_shared_block_is_shared_and_dead_mlps_unread(monkeypatch):
    """zamba2 at 13 reduced layers: zeroing every shared_attn layer's own
    ln2/MLP changes no logit, and both occurrences of the block attend
    with the one shared set of weights."""
    cfg = ARCHS["zamba2-7b"].reduced(n_layers=REDUCED["zamba2-7b"])
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, 64)).astype(np.int64))
    base, _ = T.forward(cfg, params, {"tokens": tokens})
    stack = dict(params["stack"])
    stack["l5"] = dict(stack["l5"], ln2=tree_map(torch.zeros_like, stack["l5"]["ln2"]),
                       mlp=tree_map(torch.zeros_like, stack["l5"]["mlp"]))
    dead, _ = T.forward(cfg, dict(params, stack=stack), {"tokens": tokens})
    torch.testing.assert_close(dead, base, rtol=0, atol=0)
    seen = []

    def spy(p, *args, **kw):
        seen.append(p["wq"].data_ptr())
        return attn_apply(p, *args, **kw)

    attn_apply = L.attn_apply
    monkeypatch.setattr(L, "attn_apply", spy)
    T.forward(cfg, params, {"tokens": tokens})
    assert seen == [params["shared_attn"]["attn"]["wq"].data_ptr()] * 2


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
    """5 requests at gen 6 in waves of 2, cache 64 + gen: the token-by-
    token prompts and the completions fill the 64-slot rings."""
    _, ref_cfg, cfg, ref_params, params = small_model
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


@pytest.mark.parametrize("name", NAMES)
def test_main_serves_each_arch_on_the_cpu(name, capsys):
    stats = serve.main(["--arch", name, "--requests", "3", "--batch", "2",
                        "--gen", "4", "--device", "cpu"])
    assert stats["requests"] == 3 and stats["tokens"] == 12
    assert f"reduced {name}-reduced on cpu" in capsys.readouterr().out
