"""Parity of the port's Mamba2 path (the SSD scan, the Mamba2 block and the
mamba2-780m model) with the JAX reference.

Both packages run the same inputs in one process: numpy draws from a
seed, and the reference's parameters carried across as numpy.
Tolerances:

* the sequential recurrence and the chunked dual form against their
  reference counterparts (the same algorithm in float32, sums in another
  order) at rtol = atol = 1e-5;
* the chunked form against the sequential one at 1e-4, the reference's
  own tolerance for its kernel against that oracle
  (``tests/test_kernels.py``), and ``ssd_apply`` against the reference's
  Pallas kernel (interpret mode) at 2e-4, the reference's tolerance for
  its wrapper against ``ssd_chunked``;
* the Mamba2 block and its decode step at 1e-5 (layers);
* whole-model logits at 1e-4 (``MODEL_TOL`` of ``test_torch_serve.py``);
* the server's completions token for token, after checking that every
  emitted token wins its argmax by more than 1e-3 in the reference.

On the CPU ``ssd_apply`` runs the plain chunked version; the CUDA kernel
itself is tested in ``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.kernels.ssd_scan.ops import ssd_apply as ref_ssd_apply
from repro.kernels.ssd_scan.ref import ssd_scan_ref as ref_ssd_scan_ref
from repro.launch import serve as ref_serve
from repro.models import mamba2 as ref_M
from repro.models import transformer as ref_T
from repro_torch.configs import ARCHS, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ssd_scan.ops import ssd_apply
from repro_torch.kernels.ssd_scan.ref import (_pairwise_diff, ssd_chunked_ref,
                                              ssd_passes_ref, ssd_scan_ref)
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

SAME_TOL = dict(rtol=1e-5, atol=1e-5)
SEQ_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
MAMBA2_780M_PARAMS = 780_382_464


def np_(x):
    return x.detach().cpu().numpy()


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _ssd_operands(b, s, h, p, n, seed, init=False):
    """Mamba-shaped operands as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, h).astype(np.float32)
    bm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(b, s, n)) * 0.3).astype(np.float32)
    d = rng.normal(size=h).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32) if init else None
    return x, dt, a, bm, cm, d, s0


def _fold(x, dt, a, bm, cm, d):
    """The reference kernel's folded layout: [B*H, S, ...], B/C repeated."""
    b, s, h, p = x.shape
    return (x.transpose(0, 2, 1, 3).reshape(b * h, s, p),
            dt.transpose(0, 2, 1).reshape(b * h, s), np.tile(a, b),
            np.repeat(bm, h, axis=0), np.repeat(cm, h, axis=0), np.tile(d, b))


# -------------------------------------------------------------- the scan

@pytest.mark.parametrize("bh,s,p,n", [(3, 64, 32, 16), (2, 40, 8, 12)])
def test_sequential_scan_matches_reference(bh, s, p, n):
    rng = np.random.default_rng(s + p)
    x = rng.normal(size=(bh, s, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (bh, s)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, bh).astype(np.float32)
    bm = (rng.normal(size=(bh, s, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(bh, s, n)) * 0.3).astype(np.float32)
    d = rng.normal(size=bh).astype(np.float32)
    ref = ref_ssd_scan_ref(*map(jnp.asarray, (x, dt, a, bm, cm, d)))
    got = ssd_scan_ref(*t_(x, dt, a, bm, cm, d))
    np.testing.assert_allclose(np_(got), np.asarray(ref), **SAME_TOL)


def test_segsum_matches_reference():
    """The port's L exponent, masked pairwise differences of the decays'
    cumsum, against the reference's ``_segsum``."""
    x = -np.random.default_rng(0).uniform(0, 3, (2, 3, 16)).astype(np.float32)
    ref = np.asarray(ref_M._segsum(jnp.asarray(x)))
    got = np_(_pairwise_diff(torch.cumsum(torch.from_numpy(x), dim=-1)))
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], **SAME_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,init", [
    (2, 128, 4, 32, 16, 32, False),
    (2, 128, 4, 32, 16, 32, True),
    (1, 96, 3, 16, 8, 96, False),        # a single chunk
    (1, 96, 3, 16, 8, 96, True),
    (2, 192, 2, 24, 20, 64, True),       # ragged widths
])
def test_chunked_form_matches_reference(b, s, h, p, n, chunk, init):
    """y and the final state, with and without an initial state."""
    x, dt, a, bm, cm, d, s0 = _ssd_operands(b, s, h, p, n, s + chunk, init)
    ref_y, ref_state = ref_M.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm, d)), chunk=chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    y, state = ssd_chunked_ref(*t_(x, dt, a, bm, cm, d), chunk, *t_(s0))
    np.testing.assert_allclose(np_(y), np.asarray(ref_y), **SAME_TOL)
    np.testing.assert_allclose(np_(state), np.asarray(ref_state), **SAME_TOL)
    # the model's entry point goes through the wrapper: the same numbers
    y2, state2 = M.ssd_chunked(*t_(x, dt, a, bm, cm, d), chunk, *t_(s0))
    np.testing.assert_array_equal(np_(y2), np_(y))
    np.testing.assert_array_equal(np_(state2), np_(state))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 128, 4, 32, 16, 32),
                                             (1, 64, 2, 16, 8, 64)])
def test_chunked_form_matches_sequential_scan(b, s, h, p, n, chunk):
    x, dt, a, bm, cm, d, _ = _ssd_operands(b, s, h, p, n, 7 * s + chunk)
    y = ssd_chunked_ref(*t_(x, dt, a, bm, cm, d), chunk)[0]
    seq = ssd_scan_ref(*t_(*_fold(x, dt, a, bm, cm, d)))
    np.testing.assert_allclose(np_(y), np_(seq).reshape(b, h, s, p)
                               .transpose(0, 2, 1, 3), **SEQ_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,init,big", [
    (2, 128, 4, 32, 16, 32, False, False),   # several chunks
    (2, 128, 4, 32, 16, 32, True, False),
    (1, 96, 3, 16, 8, 96, False, False),     # a single chunk
    (1, 96, 3, 16, 8, 96, True, False),
    (2, 192, 2, 24, 20, 64, True, False),    # ragged widths
    (1, 256, 2, 16, 12, 64, False, True),    # dt x 300, A x 4
    (1, 256, 2, 16, 12, 64, True, True),
])
def test_chunk_passes_match_reference(b, s, h, p, n, chunk, init, big):
    """The kernel's four passes written out (``ssd_passes_ref``): y and
    the final state against the reference's ``ssd_chunked`` at 1e-5 (the
    same algorithm in float32, sums in another order), and the decays of
    hundreds per step (dt x 300, A x 4) stay finite."""
    x, dt, a, bm, cm, d, s0 = _ssd_operands(b, s, h, p, n, 3 * s + chunk, init)
    if big:
        dt, a = dt * np.float32(300.0), a * np.float32(4.0)
    ref_y, ref_state = ref_M.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm, d)), chunk=chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    y, state = ssd_passes_ref(*t_(x, dt, a, bm, cm, d), chunk, *t_(s0))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    np.testing.assert_allclose(np_(y), np.asarray(ref_y), **SAME_TOL)
    np.testing.assert_allclose(np_(state), np.asarray(ref_state), **SAME_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 128, 4, 32, 16, 32),
                                             (1, 64, 2, 16, 8, 64),
                                             (3, 40, 5, 7, 5, 8)])
def test_chunk_passes_match_sequential_scan(b, s, h, p, n, chunk):
    """The passes against the reference's sequential recurrence at 1e-4,
    the reference's tolerance for its kernel against that oracle."""
    x, dt, a, bm, cm, d, _ = _ssd_operands(b, s, h, p, n, 5 * s + chunk)
    y = ssd_passes_ref(*t_(x, dt, a, bm, cm, d), chunk)[0]
    seq = np.asarray(ref_ssd_scan_ref(*map(jnp.asarray,
                                           _fold(x, dt, a, bm, cm, d))))
    np.testing.assert_allclose(np_(y), seq.reshape(b, h, s, p)
                               .transpose(0, 2, 1, 3), **SEQ_TOL)


def test_ssd_apply_on_cpu_matches_reference_kernel():
    """The wrapper's CPU path against the reference's Pallas kernel in
    interpret mode, at the reference's own wrapper-test shapes."""
    x, dt, a, bm, cm, d, _ = _ssd_operands(2, 256, 4, 32, 16, 1)
    ref = ref_ssd_apply(*map(jnp.asarray, (x, dt, a, bm, cm, d)), chunk=64,
                        interpret=True)
    before = cuda_lib.LAUNCHES["ssd_scan"]
    got = ssd_apply(*t_(x, dt, a, bm, cm, d), chunk=64)
    assert cuda_lib.LAUNCHES["ssd_scan"] == before      # no kernel on the CPU
    np.testing.assert_allclose(np_(got), np.asarray(ref), **KERNEL_TOL)


def test_ssd_apply_checks_shapes():
    x, dt, a, bm, cm, d, s0 = (torch.from_numpy(v) for v in
                               _ssd_operands(1, 64, 2, 8, 4, 0, init=True))
    with pytest.raises(ValueError, match="not divisible"):
        ssd_apply(x, dt, a, bm, cm, d, chunk=48)
    with pytest.raises(ValueError, match="dt has shape"):
        ssd_apply(x, dt[:, :32], a, bm, cm, d, chunk=32)
    with pytest.raises(ValueError, match="c_mat has shape"):
        ssd_apply(x, dt, a, bm, cm[..., :3], d, chunk=32)
    with pytest.raises(ValueError, match="init_state has shape"):
        ssd_apply(x, dt, a, bm, cm, d, chunk=32, init_state=s0[:, :1])
    with pytest.raises(ValueError, match="empty"):
        ssd_apply(x[:, :0], dt[:, :0], a, bm[:, :0], cm[:, :0], d, chunk=32)


# ------------------------------------------------------------ the block

SSM = dict(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32)
D_MODEL = 64


def _block():
    ref_cfg = REF_ARCHS["mamba2-780m"].ssm.__class__(**SSM)
    cfg = ARCHS["mamba2-780m"].ssm.__class__(**SSM)
    ref_p = np_tree(ref_M.mamba_init(jax.random.PRNGKey(3), D_MODEL, ref_cfg))
    rng = np.random.default_rng(4)
    # non-trivial biases and norm scales, so every leaf matters
    for name in ("conv_bias_x", "conv_bias_b", "conv_bias_c"):
        ref_p[name] = (rng.normal(size=ref_p[name].shape) * 0.1).astype(np.float32)
    ref_p["norm"]["scale"] = rng.uniform(0.5, 1.5, ref_p["norm"]["scale"].shape
                                         ).astype(np.float32)
    return ref_cfg, cfg, ref_p, params_from_numpy(ref_p, "cpu"), rng


def test_mamba_init_matches_reference_forms():
    ref_cfg, cfg, ref_p, _, _ = _block()
    got = M.mamba_init(torch.Generator().manual_seed(0), D_MODEL, cfg, "cpu")
    assert sorted(got) == sorted(ref_p)
    for k in ref_p:
        if k != "norm":
            assert tuple(got[k].shape) == ref_p[k].shape, k
    for k in ("A_log", "D"):
        np.testing.assert_allclose(np_(got[k]), ref_p[k], **SAME_TOL)
    # dt = softplus(dt_bias) is log-uniform on [1e-3, 1e-1]
    dt = np_(torch.nn.functional.softplus(got["dt_bias"]))
    assert (dt >= 1e-3 * (1 - 1e-4)).all() and (dt <= 1e-1 * (1 + 1e-4)).all()
    scale = np.std(np_(got["in_x"])) * D_MODEL ** 0.5
    assert 0.9 < scale < 1.1, scale
    meta = M.mamba_init(torch.Generator(), D_MODEL, cfg, "meta")
    assert all(x.device.type == "meta" for x in tree_leaves(meta))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 11, 7)).astype(np.float32)
    w = rng.normal(size=(4, 7)).astype(np.float32)
    b = rng.normal(size=7).astype(np.float32)
    np.testing.assert_allclose(
        np_(M._causal_conv(*t_(x, w, b))),
        np.asarray(ref_M._causal_conv(*map(jnp.asarray, (x, w, b)))),
        **LAYER_TOL)


@pytest.mark.parametrize("init", [False, True])
def test_mamba_apply_matches_reference(init):
    ref_cfg, cfg, ref_p, p, rng = _block()
    x = rng.normal(size=(2, 96, D_MODEL)).astype(np.float32)
    h, hp = 2 * D_MODEL // SSM["head_dim"], SSM["head_dim"]
    s0 = rng.normal(size=(2, h, hp, SSM["d_state"])).astype(np.float32) if init else None
    ref_y, ref_state = ref_M.mamba_apply(
        ref_p, jnp.asarray(x), ref_cfg,
        init_state=None if s0 is None else jnp.asarray(s0), return_state=True)
    y, state = M.mamba_apply(p, torch.from_numpy(x), cfg, *t_(s0),
                             return_state=True)
    np.testing.assert_allclose(np_(y), np.asarray(ref_y), **LAYER_TOL)
    np.testing.assert_allclose(np_(state), np.asarray(ref_state), **LAYER_TOL)
    assert np_(M.mamba_apply(p, torch.from_numpy(x), cfg)).shape == x.shape


def test_mamba_decode_step_matches_reference():
    """64 recurrent steps from an empty cache: outputs, conv window and
    state against the reference at every step, the state in the end
    against the chunked form's final state."""
    ref_cfg, cfg, ref_p, p, rng = _block()
    steps = 64
    xs = rng.normal(size=(2, steps, D_MODEL)).astype(np.float32)
    ref_cache = ref_M.mamba_cache_init(2, D_MODEL, ref_cfg, jnp.float32)
    cache = M.mamba_cache_init(2, D_MODEL, cfg, device="cpu")
    ref_step = jax.jit(lambda c, x: ref_M.mamba_decode_step(ref_p, x, c, ref_cfg))
    for i in range(steps):
        ref_y, ref_cache = ref_step(ref_cache, jnp.asarray(xs[:, i:i + 1]))
        y, new = M.mamba_decode_step(p, torch.from_numpy(xs[:, i:i + 1]), cache, cfg)
        assert new is cache                       # written in place
        np.testing.assert_allclose(np_(y), np.asarray(ref_y), **LAYER_TOL)
        np.testing.assert_allclose(np_(cache.conv), np.asarray(ref_cache.conv),
                                   **LAYER_TOL)
        np.testing.assert_allclose(np_(cache.state), np.asarray(ref_cache.state),
                                   **LAYER_TOL)
    _, state = M.mamba_apply(p, torch.from_numpy(xs), cfg, return_state=True)
    np.testing.assert_allclose(np_(cache.state), np_(state), **SEQ_TOL)


# ------------------------------------------------------- the model tree

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_param_tree_matches_reference_at_full_width():
    cfg = get_arch("mamba2-780m")
    ref = jax.eval_shape(lambda k: ref_T.init_params(REF_ARCHS["mamba2-780m"], k),
                         jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator(), device="meta")
    assert _shapes(got) == _shapes(ref)
    assert got["stack"]["l0"]["mamba"]["in_x"].shape == (48, 1536, 3072)
    assert got["embed"].shape == (50_432, 1536)
    assert zoo.param_count(cfg) == MAMBA2_780M_PARAMS
    assert cfg.n_params() == MAMBA2_780M_PARAMS
    cache = T.init_cache(cfg, 2, 16, device="meta")
    ref_cache = jax.eval_shape(
        lambda: ref_T.init_cache(REF_ARCHS["mamba2-780m"], 2, 16, jnp.float32))
    assert [tuple(x.shape) for x in tree_leaves(cache)] == \
        [x.shape for x in jax.tree_util.tree_leaves(ref_cache)]


# ------------------------------------------------------- the whole model

@pytest.fixture(scope="module")
def small_model():
    """The reduced mamba2 (2 stacked layers, d_model 256, 16 heads of 32,
    d_state 16, chunk 32) in both packages, with the reference's weights."""
    ref_cfg = REF_ARCHS["mamba2-780m"].reduced()
    cfg = ARCHS["mamba2-780m"].reduced()
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(np_tree(ref_params), device="cpu")
    return ref_cfg, cfg, ref_params, params


def test_forward_matches_reference(small_model):
    ref_cfg, cfg, ref_params, params = small_model
    assert T.layer_plan(cfg).reps == 2
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 96)).astype(np.int32)
    ref, _ = ref_T.forward(ref_cfg, ref_params, {"tokens": jnp.asarray(tokens)},
                           remat=False)
    got = make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(got), np.asarray(ref), **MODEL_TOL)


def test_teacher_forced_decode_matches_reference(small_model):
    """96 recurrent decode steps (3 chunks' worth): every step's logits
    against the reference's, and against the port's own forward (the
    chunked scan).  A decode step that dropped the stacked layers' new
    conv windows and states would fail from the second step on."""
    ref_cfg, cfg, ref_params, params = small_model
    steps = 96
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
    for a, b in zip(tree_leaves(cache), jax.tree_util.tree_leaves(ref_cache)):
        np.testing.assert_allclose(np_(a), np.asarray(b), **MODEL_TOL)
    full, _ = T.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np_(torch.cat(outs, dim=1)), np_(full), **MODEL_TOL)


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


def _requests(cls, n, vocab, gen, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, rng.integers(4, 24)).astype(np.int32),
                max_new=gen) for i in range(n)]


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


def test_main_serves_mamba2_on_the_cpu(capsys):
    stats = serve.main(["--arch", "mamba2-780m", "--requests", "3", "--batch",
                        "2", "--gen", "4", "--device", "cpu"])
    assert stats["requests"] == 3 and stats["tokens"] == 12
    assert "reduced mamba2-780m-reduced on cpu" in capsys.readouterr().out


def test_prefill_length_must_fill_chunks(small_model):
    _, cfg, _, params = small_model
    with pytest.raises(ValueError, match="not divisible by chunk"):
        make_prefill_step(cfg)(params, {"tokens": torch.zeros((1, 40),
                                                              dtype=torch.long)})
    bad = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=40))
    assert T.forward(bad, params, {"tokens": torch.zeros((1, 40), dtype=torch.long)}
                     )[0].shape == (1, 40, 512)
