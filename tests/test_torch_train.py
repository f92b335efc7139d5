"""Parity of the port's training slice with the JAX reference: the
synthetic LM corpus, ``lm_loss`` with and without ``cast_bf16``, remat,
``make_train_step`` and the ``launch.train`` driver.

Both packages run in one process on the same inputs: numpy draws from a
seed, the reference's parameters carried across as numpy
(``convert.params_from_numpy``) and, for the driver, the reference's
participation draws handed in (jax's threefry stream has no torch
counterpart).  Tolerances:

* ``SyntheticLMData`` and ``param_count``: exact.
* ``lm_loss``: 1e-5 relative, float32 parameters and ``cast_bf16`` alike
  (measured: at most 2.1e-7).
* Its gradients with float32 parameters: 1e-4 relative in max-norm for
  each leaf (measured: at most 1.9e-6).
* Its gradients under ``cast_bf16``: bfloat16 values; each element
  within one bfloat16 rounding step of the reference's (2^-7 of its
  magnitude) plus 1e-5 of the leaf's max-norm; at most 1 % of the
  elements apart by more than that 1e-5.  The reason: both packages
  round the float32 gradient to bfloat16 on its way back through the
  cast, as jax's transpose of ``astype`` does; float32 products summed
  in another order (about 1e-6 apart) land an element on the other side
  of a rounding boundary now and then (about 0.1 % of them), which moves
  it by one bfloat16 step (max-norm: up to 3.5e-3 measured).  The tied
  embedding's gradient is a bfloat16 sum of many such rounded terms, so
  it is held to one rounding step of its largest element (2^-7 in
  max-norm; 3.5e-3 measured).
* ``make_train_step`` and the driver, each step: the loss at 1e-5
  relative; ``grad_norm`` at 1e-4 relative (it sums the squares of those
  rounded gradients: 1.2e-5 measured); after k steps the parameters
  within k learning rates of the reference's, every element, and at most
  1e-3 of them apart by more than 1e-5.  The reason: an element whose
  gradient rounds to the other bfloat16 neighbour takes a different
  AdamW step, which is at most about ``lr`` in size, and the steps after
  it see other gradients (measured at lr 3e-4: 3.2e-5 at most and 3e-5
  of the elements beyond 1e-5 after 3 steps; 3.4e-4 and 2.6e-4 after
  the driver's 8).
* The driver's ``sim_time_s`` and ``sim_energy_j``: 1e-5 relative.
* Remat ``"full"``, ``"dots"`` and off: bit for bit; the port's resumed
  run against its uninterrupted run: bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import get_arch as ref_get_arch
from repro.core import ProbabilisticScheduler as RefScheduler
from repro.core import sample_problem as ref_sample_problem
from repro.data.lm import SyntheticLMData as RefLMData
from repro.launch import train as ref_train
from repro.launch.steps import cast_bf16 as ref_cast_bf16
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import transformer as ref_T
from repro.models import zoo as ref_zoo
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.checkpoint import _leaves_with_path
from repro_torch.configs import EXTRA_ARCHS, NOT_PORTED, get_arch
from repro_torch.convert import adam_state_from_numpy, params_from_numpy
from repro_torch.data.lm import SyntheticLMData
from repro_torch.kernels.cuda_lib import BACKWARD_SLICE, refuse_autograd
from repro_torch.launch import train
from repro_torch.launch.steps import cast_bf16, make_train_step, value_and_grad
from repro_torch.models import transformer as T
from repro_torch.models import zoo
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_STEP = 2.0 ** -7          # one bfloat16 rounding step, relative
BF16_ATOL = 1e-5               # of the leaf's max-norm
BF16_SHARE = 1e-2
GNORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
PARAM_SHARE = 1e-3
SIM_RTOL = 1e-5
LR = 3e-4
DEMO_100M_PARAMS = 116_411_136
# the reference launcher test's arguments
DRIVER_ARGS = ["--arch", "demo-100m", "--reduced", "--steps", "8",
               "--batch", "4", "--seq", "64", "--n-clients", "8"]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ckpt_keys(tree):
    """The leaves' keypaths as ``jax.tree_util.keystr`` spells them."""
    return [k for k, _ in _leaves_with_path(tree)]


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _models(arch, **reduced):
    ref_cfg = ref_get_arch(arch).reduced(**reduced)
    cfg = get_arch(arch).reduced(**reduced)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    return ref_cfg, cfg, ref_params, params_from_numpy(np_tree(ref_params),
                                                       device="cpu")


def _batch(vocab, seed, b=2, s=64, weights=True):
    """Tokens, labels with a run of -100 in the first example, weights."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :5] = -100
    if weights:
        w = rng.uniform(size=b).astype(np.float32)
        out["loss_weights"] = w / w.sum()
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _check_params(got, want, steps: int):
    """The step tests' parameter tolerance (module docstring) after
    ``steps`` steps."""
    got, want = tree_leaves(got), _ref_leaves(want)
    assert len(got) == len(want)
    apart = total = 0
    for g, w in zip(got, want):
        d = np.abs(g.detach().numpy() - w)
        assert d.max() <= steps * LR, d.max()
        apart += int((d > PARAM_ATOL).sum())
        total += d.size
    assert apart <= PARAM_SHARE * total, apart / total


# ------------------------------------------------------------ data, config

def test_synthetic_lm_data_matches_reference_byte_for_byte():
    ref, got = RefLMData(16, 512, seed=1), SyntheticLMData(16, 512, seed=1)
    np.testing.assert_array_equal(got.mult, ref.mult)
    np.testing.assert_array_equal(got.add, ref.add)
    for ids, seq in ((np.array([3, 3, 0, 15]), 64), (np.arange(16), 17),
                     (np.array([7]), 1)):
        np.testing.assert_array_equal(got.sample(ids, seq), ref.sample(ids, seq))
        want, have = ref.batch(ids, seq), got.batch(ids, seq)
        assert sorted(have) == sorted(want)
        for k in want:
            assert have[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(have[k], want[k])


def test_demo_100m_config_and_param_count():
    cfg, ref_cfg = get_arch("demo-100m"), ref_get_arch("demo-100m")
    assert "demo-100m" in EXTRA_ARCHS and "demo-100m" not in NOT_PORTED
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert zoo.param_count(cfg) == ref_zoo.param_count(ref_cfg) == DEMO_100M_PARAMS
    assert T.padded_vocab(cfg) == 16_384


# ----------------------------------------------------------------- lm_loss

def _check_grads(got, want, cast: bool):
    got = dict(zip(ckpt_keys(got), tree_leaves(got)))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        key, w = jax.tree_util.keystr(path), np.asarray(w)
        g = got.pop(key).numpy()
        assert g.dtype == np.float32 and g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-30)
        d = np.abs(g - w)
        if not cast:
            assert d.max() <= GRAD_RTOL * scale, key
            continue
        # both are bfloat16 values: the rounding of the cast's transpose
        np.testing.assert_array_equal(
            torch.from_numpy(g).to(torch.bfloat16).float().numpy(), g)
        assert (d > BF16_ATOL * scale).mean() <= BF16_SHARE, key
        if key == "['embed']":
            # the tied embedding's gradient is a bfloat16 sum of many
            # rounded terms (the gathered rows of repeated tokens and the
            # unembedding's), so one rounding step of the leaf's largest
            assert d.max() <= BF16_STEP * scale, key
        else:
            assert np.all(d <= BF16_STEP * np.abs(w) + BF16_ATOL * scale), key
    assert not got


@pytest.mark.parametrize("cast", [False, True], ids=["f32", "cast_bf16"])
@pytest.mark.parametrize("arch", ["demo-100m", "gemma3-1b", "mamba2-780m"])
def test_lm_loss_and_grads_match_reference(arch, cast):
    """Weighted loss with -100 labels; under ``cast_bf16`` this holds the
    embedding's float32 promotion (a forward in bfloat16 activations is
    9.5e-5 and 4.3e-4 apart on demo-100m and gemma3-1b)."""
    ref_cfg, cfg, ref_params, params = _models(arch)
    ref_b, b = _both(_batch(cfg.vocab, 0))

    def ref_fn(p):
        return ref_zoo.lm_loss(ref_cfg, ref_cast_bf16(p) if cast else p, ref_b,
                               q_chunk=128)

    (ref_loss, ref_parts), ref_g = jax.value_and_grad(ref_fn, has_aux=True)(
        ref_params)
    (loss, parts), g = value_and_grad(
        lambda p: zoo.lm_loss(cfg, cast_bf16(p) if cast else p, b, q_chunk=128),
        params)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    assert sorted(parts) == sorted(ref_parts)
    for k in ref_parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]),
                                   rtol=LOSS_RTOL)
    _check_grads(g, ref_g, cast)


def test_lm_loss_unweighted_and_promoted_logits():
    ref_cfg, cfg, ref_params, params = _models("demo-100m")
    ref_b, b = _both(_batch(cfg.vocab, 1, b=3, weights=False))
    ref_loss, _ = ref_zoo.lm_loss(ref_cfg, ref_params, ref_b, q_chunk=128)
    loss, _ = zoo.lm_loss(cfg, params, b, q_chunk=128)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    logits, aux = T.forward(cfg, cast_bf16(params), b)
    ref_logits, _ = ref_T.forward(ref_cfg, ref_cast_bf16(ref_params), ref_b)
    assert logits.dtype == torch.float32 and ref_logits.dtype == jnp.float32
    assert logits.shape == (3, 64, T.padded_vocab(cfg))
    np.testing.assert_array_equal(aux.numpy(), np.zeros(3, np.float32))


def test_vision_prefix_labels_wait_for_their_slice():
    cfg = dataclasses.replace(get_arch("demo-100m").reduced(),
                              frontend=ref_get_arch("internvl2-2b").frontend)
    with pytest.raises(NotImplementedError, match="internvl2"):
        zoo.lm_loss(cfg, {}, {})


# ------------------------------------------------------------------- remat

@pytest.mark.parametrize("arch", ["demo-100m", "mamba2-780m"])
def test_remat_changes_no_number(arch):
    """Loss and gradients under remat "full" / True / "dots" equal
    remat=False bit for bit (three stacked units)."""
    _, cfg, _, params = _models(arch, n_layers=3)
    assert T.layer_plan(cfg).reps == 3
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 2).items()}
    out = {}
    for remat in (False, "full", True, "dots"):
        (loss, _), g = value_and_grad(
            lambda p: zoo.lm_loss(cfg, cast_bf16(p), b, q_chunk=128, remat=remat),
            params)
        out[remat] = [loss] + tree_leaves(g)
    for remat in ("full", True, "dots"):
        for a, w in zip(out[remat], out[False]):
            assert torch.equal(a, w)
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(lambda p: zoo.lm_loss(cfg, p, b, remat="some"), params)


def test_remat_recomputes_the_units(monkeypatch):
    """Under "full" the backward runs each stacked unit's forward again;
    "dots" recomputes only what is not a weight product."""
    _, cfg, _, params = _models("demo-100m", n_layers=3)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg.vocab, 3).items()}
    calls = {"n": 0}
    real = T.apply_layer

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(T, "apply_layer", counting)
    for remat, want in ((False, 3), ("full", 6), ("dots", 6)):
        calls["n"] = 0
        value_and_grad(lambda p: zoo.lm_loss(cfg, p, b, remat=remat), params)
        assert calls["n"] == want, (remat, calls["n"])


# -------------------------------------------------------------- train step

@pytest.mark.parametrize("arch", ["demo-100m", "gemma3-1b"])
def test_make_train_step_matches_reference(arch):
    """3 steps from the reference's initial parameters on the reference's
    batches: loss, ce, grad_norm, parameters and moments each step."""
    ref_cfg, cfg, ref_params, params = _models(arch)
    ref_step, ref_opt = ref_make_train_step(ref_cfg, lr=LR, q_chunk=128)
    ref_step = jax.jit(ref_step)
    step, opt = make_train_step(cfg, lr=LR, q_chunk=128)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    data = RefLMData(8, cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    for k in range(3):
        batch = data.batch(rng.integers(0, 8, 4), 64)
        w = rng.uniform(size=4).astype(np.float32)
        batch["loss_weights"] = w / w.sum()
        ref_b, b = _both(batch)
        ref_params, ref_state, ref_m = ref_step(ref_params, ref_state, ref_b)
        params, state, m = step(params, state, b)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["ce"]), float(ref_m["ce"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=GNORM_RTOL)
        _check_params(params, ref_params, k + 1)
        assert int(state.count) == int(ref_state.count) == k + 1
        assert all(x.dtype == torch.float32 for x in tree_leaves(params))
    # the moments: the same gradients' averages, so within the gradients'
    # rounding step of the reference's
    for got, want in zip(tree_leaves(state.mu), _ref_leaves(ref_state.mu)):
        assert np.abs(got.numpy() - want).max() <= BF16_STEP * np.abs(want).max()


def test_train_step_from_reference_state_after_k_steps():
    """The port starts from the reference's parameters and AdamW state
    after 2 steps and takes the third as the reference does."""
    ref_cfg, cfg, ref_params, _ = _models("demo-100m")
    ref_step, ref_opt = ref_make_train_step(ref_cfg, lr=LR, q_chunk=128)
    ref_step = jax.jit(ref_step)
    ref_state = ref_opt.init(ref_params)
    data = RefLMData(8, cfg.vocab, seed=4)
    batches = [data.batch(np.array([0, 1, 2, 3]), 64) for _ in range(3)]
    for batch in batches[:2]:
        ref_params, ref_state, _ = ref_step(ref_params, ref_state,
                                            _both(batch)[0])
    params = params_from_numpy(np_tree(ref_params), device="cpu")
    state = adam_state_from_numpy(np_tree(ref_state), device="cpu")
    step, _ = make_train_step(cfg, lr=LR, q_chunk=128)
    ref_b, b = _both(batches[2])
    ref_params, ref_state, ref_m = ref_step(ref_params, ref_state, ref_b)
    params, state, m = step(params, state, b)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=LOSS_RTOL)
    _check_params(params, ref_params, 1)
    assert int(state.count) == 3


def test_refuse_autograd_guard():
    """Kernel 6's wrapper, the one kernel without a backward, calls this
    on the card: it raises where autograd records through an operand, and
    nowhere else.  Kernel 5 has its backward and no guard."""
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    with pytest.raises(NotImplementedError, match="kernel 6"):
        refuse_autograd("swa_decode", y, x, None)
    refuse_autograd("swa_decode", y, None)
    with torch.no_grad():
        refuse_autograd("swa_decode", x)
    assert set(BACKWARD_SLICE) == {"swa_decode"}


# ------------------------------------------------------------------ driver

def _ref_draws(steps=8, n=8):
    """The reference driver's participation draws at ``DRIVER_ARGS``,
    step by step, as its loop makes them."""
    cfg = ref_get_arch("demo-100m").reduced()
    problem = ref_sample_problem(0, n, tau_th=2.0,
                                 grad_size_bits=ref_zoo.grad_size_bits(cfg),
                                 total_bandwidth_hz=n * 10e6)
    sched = RefScheduler(solver="alternating")
    state = sched.precompute(problem)
    key, draws = jax.random.PRNGKey(3), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        d = sched.sample(state, sub)
        draws.append((np.asarray(d.mask), np.asarray(d.power)))
    return draws


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference launcher at its test's arguments, logged every step,
    with a checkpoint at step 4 and its draws."""
    d = tmp_path_factory.mktemp("ref")
    argv = DRIVER_ARGS + ["--log-every", "1", "--ckpt-dir", str(d / "ckpt"),
                          "--ckpt-every", "4"]
    hist = ref_train.main(argv)
    return {"hist": hist, "ckpt": d / "ckpt",
            "draws": _ref_draws()}


def _check_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["sim_time_s"], w["sim_time_s"], rtol=SIM_RTOL)
        np.testing.assert_allclose(g["sim_energy_j"], w["sim_energy_j"],
                                   rtol=SIM_RTOL)


def test_driver_matches_reference_with_its_draws(reference_run, tmp_path):
    out = tmp_path / "hist.json"
    argv = DRIVER_ARGS + ["--log-every", "1", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path / "ckpt"),
                          "--out", str(out)]
    hist = train.main(argv, draws=reference_run["draws"],
                      params=_models("demo-100m")[3])
    assert len(hist) == 8
    _check_history(hist, reference_run["hist"])
    assert json.loads(out.read_text()) == hist
    # the final checkpoints: parameters within the step tolerance
    _, ref_p, _, _ = ref_ckpt.restore(
        reference_run["ckpt"], 8,
        params_template=ref_T.init_params(ref_get_arch("demo-100m").reduced(),
                                          jax.random.PRNGKey(0)))
    cfg = get_arch("demo-100m").reduced()
    _, p, state, _ = ckpt.restore(
        tmp_path / "ckpt", 8,
        params_template=T.init_params(cfg, torch.Generator(), device="cpu"),
        opt_template=make_train_step(cfg)[1].init(
            T.init_params(cfg, torch.Generator(), device="cpu")))
    _check_params(p, ref_p, 8)
    assert int(state.count) == 8
    # the port's uncompressed checkpoint restores in the reference
    _, back, _, _ = ref_ckpt.restore(tmp_path / "ckpt", 8,
                                     params_template=ref_p)
    for g, w in zip(tree_leaves(p), _ref_leaves(back)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_reference_checkpoint_resumes_in_the_port(reference_run, tmp_path):
    """The reference's step-4 checkpoint restores in the port leaf for
    leaf, and the port's continued run, on the reference's draws, follows
    the reference's uninterrupted run."""
    ref_dir = reference_run["ckpt"]
    _, ref_p, ref_s, _ = ref_ckpt.restore(
        ref_dir, 4, params_template=ref_T.init_params(
            ref_get_arch("demo-100m").reduced(), jax.random.PRNGKey(0)),
        opt_template=ref_make_train_step(ref_get_arch("demo-100m").reduced())[1]
        .init(ref_T.init_params(ref_get_arch("demo-100m").reduced(),
                                jax.random.PRNGKey(0))))
    d = tmp_path / "ckpt"
    d.mkdir()
    for suffix in ("json", "npz"):
        (d / f"ckpt_00000004.{suffix}").write_bytes(
            (ref_dir / f"ckpt_00000004.{suffix}").read_bytes())
    cfg = get_arch("demo-100m").reduced()
    template = T.init_params(cfg, torch.Generator(), device="cpu")
    step0, p, s, _ = ckpt.restore(d, params_template=template,
                                  opt_template=make_train_step(cfg)[1].init(template))
    assert step0 == 4 and int(s.count) == 4 and s.count.dtype == torch.int32
    for got, want in ((p, ref_p), (s.mu, ref_s.mu), (s.nu, ref_s.nu)):
        for g, w in zip(tree_leaves(got), _ref_leaves(want)):
            np.testing.assert_array_equal(g.numpy(), w)
    hist = train.main(DRIVER_ARGS + ["--log-every", "1", "--device", "cpu",
                                     "--ckpt-dir", str(d), "--resume"],
                      draws=reference_run["draws"])
    _check_history(hist, reference_run["hist"][4:])


def test_resume_continues_the_uninterrupted_run_bit_for_bit(tmp_path):
    """The launcher's own draws: 4 steps, then --resume to 8, equals 8
    steps in one run: history, parameters and moments bit for bit."""
    base = DRIVER_ARGS + ["--log-every", "1", "--device", "cpu"]
    whole = train.run(train.parse_args(base))
    part = base[:]
    part[part.index("--steps") + 1] = "4"
    train.main(part + ["--ckpt-dir", str(tmp_path)])
    resumed = train.run(train.parse_args(base + ["--ckpt-dir", str(tmp_path),
                                                 "--resume"]))
    assert resumed["history"] == whole["history"][4:]
    assert len(resumed["step_s"]) == 4
    for got, want in ((resumed["params"], whole["params"]),
                      (resumed["opt_state"], whole["opt_state"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w)


def test_resume_of_a_given_config_continues_bit_for_bit(tmp_path, capsys):
    """``run(cfg=)`` trains the configuration handed in, here mamba2
    reduced and cut to one layer, so every step goes through the SSD
    scan's Function: 4 rounds, then --resume to 8, equals 8 in one run:
    history, parameters and moments bit for bit."""
    cfg = dataclasses.replace(get_arch("mamba2-780m").reduced(), n_layers=1)
    base = ["--arch", "mamba2-780m", "--steps", "8", "--batch", "2", "--seq",
            "64", "--n-clients", "8", "--log-every", "1", "--device", "cpu"]
    whole = train.run(train.parse_args(base), cfg=cfg)
    assert "arch mamba2-780m-reduced: 1L d=256 vocab=512" in capsys.readouterr().out
    assert [tuple(t.shape) for t in tree_leaves(whole["params"])] == [
        tuple(t.shape) for t in tree_leaves(
            T.init_params(cfg, torch.Generator(), device="cpu"))]
    part = base[:]
    part[part.index("--steps") + 1] = "4"
    train.run(train.parse_args(part + ["--ckpt-dir", str(tmp_path)]), cfg=cfg)
    resumed = train.run(train.parse_args(base + ["--ckpt-dir", str(tmp_path),
                                                 "--resume"]), cfg=cfg)
    tail = [h for h in whole["history"] if h["step"] > 4]
    assert tail and resumed["history"] == tail
    for got, want in ((resumed["params"], whole["params"]),
                      (resumed["opt_state"], whole["opt_state"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    """The reference launcher test's arguments with --device cpu; then
    --resume continues from the last checkpoint."""
    d, out = tmp_path / "ckpt", tmp_path / "hist.json"
    hist = train.main(DRIVER_ARGS + ["--log-every", "4", "--device", "cpu",
                                     "--ckpt-dir", str(d), "--ckpt-every", "4",
                                     "--out", str(out)])
    assert [h["step"] for h in hist] == [4, 8]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert json.loads(out.read_text()) == hist
    assert ckpt.latest_step(d) == 8 and (d / "ckpt_00000004.npz").exists()
    printed = capsys.readouterr().out
    assert "arch demo-100m-reduced: 2L d=256 vocab=512" in printed
    assert "step     8 loss=" in printed and printed.rstrip().endswith("done")
    more = DRIVER_ARGS[:]
    more[more.index("--steps") + 1] = "10"
    hist = train.main(more + ["--log-every", "1", "--device", "cpu",
                              "--ckpt-dir", str(d), "--resume"])
    assert "resumed from step 8" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [9, 10]


def test_driver_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(DRIVER_ARGS)
