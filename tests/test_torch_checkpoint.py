"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same on-disk format, so a
checkpoint written by either package restores in the other.

Leaves are compared exactly: the format stores every array as it is.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.models import cnn as ref_cnn
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import params_from_numpy
from repro_torch.models import cnn
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)


class Moments(NamedTuple):
    mu: object
    nu: object


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def mixed_tree(rng):
    """Dicts (keys out of order), a list, a tuple, a NamedTuple and a
    None, over float32, float16 and int64 leaves."""
    return {"zeta": rng.standard_normal((3, 2)).astype(np.float32),
            "alpha": [rng.standard_normal(4).astype(np.float16),
                      (np.arange(5, dtype=np.int64), None)],
            "moments": Moments(mu=rng.standard_normal(2).astype(np.float32),
                               nu={"b": np.float32(3.5) * np.ones(1, np.float32),
                                   "a": np.zeros((2, 2), np.float32)})}


def to_torch(tree):
    if tree is None or isinstance(tree, np.ndarray):
        return None if tree is None else torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, Moments):
        return Moments(*(to_torch(v) for v in tree))
    return type(tree)(to_torch(v) for v in tree)


def test_keypaths_spell_as_jax_keystr():
    tree = mixed_tree(np.random.default_rng(0))
    ref = [(jax.tree_util.keystr(p), leaf)
           for p, leaf in jax.tree_util.tree_leaves_with_path(tree)]
    got = ckpt._leaves_with_path(to_torch(tree))
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert "['alpha'][1][0]" in dict(got) and ".nu['a']" in \
        "".join(k for k, _ in got)
    for (_, g), (_, r) in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def test_round_trip_keeps_structure_dtype_and_values(tmp_path):
    tree = to_torch(mixed_tree(np.random.default_rng(1)))
    opt = {"step": torch.tensor(7), "lr": torch.tensor([0.1, 0.2])}
    fn = ckpt.save(tmp_path, 12, tree, opt, extra={"note": "x", "n": 3})
    assert fn.name == "ckpt_00000012.npz"
    assert (tmp_path / "ckpt_00000012.json").exists()
    assert ckpt.latest_step(tmp_path) == 12
    tmpl = jax.tree_util.tree_map(torch.zeros_like, tree,
                                  is_leaf=lambda x: isinstance(x, torch.Tensor))
    step, params, opt_back, extra = ckpt.restore(
        tmp_path, params_template=tmpl,
        opt_template={"step": torch.zeros((), dtype=torch.int64),
                      "lr": torch.zeros(2, dtype=torch.float64)})
    assert step == 12 and extra == {"note": "x", "n": 3}
    assert isinstance(params["moments"], Moments)
    assert params["alpha"][1][1] is None
    for g, r in zip(tree_leaves(params), tree_leaves(tree)):
        if r is None:
            continue
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert opt_back["lr"].dtype == torch.float64       # the template's dtype
    assert torch.equal(opt_back["lr"], opt["lr"].double())


def test_latest_step_and_missing_checkpoints(tmp_path):
    assert ckpt.latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, params_template={"a": torch.zeros(1)})
    for s in (3, 11, 7):
        ckpt.save(tmp_path, s, {"a": torch.full((1,), float(s))})
    assert ckpt.latest_step(tmp_path) == 11
    step, p, opt, extra = ckpt.restore(tmp_path, params_template={"a": torch.zeros(1)})
    assert step == 11 and float(p["a"]) == 11.0 and opt is None and extra is None
    step, p, _, _ = ckpt.restore(tmp_path, 7, params_template={"a": torch.zeros(1)})
    assert float(p["a"]) == 7.0


def test_restore_refuses_a_missing_leaf_or_a_shape_mismatch(tmp_path):
    ckpt.save(tmp_path, 0, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match=r"\['b'\]"):
        ckpt.restore(tmp_path, params_template={"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(tmp_path, params_template={"a": torch.zeros(4)})


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params = ref_cnn.init(jax.random.PRNGKey(3))
    opt = {"m": jax.tree_util.tree_map(lambda x: 0.5 * x, params),
           "count": jnp.int32(4)}
    ref_ckpt.save(tmp_path, 5, params, opt, extra={"round": 5})
    tmpl = cnn.init(torch.Generator().manual_seed(0), device="cpu")
    step, got, got_opt, extra = ckpt.restore(
        tmp_path, params_template=tmpl,
        opt_template={"m": tmpl, "count": torch.zeros((), dtype=torch.int32)})
    assert step == 5 and extra == {"round": 5}
    for g, r in zip(tree_leaves(got), jax.tree_util.tree_leaves(params)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(tree_leaves(got_opt["m"]), jax.tree_util.tree_leaves(opt["m"])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got_opt["count"].dtype == torch.int32 and int(got_opt["count"]) == 4


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params = params_from_numpy(np_tree(ref_cnn.init(jax.random.PRNGKey(9))),
                               device="cpu")
    opt = [params, torch.tensor(2.0)]
    ckpt.save(tmp_path, 2, params, opt, extra={"a": [1, 2]})
    tmpl = ref_cnn.init(jax.random.PRNGKey(0))
    step, got, got_opt, extra = ref_ckpt.restore(
        tmp_path, params_template=tmpl, opt_template=[tmpl, jnp.float32(0.0)])
    assert step == 2 and extra == {"a": [1, 2]}
    for g, r in zip(jax.tree_util.tree_leaves(got), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(g), r.numpy())
    assert float(got_opt[1]) == 2.0
    for g, r in zip(jax.tree_util.tree_leaves(got_opt[0]), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(g), r.numpy())


def test_manifests_of_both_packages_are_identical(tmp_path):
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "layers": [{"b": rng.standard_normal(3).astype(np.float32)}] * 2}
    ref_ckpt.save(tmp_path / "ref", 1, jax.tree_util.tree_map(jnp.asarray, tree),
                  extra={"k": 1})
    ckpt.save(tmp_path / "port", 1, to_torch(tree), extra={"k": 1})
    name = "ckpt_00000001"
    assert (tmp_path / "ref" / f"{name}.json").read_text() == \
        (tmp_path / "port" / f"{name}.json").read_text()
    ref_npz = np.load(tmp_path / "ref" / f"{name}.npz")
    got_npz = np.load(tmp_path / "port" / f"{name}.npz")
    assert sorted(ref_npz.files) == sorted(got_npz.files)
    for f in ref_npz.files:
        np.testing.assert_array_equal(got_npz[f], ref_npz[f])
