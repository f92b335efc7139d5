"""Checkpointing: save/restore of param/optimizer trees of tensors.

Storage is one ``ckpt_%08d.npz`` per step plus a JSON manifest of the
tree structure (keypath -> array name), the format of
``repro.checkpoint.checkpoint``.  Keypaths are spelled as
``jax.tree_util.keystr`` spells them (``"['conv1']['w']"`` for dicts,
``"[0]"`` for lists and tuples, ``".field"`` for NamedTuples), so a
checkpoint written by either package restores in the other.  Tensors are
copied to the host to be saved; ``restore`` builds each leaf on its
template leaf's device and in its dtype.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import _is_namedtuple


def _leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr, leaf) pairs in the order jax flattens to; ``None`` is an
    empty subtree, as in jax."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in _leaves_with_path(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from ``leaves`` (an
    iterator, in flattening order)."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, leaves) for v in template]
        return type(template)(*out) if _is_namedtuple(template) \
            else type(template)(out)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str | Path, step: int, params, opt_state=None,
         extra: Optional[dict] = None) -> Path:
    """Write ``ckpt_{step}.npz`` and its manifest.  The arrays are stored
    uncompressed, where the reference deflates them: ``np.load`` (so
    either package's ``restore``) reads both, and a model's float32
    weights barely compress while zlib takes about a minute a GB."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    blobs: dict[str, np.ndarray] = {}
    manifest: dict = {"step": step, "trees": {}}

    def add(name, tree):
        if tree is None:
            return
        names = {}
        for i, (key, leaf) in enumerate(sorted(_leaves_with_path(tree),
                                               key=lambda kv: kv[0])):
            arr_name = f"{name}_{i}"
            blobs[arr_name] = _host(leaf)
            names[key] = arr_name
        manifest["trees"][name] = names

    add("params", params)
    add("opt", opt_state)
    if extra:
        manifest["extra"] = extra
    fn = path / f"ckpt_{step:08d}.npz"
    np.savez(fn, **blobs)
    (path / f"ckpt_{step:08d}.json").write_text(json.dumps(manifest))
    return fn


def latest_step(path: str | Path) -> Optional[int]:
    path = Path(path)
    steps = [int(m.group(1)) for p in path.glob("ckpt_*.json")
             if (m := re.match(r"ckpt_(\d+)\.json", p.name))]
    return max(steps) if steps else None


def restore(path: str | Path, step: Optional[int] = None,
            params_template=None, opt_template=None):
    """Restores (step, params, opt_state, extra); templates (trees of
    tensors of the target structure) define the output tree shape, and
    each leaf's device and dtype."""
    path = Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    manifest = json.loads((path / f"ckpt_{step:08d}.json").read_text())
    blobs = np.load(path / f"ckpt_{step:08d}.npz")

    def rebuild(name, template):
        if template is None or name not in manifest["trees"]:
            return None
        names = manifest["trees"][name]
        out_leaves = []
        for key, leaf in _leaves_with_path(template):
            if key not in names:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = blobs[names[key]]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            out_leaves.append(torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype))
        return _unflatten(template, iter(out_leaves))

    return (manifest["step"], rebuild("params", params_template),
            rebuild("opt", opt_template), manifest.get("extra"))
