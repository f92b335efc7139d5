"""Trees of tensors: the port's counterpart of jax pytrees for model
parameters and caches.  A tree is a dict (``{"conv1": {"w": ..., "b":
...}, ...}``), a list or tuple (the transformer's ``"prefix"``/``"tail"``
layers), or a NamedTuple (``KVCache``), nested; anything else is a leaf.
"""
from __future__ import annotations

from typing import Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the order jax flattens to: each dict's keys sorted,
    lists, tuples and NamedTuple fields in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]
