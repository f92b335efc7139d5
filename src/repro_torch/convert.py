"""Numpy in, tensors out: how state made elsewhere enters the port.

The port never sees a foreign array type.  A caller that holds the
reference's model parameters or problem converts them to numpy first
(``np.asarray`` leafwise) and hands them in here; the layouts are the
reference's (HWIO conv weights, ``[N]``/``[N, K]`` problem leaves, the
transformer's ``[d_in, d_out]`` weights with stacked ``reps`` leaves).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.problem import _TENSOR_FIELDS, WirelessFLProblem
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(tree, device=None) -> dict:
    """A tree of arrays (nested dicts and lists: the CNN's ``{"conv1":
    {"w", "b"}, ...}``, the transformer's ``{"embed", "final_ln",
    "stack": {"l0": ...}, "tail": [...]}``) as tensors on ``device``,
    names, shapes and dtypes unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), tree)


def params_to_numpy(tree) -> dict:
    """The inverse of :func:`params_from_numpy`."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def problem_from_numpy(fields: dict, device=None) -> WirelessFLProblem:
    """A problem from its fields: arrays for the tensor leaves (``None``
    for absent optional leaves), python numbers for the constants."""
    dev = resolve_device(device)
    names = {f.name for f in dataclasses.fields(WirelessFLProblem)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown problem fields {sorted(unknown)}")
    kw = {}
    for name, value in fields.items():
        if name not in _TENSOR_FIELDS:
            kw[name] = int(value) if name == "n_rounds" else float(value)
        elif value is not None:
            kw[name] = _tensor(np.asarray(value), dev)
    return WirelessFLProblem(**kw)
