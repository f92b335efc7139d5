"""Numpy in, tensors out: how state made elsewhere enters the port.

The port never sees a foreign array type.  A caller that holds the
reference's model parameters, problem or solver state converts them to
numpy first (``np.asarray`` leafwise) and hands them in here; the layouts
are the reference's (HWIO conv weights, ``[N]``/``[N, K]`` problem
leaves, the transformer's ``[d_in, d_out]`` weights with stacked
``reps`` leaves and AdamW's moments in their tree, ``(a, power)`` warm
starts shaped like the solution).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.alternating import WarmStart
from repro_torch.core.multicell import CoupledDuals
from repro_torch.core.problem import _TENSOR_FIELDS, WirelessFLProblem
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import AdamState
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


def adam_state_from_numpy(state, device=None) -> AdamState:
    """An AdamW state from host arrays: ``state`` has the reference's
    fields ``mu`` and ``nu`` (trees of the parameters' structure) and
    ``count``; the moments keep their float32, the count becomes an int32
    0-dim tensor, all on ``device``."""
    dev = resolve_device(device)
    return AdamState(mu=params_from_numpy(state.mu, dev),
                     nu=params_from_numpy(state.nu, dev),
                     count=torch.tensor(int(np.asarray(state.count)),
                                        dtype=torch.int32, device=dev))


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


def warm_start_from_numpy(a, power, device=None) -> WarmStart:
    """A warm-start state (``JointSolution.resume``,
    ``BatchSolution.resume``) from host arrays, float32 on ``device``."""
    dev = resolve_device(device)
    return WarmStart(a=_tensor(np.asarray(a, np.float32), dev),
                     power=_tensor(np.asarray(power, np.float32), dev))


def coupled_duals_from_numpy(interference, mu, warm_a=None, warm_power=None,
                             device=None) -> CoupledDuals:
    """A metro tick's dual state (``MultiCellSolution.resume``) from host
    arrays: the interference estimate and backhaul price stay float64
    numpy, as the outer loop keeps them; the element warm start, when
    given, becomes float32 tensors on ``device``."""
    warm = None if warm_a is None else warm_start_from_numpy(
        warm_a, warm_power, device)
    return CoupledDuals(interference=np.array(interference, np.float64),
                        mu=np.array(mu, np.float64), warm=warm)
