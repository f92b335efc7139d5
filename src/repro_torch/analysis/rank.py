"""Rank-contract checker: exhaustive [N]/[N,K] broadcast sweeps.

The port's counterpart of ``repro.analysis.rank``, on
``repro_torch.core.problem.WirelessFLProblem``.  The ``_bcast_like``
contract (``core.problem`` module docstring) says every closed form
accepts its decision variables and optional leaves at rank 1 (``[N]``,
round-invariant) or rank 2 (``[N, K]``, per-round), broadcasting 1-d
operands across the round axis.  The reference re-fixed silent
violations of this contract three times, each for a *new* leaf, so this
pass sweeps every combination mechanically, with ``N != K`` so that a
mixed-up axis can never broadcast by coincidence.

For every method and every combination of leaf/argument ranks the
checker verifies one of two outcomes:

* the call returns the max-rank shape, and (for elementwise outputs)
  every round column is **bitwise identical** to an independent rank-1
  evaluation on the column-sliced problem, on the same device; or
* the call raises (shape errors are acceptable for combinations outside
  the documented contract — see ``RANK2_NEEDS_RANK2_CONSUMER``).

Silent success with a wrong shape or wrong column values is always a
finding.  A raise on a *supported* combination is also a finding.

Broadcastable leaves are discovered by dataclass introspection (every
non-static field with default ``None``), so a future optional leaf is
swept automatically the day it is added, with the strict contract by
default.  The samples are the reference's (the same numpy tables, copied
here), built with numpy and then moved to ``device``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.problem import WirelessFLProblem
from repro_torch.device import resolve_device

__all__ = [
    "LEAF_SAMPLES",
    "RANK2_NEEDS_RANK2_CONSUMER",
    "RankFinding",
    "broadcastable_leaves",
    "sweep_rank_contract",
]


class RankFinding(NamedTuple):
    method: str
    leaf_ranks: tuple          # ((leaf, rank|None), ...)
    arg_ranks: tuple           # ((arg, rank), ...)
    kind: str                  # "error" | "shape" | "columns"
    detail: str

    def __str__(self) -> str:
        leaves = ", ".join(f"{n}={r or 'absent'}" for n, r in self.leaf_ranks)
        args = ", ".join(f"{n}@{r}d" for n, r in self.arg_ranks)
        return (f"[{self.kind}] {self.method}({args or '-'}) with "
                f"leaves ({leaves}): {self.detail}")


def broadcastable_leaves(problem_cls=WirelessFLProblem) -> tuple[str, ...]:
    """Optional array leaves: non-static dataclass fields defaulting to
    ``None`` — today fading / interference / bits; future leaves are
    picked up here automatically."""
    return tuple(f.name for f in dataclasses.fields(problem_cls)
                 if not f.metadata.get("static") and f.default is None)


# per-leaf sample value at a given (n,) / (n, k) shape; unknown future
# leaves get a generic positive fill so the sweep still runs
LEAF_SAMPLES: dict[str, Callable[[tuple], np.ndarray]] = {
    "fading": lambda shape: 0.5 + 0.25 * np.arange(
        np.prod(shape), dtype=np.float32).reshape(shape),
    "interference": lambda shape: 1e-13 * (1.0 + np.arange(
        np.prod(shape), dtype=np.float32).reshape(shape)),
    "bits": lambda shape: np.float32(8.0) * (1.0 + (np.arange(
        np.prod(shape), dtype=np.float32).reshape(shape) % 3)),
}

# leaves whose rank-2 form is only contracted to work when the consuming
# expression already runs at rank 2.  Empty: every current leaf follows
# the uniform highest-rank rule.  Add a leaf name here (with a comment
# saying why) if a future leaf deliberately opts out of rank-2
# broadcasting.
RANK2_NEEDS_RANK2_CONSUMER: frozenset[str] = frozenset()

# method -> (decision args, output kind)
#   elementwise: [N] or [N, K], column-consistent
#   per_device:  always [N]
#   scalar:      always ()
_METHODS: dict[str, tuple[tuple[str, ...], str]] = {
    "path_gain": ((), "elementwise"),
    "compute_energy": ((), "per_device"),
    "rate": (("power",), "elementwise"),
    "tx_time": (("power",), "elementwise"),
    "upload_energy": (("power",), "elementwise"),
    "round_energy": (("power",), "elementwise"),
    "p_min": (("a",), "elementwise"),
    "objective": (("a",), "scalar"),
    "constraints_satisfied": (("a", "power"), "elementwise"),
}

_ARG_SAMPLES = {
    "a": lambda shape: np.linspace(0.1, 0.9, int(np.prod(shape)),
                                   dtype=np.float32).reshape(shape),
    "power": lambda shape: np.linspace(0.05, 0.8, int(np.prod(shape)),
                                       dtype=np.float32).reshape(shape),
}


def _tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _base_problem(n: int, problem_cls, device: torch.device):
    def full(v):
        return _tensor(np.full((n,), v, np.float32), device)

    return problem_cls(
        distance_m=_tensor(np.linspace(50.0, 300.0, n), device),
        bandwidth_hz=full(1e5),
        energy_budget_j=full(5.0),
        dataset_size=full(100.0),
        cycles_per_sample=full(1e4),
        cpu_hz=full(1e9),
        weights=full(1.0 / n),
        noise_power=1e-12,
        p_max=1.0,
        tau_th=0.5,
        n_rounds=1,
    )


def _leaf_value(name: str, rank: Optional[int], n: int, k: int,
                device: torch.device) -> Optional[torch.Tensor]:
    if rank is None:
        return None
    shape = (n,) if rank == 1 else (n, k)
    sample = LEAF_SAMPLES.get(name, lambda s: np.ones(s, np.float32))
    return _tensor(sample(shape), device)


def _column_slice(leaves: dict, col: int, n: int, problem_cls,
                  device: torch.device):
    """The rank-1 problem of round ``col``: 2-d leaves sliced, 1-d kept."""
    updates = {name: val[:, col] if val.ndim == 2 else val
               for name, val in leaves.items() if val is not None}
    return dataclasses.replace(_base_problem(n, problem_cls, device),
                               **updates)


def _supported(leaf_ranks: dict, arg_ranks: dict) -> bool:
    """Is this combination inside the documented contract?"""
    consumer_rank = max(
        [1]
        + [r for name, r in leaf_ranks.items()
           if r is not None and name not in RANK2_NEEDS_RANK2_CONSUMER]
        + list(arg_ranks.values()))
    return not any(
        r == 2 and name in RANK2_NEEDS_RANK2_CONSUMER and consumer_rank < 2
        for name, r in leaf_ranks.items())


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _bitwise_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(np.array_equal(a, b, equal_nan=(a.dtype.kind == "f")))


def sweep_rank_contract(problem_cls=WirelessFLProblem, *,
                        n: int = 3, k: int = 2,
                        methods: Optional[dict] = None,
                        device=None) -> tuple[list[RankFinding], dict]:
    """Sweep every (leaf rank) x (arg rank) combination of every method
    on ``device`` (default: the card).

    Returns ``(findings, stats)``; an empty findings list means the
    contract holds.  ``n != k`` is required — with ``n == k`` a
    transposed axis broadcasts silently and the sweep proves nothing.
    """
    if n == k:
        raise ValueError("the sweep needs n != k so mixed-up axes cannot "
                         "broadcast by coincidence")
    dev = resolve_device(device)
    leaves = broadcastable_leaves(problem_cls)
    methods = dict(_METHODS if methods is None else methods)
    findings: list[RankFinding] = []
    n_combos = 0

    for leaf_ranks_tuple in itertools.product([None, 1, 2],
                                              repeat=len(leaves)):
        leaf_ranks = dict(zip(leaves, leaf_ranks_tuple, strict=True))
        leaf_vals = {name: _leaf_value(name, r, n, k, dev)
                     for name, r in leaf_ranks.items()}
        problem = dataclasses.replace(
            _base_problem(n, problem_cls, dev),
            **{name: v for name, v in leaf_vals.items() if v is not None})

        for method, (arg_names, out_kind) in methods.items():
            for arg_ranks_tuple in itertools.product(
                    [1, 2], repeat=len(arg_names)):
                arg_ranks = dict(zip(arg_names, arg_ranks_tuple,
                                     strict=True))
                args = [_tensor(_ARG_SAMPLES[name](
                    (n,) if r == 1 else (n, k)), dev)
                    for name, r in arg_ranks.items()]
                n_combos += 1
                record = (method,
                          tuple(sorted(leaf_ranks.items())),
                          tuple(sorted(arg_ranks.items())))
                try:
                    out = _host(getattr(problem, method)(*args))
                except Exception as e:  # noqa: BLE001 - any raise is an
                    #                     acceptable contract outcome
                    if _supported(leaf_ranks, arg_ranks):
                        findings.append(RankFinding(
                            *record, kind="error",
                            detail=f"{type(e).__name__}: {e}"))
                    continue

                findings.extend(_check_output(
                    record, out, out_kind, problem_cls, leaf_vals,
                    arg_ranks, args, method, n, k, dev))

    stats = {"leaves": list(leaves), "n_combos": n_combos,
             "methods": sorted(methods), "device": str(dev)}
    return findings, stats


def _expected_rank(leaf_vals: dict, arg_ranks: dict, method: str) -> int:
    """Max rank among rank sources; unknown (future) leaves are assumed
    to influence every elementwise method — the strict default."""
    rank = max([1] + list(arg_ranks.values()))
    influencers = {
        "path_gain": {"fading", "interference"},
        "rate": {"fading", "interference"},
    }.get(method)
    for name, val in leaf_vals.items():
        if val is None or val.ndim < 2:
            continue
        if influencers is not None and name not in influencers:
            continue
        rank = 2
    return rank


def _check_output(record, out, out_kind, problem_cls, leaf_vals,
                  arg_ranks, args, method, n, k, dev) -> list[RankFinding]:
    if out_kind == "scalar":
        if out.shape != ():
            return [RankFinding(*record, kind="shape",
                                detail=f"expected scalar, got {out.shape}")]
        return []
    if out_kind == "per_device":
        if out.shape != (n,):
            return [RankFinding(*record, kind="shape",
                                detail=f"expected ({n},), got {out.shape}")]
        return []

    expected_rank = _expected_rank(leaf_vals, arg_ranks, method)
    expected_shape = (n,) if expected_rank == 1 else (n, k)
    if out.shape != expected_shape:
        return [RankFinding(*record, kind="shape",
                            detail=f"expected {expected_shape}, got "
                                   f"{out.shape}")]
    if expected_rank == 1:
        return []

    # column consistency: round col of the rank-2 result must be bitwise
    # the rank-1 evaluation on the column-sliced problem
    findings = []
    for col in range(k):
        sliced = _column_slice(leaf_vals, col, n, problem_cls, dev)
        col_args = [a[:, col] if a.ndim == 2 else a for a in args]
        try:
            ref = _host(getattr(sliced, method)(*col_args))
        except Exception as e:  # noqa: BLE001 - reported, not raised
            findings.append(RankFinding(
                *record, kind="columns",
                detail=f"column {col} reference eval raised "
                       f"{type(e).__name__}: {e}"))
            continue
        if not _bitwise_equal(ref, out[:, col]):
            findings.append(RankFinding(
                *record, kind="columns",
                detail=f"column {col} differs from the rank-1 "
                       f"evaluation of the column-sliced problem"))
    return findings
