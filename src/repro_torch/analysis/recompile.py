"""Build, load and host-sync sentinels: what a steady call may not do.

The reference counts XLA compilations per entry point
(``repro.analysis.recompile``): its worst regression re-traced an eager
``while_loop`` on every call, invisible to every correctness test.
Eager PyTorch compiles no program, so this module counts what takes its
place on the port's hot paths:

* :class:`BuildBudget` — the kernel library's builds and loads
  (``kernels.cuda_lib.BUILDS``: a build that ran ``nvcc``, not one that
  found the hashed library on disk; ``LOADS``: a ``ctypes.CDLL`` load).
  After warm-up a steady call makes neither.
* :class:`HostSyncBudget` — the host's reads of device data, each with
  the Python site (``file:line``) that made it, by two mechanisms:

  (a) ``reads``: a ``TorchDispatchMode`` that sees every aten op of the
      scope, on any device, also under ``torch.func.vmap(grad)``.  It
      counts the ops whose result the host must wait for:
      ``_local_scalar_dense`` and ``equal`` (``.item()``, ``bool()``,
      ``float()``, ``int()`` of a tensor, ``torch.equal``), kind
      ``"scalar"``; the ops whose output shape depends on the data
      (``nonzero``, ``masked_select``, the ``unique`` family,
      ``bincount``, ``repeat_interleave`` with tensor repeats and no
      ``output_size``, indexing and index-put with a boolean index),
      kind ``"shape"``; and ``_to_copy`` / ``copy_`` from a tensor off
      the CPU into one on it, kind ``"to_host"``.
  (b) ``syncs``, where CUDA is available: the warnings of
      ``torch.cuda.set_sync_debug_mode("warn")`` (every op that waits for
      the stream: the reads of (a) on the card, and copies to the card
      from pageable host memory, which (a) does not count because they
      read no device data), plus the explicit ``torch.cuda.synchronize``
      calls, which that mode does not see and which are counted by
      wrapping the function for the scope.  ``None`` without CUDA.  The
      mode is a prototype that "does not yet detect all synchronizing
      operations" (its own notice), so (b) is a lower bound.

Where (a) and (b) differ, and why:

* a copy to the host is a read only when the tensor lies on a device:
  on the CPU ``.cpu()`` returns the tensor itself and no aten op runs,
  so (a) counts its ``to_host`` reads on the card only (hot-path budgets
  therefore give ``to_host`` apart from the reads every device makes);
* ``.tolist()``, ``.numpy()`` and ``np.asarray`` of a CPU tensor are no
  aten ops: neither mechanism sees them, and on the card the ``.cpu()``
  that must come first is seen by both;
* (b) counts copies to the card (``.to("cuda")`` of host data) and
  explicit synchronisations, which (a) does not.

Both budgets follow ``CompileBudget``'s semantics: ``budget=None`` only
measures; an integer budget raises on exit when exceeded, unless
``strict=False``; an exception in the body is never swallowed; the error
names what it counted.

Usage::

    with BuildBudget(budget=0, name="steady"), \\
            HostSyncBudget(budget=3, name="steady") as hs:
        solve(...)
    hs.count, hs.sites()        # host reads and where they were made

Budgets for the registered hot paths live in ``analysis/budgets.json``
beside this module and are enforced by ``python -m repro_torch.analysis
--gate`` (see ``repro_torch.analysis.hotpaths``).
"""
from __future__ import annotations

import collections
import functools
import re
import sys
import warnings
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cuda_lib

__all__ = [
    "BuildBudget",
    "BuildBudgetExceeded",
    "HostRead",
    "HostSyncBudget",
    "HostSyncBudgetExceeded",
]

_SRC = Path(__file__).resolve().parents[2]          # .../src
_TORCH = Path(torch.__file__).resolve().parent
# this module's frames, and those that deliver a warning to showwarning
_SKIP = frozenset({str(Path(__file__).resolve()),
                   str(Path(warnings.__file__).resolve())})

_SCALAR_OPS = frozenset({"_local_scalar_dense", "equal"})
_SHAPE_OPS = frozenset({"nonzero", "masked_select", "_unique", "_unique2",
                        "unique_consecutive", "unique_dim",
                        "unique_dim_consecutive", "bincount"})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                        "_index_put_impl_"})
_SYNC_WARNING = re.compile(r"called a synchronizing CUDA operation")
_PROTOTYPE_NOTICE = "Synchronization debug mode is a prototype feature"


class HostRead(NamedTuple):
    kind: str          # "scalar" | "shape" | "to_host" | "sync_debug" | "synchronize"
    site: str          # file:line of the Python frame that made it


@functools.lru_cache(maxsize=None)
def _shown(filename: str) -> Optional[str]:
    """How a frame of ``filename`` is shown in a site: ``None`` for the
    frames skipped (torch's and this module's), files under ``src/``
    relative to it (``repro_torch/core/...``), other files of the
    checkout relative to its root (``tests/...``)."""
    path = Path(filename).resolve()
    if str(path) in _SKIP or path.is_relative_to(_TORCH):
        return None
    for root in (_SRC, _SRC.parent):
        if path.is_relative_to(root):
            return str(path.relative_to(root))
    return filename


def _site(frame) -> str:
    """``file:line`` of the innermost frame outside torch and this module."""
    while frame is not None:
        name = _shown(frame.f_code.co_filename)
        if name is not None:
            return f"{name}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


def _off_cpu(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _read_kind(func, args, kwargs) -> Optional[str]:
    """The kind of host read ``func(*args, **kwargs)`` makes, if any."""
    name = func.overloadpacket.__name__
    if name in _SCALAR_OPS:
        return "scalar"
    if name in _SHAPE_OPS:
        return "shape"
    if name == "repeat_interleave":
        if isinstance(args[0] if args else None, torch.Tensor) and \
                func._overloadname in ("Tensor", "self_Tensor") and \
                kwargs.get("output_size") is None:
            return "shape"
        return None
    if name in _INDEX_OPS and len(args) > 1:
        if any(isinstance(i, torch.Tensor)
               and i.dtype in (torch.bool, torch.uint8) for i in args[1] or ()):
            return "shape"
        return None
    if name == "_to_copy":
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cpu" \
                and _off_cpu(args[0]):
            return "to_host"
        return None
    if name == "copy_":
        dst, src = args[0], args[1]
        if isinstance(dst, torch.Tensor) and dst.device.type == "cpu" \
                and _off_cpu(src):
            return "to_host"
    return None


class _ReadMode(TorchDispatchMode):
    """Mechanism (a): records every host-reading aten op and its site."""

    def __init__(self, reads: list) -> None:
        super().__init__()
        self.reads = reads

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _read_kind(func, args, kwargs)
        if kind is not None:
            self.reads.append(HostRead(kind, _site(sys._getframe(1))))
        return func(*args, **kwargs)


class BuildBudgetExceeded(RuntimeError):
    """More kernel-library builds or loads happened inside a
    ``BuildBudget`` block than its budget allows."""


class HostSyncBudgetExceeded(RuntimeError):
    """More host reads of device data (or synchronisations with the
    card) happened inside a ``HostSyncBudget`` block than its budget
    allows."""


class BuildBudget:
    """Context manager that counts the kernel library's builds and loads
    in its block.

    Attributes after exit: ``builds`` (``nvcc`` runs), ``loads``
    (``ctypes.CDLL`` loads) and ``count`` (their sum, which ``budget``
    bounds).
    """

    def __init__(self, budget: Optional[int] = 0, *, name: str = "",
                 strict: bool = True) -> None:
        self.budget = budget
        self.name = name
        self.strict = strict
        self.builds = self.loads = self.count = 0
        self._start = (0, 0)

    def __enter__(self) -> "BuildBudget":
        self._start = (cuda_lib.BUILDS, cuda_lib.LOADS)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.builds = cuda_lib.BUILDS - self._start[0]
        self.loads = cuda_lib.LOADS - self._start[1]
        self.count = self.builds + self.loads
        if (exc_type is None and self.strict
                and self.budget is not None and self.count > self.budget):
            label = f" [{self.name}]" if self.name else ""
            raise BuildBudgetExceeded(
                f"build budget exceeded{label}: {self.builds} nvcc build(s) "
                f"and {self.loads} load(s) of the kernel library, budget "
                f"{self.budget}")


class HostSyncBudget:
    """Context manager that counts the host's reads of device data in its
    block (mechanism (a), every device) and, where CUDA is available, the
    host's waits for the card (mechanism (b)); see the module docstring
    for what each covers.

    ``budget`` bounds ``count`` (the reads of (a)) and, where they are
    counted, ``syncs``.

    Attributes after exit: ``reads`` (:class:`HostRead` per read of (a)),
    ``count``, ``syncs`` (``None`` without CUDA), ``sync_reads`` (the
    waits of (b) as :class:`HostRead`, kind ``"sync_debug"`` or
    ``"synchronize"``).
    """

    def __init__(self, budget: Optional[int] = 0, *, name: str = "",
                 strict: bool = True) -> None:
        self.budget = budget
        self.name = name
        self.strict = strict
        self.reads: list[HostRead] = []
        self.sync_reads: list[HostRead] = []
        self.count = 0
        self.syncs: Optional[int] = None
        self._mode: Optional[_ReadMode] = None
        self._cuda = False
        self._catch = None
        self._prev_sync_mode = 0
        self._synchronize = None

    def sites(self, reads=None) -> dict[str, int]:
        """``{site: count}`` of ``reads`` (default: the reads of (a))."""
        return dict(collections.Counter(
            r.site for r in (self.reads if reads is None else reads)))

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if _SYNC_WARNING.search(str(message)):
            self.sync_reads.append(HostRead("sync_debug",
                                            _site(sys._getframe(1))))
        else:
            self._showwarning(message, category, filename, lineno, file, line)

    def __enter__(self) -> "HostSyncBudget":
        self._cuda = torch.cuda.is_available()
        if self._cuda:
            self._catch = warnings.catch_warnings()
            self._catch.__enter__()
            # every occurrence, not once per site (the default filter);
            # the mode's own notice that it is a prototype is noise here
            warnings.simplefilter("always")
            warnings.filterwarnings("ignore", message=_PROTOTYPE_NOTICE)
            self._showwarning = warnings.showwarning
            warnings.showwarning = self._show
            self._synchronize = torch.cuda.synchronize

            def synchronize(device=None):
                self.sync_reads.append(HostRead("synchronize",
                                                _site(sys._getframe(1))))
                return self._synchronize(device)

            torch.cuda.synchronize = synchronize
            self._prev_sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self._mode = _ReadMode(self.reads)
        self._mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._mode.__exit__(exc_type, exc, tb)
        finally:
            if self._cuda:
                torch.cuda.set_sync_debug_mode(self._prev_sync_mode)
                torch.cuda.synchronize = self._synchronize
                self._catch.__exit__(exc_type, exc, tb)
        self.count = len(self.reads)
        self.syncs = len(self.sync_reads) if self._cuda else None
        if exc_type is not None or not self.strict:
            return
        label = f" [{self.name}]" if self.name else ""
        if self.budget is not None and self.count > self.budget:
            raise HostSyncBudgetExceeded(
                f"host-sync budget exceeded{label}: {self.count} host "
                f"read(s) of device data, budget {self.budget}; sites: "
                f"{self.sites()}")
        if (self.syncs is not None and self.budget is not None
                and self.syncs > self.budget):
            raise HostSyncBudgetExceeded(
                f"host-sync budget exceeded{label}: {self.syncs} wait(s) "
                f"for the card, budget {self.budget}; sites: "
                f"{self.sites(self.sync_reads)}")
