"""Analysis gate of the port: the counterpart of ``repro.analysis``.

Two passes, each usable standalone and wired together by
``python -m repro_torch.analysis --gate``:

* :mod:`repro_torch.analysis.recompile` — :class:`BuildBudget` (builds
  and loads of the kernel library) and :class:`HostSyncBudget` (host
  reads of device data and waits for the card), the counterparts of the
  reference's XLA-compilation counter ``CompileBudget``.
* :mod:`repro_torch.analysis.hotpaths` — the reference's five registered
  production hot paths and their steady-state budgets (``budgets.json``
  beside this module).
* :mod:`repro_torch.analysis.rank` — the exhaustive [N]/[N,K]
  rank-contract sweep over ``WirelessFLProblem``.

The reference's other two passes have no counterpart here:

* ``repro.analysis.prng`` walks jaxprs for threefry key reuse.  The port
  draws from explicit ``torch.Generator`` objects that its callers pass,
  and its parity tests take the reference's draws as inputs, so there is
  no implicit key stream to audit.
* ``repro.analysis.hygiene``'s donation and weak-type audits concern XLA
  buffer donation and jax's weak types, which eager torch does not have;
  its static host-sync scan looks for syncs inside jit-traced functions,
  and in eager torch the dynamic count of :class:`HostSyncBudget` over
  the hot paths takes its place.
"""
from repro_torch.analysis.hotpaths import (HOT_PATHS, check_budget,
                                           default_budgets_path, load_budgets,
                                           measure, measure_all,
                                           register_hot_path)
from repro_torch.analysis.rank import (RankFinding, broadcastable_leaves,
                                       sweep_rank_contract)
from repro_torch.analysis.recompile import (BuildBudget, BuildBudgetExceeded,
                                            HostSyncBudget,
                                            HostSyncBudgetExceeded)

__all__ = [
    "HOT_PATHS",
    "BuildBudget",
    "BuildBudgetExceeded",
    "HostSyncBudget",
    "HostSyncBudgetExceeded",
    "RankFinding",
    "broadcastable_leaves",
    "check_budget",
    "default_budgets_path",
    "load_budgets",
    "measure",
    "measure_all",
    "register_hot_path",
    "sweep_rank_contract",
]
