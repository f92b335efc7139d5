"""The port's analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* **Rank contract.**  The port's sweep finds the reference's leaves and
  reports the reference's stats with no finding; every one of the 27
  leaf-rank states x method x argument rank gets the same numpy inputs in
  both packages, which must agree on raising, shape and dtype, on
  booleans exactly and on values at rtol 1e-6 (1e-5 for ``p_min``: XLA's
  float32 ``expm1`` is a few ulps off torch's, see
  ``tests/test_torch_core.py``).  Planted defects (the reference's own
  fixtures, on the port's problem) must be flagged.
* **Counters.**  ``HostSyncBudget``'s mechanism (a) counts each host read
  once with its site, ``BuildBudget`` counts the builds that run ``nvcc``
  and the library's loads (through a stand-in compiler and loader), and
  both follow ``CompileBudget``'s raise semantics.
* **Hot paths.**  The reference's five names, every one budgeted, each
  with no build or load in steady state on the CPU and its host reads
  equal to its form, every read site named in its ``why``.
* **CLI.**  ``python -m repro_torch.analysis --device cpu --gate`` is green
  and writes its report; a lowered form turns it red.
"""
import dataclasses
import itertools
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hotpaths as ref_hotpaths
from repro.analysis import rank as ref_rank
from repro.core.problem import WirelessFLProblem as RefProblem
from repro_torch.analysis import (HOT_PATHS, BuildBudget, BuildBudgetExceeded,
                                  HostSyncBudget, HostSyncBudgetExceeded,
                                  broadcastable_leaves, check_budget,
                                  load_budgets, measure, sweep_rank_contract)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import hotpaths, rank
from repro_torch.analysis.hotpaths import form_value
from repro_torch.core.problem import WirelessFLProblem, div
from repro_torch.kernels import cuda_lib

torch.set_num_threads(1)

CPU = torch.device("cpu")
N, K = 3, 2
THIS = "tests/test_torch_analysis.py:"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _host(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ rank

def test_broadcastable_leaves_match_reference():
    assert broadcastable_leaves() == ref_rank.broadcastable_leaves()
    assert broadcastable_leaves() == ("fading", "interference", "bits")


def test_sample_tables_and_methods_match_reference():
    assert rank._METHODS == ref_rank._METHODS
    assert rank.RANK2_NEEDS_RANK2_CONSUMER == ref_rank.RANK2_NEEDS_RANK2_CONSUMER
    assert set(rank.LEAF_SAMPLES) == set(ref_rank.LEAF_SAMPLES)
    for shape in ((N,), (N, K), (7, 5)):
        for name in rank.LEAF_SAMPLES:
            np.testing.assert_array_equal(rank.LEAF_SAMPLES[name](shape),
                                          ref_rank.LEAF_SAMPLES[name](shape))
        for name in rank._ARG_SAMPLES:
            np.testing.assert_array_equal(rank._ARG_SAMPLES[name](shape),
                                          ref_rank._ARG_SAMPLES[name](shape))
    ref_base = ref_rank._base_problem(N, RefProblem)
    base = rank._base_problem(N, WirelessFLProblem, CPU)
    for f in dataclasses.fields(RefProblem):
        want, got = getattr(ref_base, f.name), getattr(base, f.name)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(_host(got), np.asarray(want))
        else:
            assert got == want, f.name


def test_sweeps_report_the_same_stats_and_no_finding():
    findings, stats = sweep_rank_contract(device="cpu")
    ref_findings, ref_stats = ref_rank.sweep_rank_contract()
    assert findings == [] == ref_findings, "\n".join(map(str, findings))
    assert stats["n_combos"] == ref_stats["n_combos"] == 486
    assert stats["leaves"] == ref_stats["leaves"]
    assert stats["methods"] == ref_stats["methods"]
    assert stats["device"] == "cpu"


LEAF_STATES = list(itertools.product([None, 1, 2], repeat=3))


def _eval(problem, method, args):
    try:
        return getattr(problem, method)(*args), None
    except Exception as e:  # noqa: BLE001 - raising is compared, not judged
        return None, e


@pytest.mark.parametrize("ranks", LEAF_STATES, ids=str)
def test_rank_parity_with_reference(ranks):
    """Every method at every argument rank, on one leaf-rank state, with
    the same numpy inputs in both packages."""
    leaves = dict(zip(ref_rank.broadcastable_leaves(), ranks, strict=True))
    samples = {name: ref_rank.LEAF_SAMPLES[name]((N,) if r == 1 else (N, K))
               for name, r in leaves.items() if r is not None}
    ref_p = dataclasses.replace(
        ref_rank._base_problem(N, RefProblem),
        **{k: jnp.asarray(v) for k, v in samples.items()})
    port_p = dataclasses.replace(
        rank._base_problem(N, WirelessFLProblem, CPU),
        **{k: torch.from_numpy(v) for k, v in samples.items()})
    n_cases = 0
    for method, (arg_names, _) in ref_rank._METHODS.items():
        for arg_ranks in itertools.product([1, 2], repeat=len(arg_names)):
            args = [ref_rank._ARG_SAMPLES[a]((N,) if r == 1 else (N, K))
                    for a, r in zip(arg_names, arg_ranks, strict=True)]
            want, ref_err = _eval(ref_p, method, [jnp.asarray(a) for a in args])
            got, err = _eval(port_p, method, [torch.from_numpy(a) for a in args])
            case = f"{method}{arg_ranks} leaves {leaves}"
            assert (err is None) == (ref_err is None), (case, err, ref_err)
            n_cases += 1
            if err is not None:
                continue
            got, want = _host(got), np.asarray(want)
            assert got.shape == want.shape, case
            assert got.dtype == want.dtype, case
            if got.dtype == np.bool_:
                np.testing.assert_array_equal(got, want, err_msg=case)
            else:
                np.testing.assert_allclose(
                    got, want, rtol=1e-5 if method == "p_min" else 1e-6,
                    atol=0, err_msg=case)
    assert n_cases == 18


class _OldPathGainBug(WirelessFLProblem):
    """The reference's pre-fix ``path_gain``: base lifted to ``[:, None]``
    whenever fading is present, so a rank-1 fading silently builds
    [N, N]."""

    def path_gain(self):
        if self.fading is None or self.interference is not None:
            return super().path_gain()
        base = div(1.0, torch.square(self.distance_m) * self.noise_power)
        return torch.where(self.fading > 0, self.fading * base[:, None], 0.0)


class _DropsRoundAxisBug(WirelessFLProblem):
    """A method that collapses the round axis of a rank-2 result."""

    def rate(self, power):
        r = super().rate(power)
        return r[:, 0] if r.ndim == 2 else r


class _WrongColumnBug(WirelessFLProblem):
    """Right shape, wrong values: every round repeats column 0 — only the
    bitwise per-column check can see this."""

    def rate(self, power):
        r = super().rate(power)
        return torch.broadcast_to(r[:, :1], r.shape) if r.ndim == 2 else r


def test_requires_n_neq_k():
    with pytest.raises(ValueError, match="n != k"):
        sweep_rank_contract(n=3, k=3, device="cpu")


def test_flags_rank1_fading_shape_bug():
    findings, _ = sweep_rank_contract(
        _OldPathGainBug, methods={"path_gain": ((), "elementwise")},
        device="cpu")
    assert any(f.kind == "shape" and "(3, 3)" in f.detail for f in findings)


def test_flags_collapsed_round_axis():
    findings, _ = sweep_rank_contract(
        _DropsRoundAxisBug, methods={"rate": (("power",), "elementwise")},
        device="cpu")
    assert any(f.kind == "shape" for f in findings)


def test_flags_wrong_column_values():
    findings, _ = sweep_rank_contract(
        _WrongColumnBug, methods={"rate": (("power",), "elementwise")},
        device="cpu")
    assert findings and all(f.kind == "columns" for f in findings)


# -------------------------------------------------------------- counters

READS = {
    "item": lambda x: x.sum().item(),
    "bool": lambda x: bool(x.sum() > 0),
    "float": lambda x: float(x[0]),
    "int": lambda x: int(x[1]),
    "equal": lambda x: torch.equal(x, x),
}


@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("read", sorted(READS))
def test_counts_each_scalar_read(read, k):
    x = torch.arange(4.0)
    with HostSyncBudget(None, strict=False) as hs:
        for _ in range(k):
            READS[read](x)
    assert hs.count == k
    assert [r.kind for r in hs.reads] == ["scalar"] * k
    assert all(r.site.startswith(THIS) for r in hs.reads)
    assert hs.syncs is None          # mechanism (b) needs CUDA


@pytest.mark.parametrize("op", ["nonzero", "masked_select", "bool_index",
                                "bool_index_put"])
def test_counts_one_data_dependent_shape(op):
    x = torch.arange(5.0)
    mask = x > 1
    with HostSyncBudget(None, strict=False) as hs:
        if op == "nonzero":
            torch.nonzero(mask)
        elif op == "masked_select":
            torch.masked_select(x, mask)
        elif op == "bool_index":
            x[mask]
        else:
            x.clone()[mask] = 0.0
    assert [r.kind for r in hs.reads] == ["shape"]


def test_host_copies_of_host_tensors_are_no_reads():
    """On the CPU ``.cpu()`` runs no aten op and ``.numpy()`` /
    ``.tolist()`` are none: mechanism (a) sees no read (the module
    docstring says where the card differs)."""
    x = torch.arange(5.0)
    with HostSyncBudget(budget=0):
        x.cpu().numpy()
        x.tolist()
        torch.repeat_interleave(x, 2)        # int repeats: the shape is known


def test_strict_zero_budget_raises_and_names_the_site():
    x = torch.ones(())
    with pytest.raises(HostSyncBudgetExceeded) as ei, \
            HostSyncBudget(budget=0, name="steady"):
        float(x)
    assert "steady" in str(ei.value)
    assert THIS in str(ei.value)


def test_budget_within_limit_and_non_strict_do_not_raise():
    x = torch.ones(3)
    with HostSyncBudget(budget=2):
        x.sum().item()
        x.max().item()
    with HostSyncBudget(budget=0, strict=False) as hs:
        x.sum().item()
    assert hs.count == 1


def test_host_sync_budget_does_not_swallow_body_exception():
    x = torch.ones(3)
    with pytest.raises(ValueError, match="from body"), \
            HostSyncBudget(budget=0) as hs:
        x.sum().item()
        raise ValueError("from body")
    x.sum().item()                      # the mode is gone after the scope
    assert hs.count == 1


def test_counts_reads_under_vmap_grad():
    def loss(p, x):
        return (p * x).sum()

    def body():
        g = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
            torch.ones(3), torch.ones(4, 3))
        return g.sum().item()

    with HostSyncBudget(None, strict=False) as hs:
        body()
    assert hs.count == 1


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` (writes each ``-o`` target) and ``ctypes.CDLL``
    (an object with every signature's name), so that ``cuda_lib.build``
    and ``library`` run here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// stand-in source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi; shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_lib, "CSRC", csrc)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_lib, "_library", None)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", lambda path: types.SimpleNamespace(
        **{name: types.SimpleNamespace() for name in cuda_lib._SIGNATURES}))


def test_build_budget_counts_nvcc_runs_and_loads(toolchain):
    with BuildBudget(None, strict=False) as first:
        cuda_lib.library()
    with BuildBudget(budget=0, name="steady") as steady:
        cuda_lib.build()                 # the hashed library exists: no nvcc
        cuda_lib.library()               # loaded already
    assert (first.builds, first.loads, first.count) == (1, 1, 2)
    assert (steady.builds, steady.loads) == (0, 0)


def test_reset_build_counts(monkeypatch):
    monkeypatch.setattr(cuda_lib, "BUILDS", 3)
    monkeypatch.setattr(cuda_lib, "LOADS", 2)
    cuda_lib.reset_build_counts()
    assert cuda_lib.BUILDS == cuda_lib.LOADS == 0


def test_build_budget_zero_raises_and_names_the_counts(toolchain):
    with pytest.raises(BuildBudgetExceeded,
                       match=r"\[steady\]: 1 nvcc build\(s\) and 1 load"), \
            BuildBudget(budget=0, name="steady"):
        cuda_lib.library()


def test_build_budget_does_not_swallow_body_exception(toolchain):
    with pytest.raises(ValueError, match="from body"), BuildBudget(budget=0):
        cuda_lib.library()
        raise ValueError("from body")


# -------------------------------------------------------------- hot paths

def test_registers_the_reference_hot_paths():
    assert set(HOT_PATHS) == set(ref_hotpaths.HOT_PATHS)


def test_budgets_cover_every_hot_path():
    budgets = load_budgets()
    assert set(budgets) == set(HOT_PATHS)
    for name, entry in budgets.items():
        assert entry["builds"] == entry["loads"] == 0, name
        assert set(entry["reads"]) == {"fixed", "per_unit", "to_host"}, name
        assert set(entry["syncs"]) == {"fixed", "per_unit", "measured_on"}, name
        assert entry["syncs"]["measured_on"] == CARD, name
        assert entry["why"], name


@pytest.mark.parametrize("name", sorted(ref_hotpaths.HOT_PATHS))
def test_hot_path_steady_state_on_cpu(name):
    result = measure(name, "cpu")
    entry = load_budgets()[name]
    assert result["steady_builds"] == result["steady_loads"] == 0
    assert result["units"] >= 1
    assert result["steady_reads"] == form_value(entry["reads"],
                                                result["units"]), result
    assert "to_host" not in result["steady_read_kinds"]
    assert result["steady_syncs"] is None
    assert result["steady_launches"] == {}
    assert check_budget(name, result, entry) == []


def test_measure_counts_the_steady_call_alone(monkeypatch):
    """The warm-up and the ``reps`` timed calls after the steady call add
    nothing to its counts."""
    def build(dev):
        def call():
            cuda_lib.LAUNCHES["masked_aggregate"] += 1      # a stand-in launch
            return torch.ones(2, device=dev).sum().item()
        return hotpaths.HotPathRun(warmup=call, steady=call,
                                   units=lambda out: int(out))
    monkeypatch.setitem(hotpaths.HOT_PATHS, "stand_in",
                        hotpaths.HotPath("stand_in", "", "calls", build))
    monkeypatch.setitem(cuda_lib.LAUNCHES, "masked_aggregate",
                        cuda_lib.LAUNCHES["masked_aggregate"])
    result = measure("stand_in", "cpu", reps=3)
    assert result["steady_launches"] == {"masked_aggregate": 1}
    assert (result["steady_reads"], result["units"]) == (1, 2)
    assert result["steady_ms"] > 0


def test_gate_fails_a_read_site_the_budget_does_not_name():
    result = measure("solve_joint_fused", "cpu")
    entry = dict(load_budgets()["solve_joint_fused"], why="no sites")
    failures = check_budget("solve_joint_fused", result, entry)
    assert any("core/alternating.py:375" in f for f in failures)


# -------------------------------------------------------------------- CLI

def test_cli_gate_green_on_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--gate", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] is True and report["device"] == "cpu"
    assert report["passes"]["rank"]["stats"]["n_combos"] == 486
    assert set(report["passes"]["recompile"]["measured"]) == set(HOT_PATHS)
    assert "analysis gate green" in capsys.readouterr().out


def test_cli_gate_red_on_a_lowered_form(tmp_path, monkeypatch):
    budgets = load_budgets()
    lowered = dict(budgets, solve_joint_fused=dict(
        budgets["solve_joint_fused"],
        reads=dict(budgets["solve_joint_fused"]["reads"], fixed=0)))
    monkeypatch.setattr(hotpaths, "load_budgets", lambda path=None: lowered)
    out = tmp_path / "report.json"
    argv = ["--device", "cpu", "--only", "recompile", "--json", str(out)]
    assert cli.main(argv + ["--gate"]) == 1
    report = json.loads(out.read_text())
    assert report["ok"] is False
    assert any("solve_joint_fused" in f for f in
               report["passes"]["recompile"]["failures"])
    assert cli.main(argv) == 0           # report only without --gate


def test_cli_gate_red_on_an_unbudgeted_path(tmp_path, monkeypatch):
    budgets = load_budgets()
    budgets.pop("scan_engine_sweep")
    monkeypatch.setattr(hotpaths, "load_budgets", lambda path=None: budgets)
    monkeypatch.setattr(hotpaths, "measure_all", lambda device=None: {
        name: measure(name, device) for name in ("scan_engine_sweep",
                                                 "solve_joint_fused")})
    argv = ["--device", "cpu", "--only", "recompile", "--gate",
            "--json", str(tmp_path / "r.json")]
    assert cli.main(argv) == 1
    failures = json.loads((tmp_path / "r.json").read_text())[
        "passes"]["recompile"]["failures"]
    assert any("'scan_engine_sweep' has no entry" in f for f in failures)
    assert any("'fleet_service_step' is not registered" in f for f in failures)


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--only", "rank"])
