"""Analysis gate of the port, the counterpart of ``tools/run_analysis.py``.

Runs the port's two passes on one device and emits one JSON report:

* **recompile** — measure every registered hot path
  (``repro_torch.analysis.hotpaths``) and hold its steady call to the
  budgets in ``budgets.json`` beside it: no build and no load of the
  kernel library, host reads within their form, and on the card waits
  for the card within theirs; a path without an entry, or an entry
  without a path, is red too;
* **rank** — the exhaustive [N]/[N,K] broadcast sweep over
  ``WirelessFLProblem`` must be clean.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis --device cpu   # report only
    PYTHONPATH=src python -m repro_torch.analysis --gate         # on the card, exit 1 on red
    PYTHONPATH=src python -m repro_torch.analysis --json out.json --only rank

The device defaults to the card, and without one the run raises; pass
``--device cpu`` to run on the host.  The report is written to
``--json`` (default ``build/repro_torch/analysis_report.json`` at the
root of the checkout) and summarised on stdout either way.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import hotpaths
from repro_torch.device import resolve_device

PASSES = ("recompile", "rank")
DEFAULT_REPORT = (Path(__file__).resolve().parents[3] / "build"
                  / "repro_torch" / "analysis_report.json")


def run_recompile(device) -> dict:
    measured = hotpaths.measure_all(device=device)
    budgets = hotpaths.load_budgets()
    failures = []
    for name, entry in sorted(budgets.items()):
        if name not in measured:
            failures.append(f"budgeted hot path {name!r} is not registered")
            continue
        failures.extend(hotpaths.check_budget(name, measured[name], entry))
    for name in sorted(set(measured) - set(budgets)):
        failures.append(f"hot path {name!r} has no entry in "
                        f"{hotpaths.default_budgets_path().name}")
    return {"ok": not failures, "failures": failures, "measured": measured,
            "budgets": budgets}


def run_rank(device) -> dict:
    from repro_torch.analysis.rank import sweep_rank_contract

    findings, stats = sweep_rank_contract(device=device)
    return {"ok": not findings, "failures": [str(f) for f in findings],
            "stats": stats}


def _summary(name: str, result: dict) -> str:
    if name == "rank":
        s = result["stats"]
        return f"{s['n_combos']} combinations, {len(result['failures'])} finding(s)"
    return "; ".join(
        f"{p}: builds {m['steady_builds']}, loads {m['steady_loads']}, "
        f"reads {m['steady_reads']}, syncs {m['steady_syncs']}, "
        f"{m['units']} {m['unit']}" for p, m in sorted(result["measured"].items()))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when any pass is red")
    ap.add_argument("--json", type=Path, default=DEFAULT_REPORT,
                    help="report path (default build/repro_torch/"
                         "analysis_report.json)")
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of {','.join(PASSES)}")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card)")
    args = ap.parse_args(argv)

    selected = PASSES if args.only is None else tuple(
        p.strip() for p in args.only.split(","))
    unknown = set(selected) - set(PASSES)
    if unknown:
        ap.error(f"unknown pass(es): {sorted(unknown)}")
    device = resolve_device(args.device)

    runners = {"recompile": run_recompile, "rank": run_rank}
    report: dict = {"device": str(device), "passes": {}}
    red = []
    for name in selected:
        print(f"== {name} ==", flush=True)
        result = runners[name](device)
        report["passes"][name] = result
        status = "ok" if result["ok"] else "RED"
        print(f"   {status}: {_summary(name, result)}" + (
            "" if result["ok"] else
            "".join(f"\n   - {f}" for f in result["failures"])), flush=True)
        if not result["ok"]:
            red.append(name)
    report["ok"] = not red

    args.json.parent.mkdir(parents=True, exist_ok=True)
    args.json.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    print(f"report -> {args.json}")

    if red:
        print(f"analysis gate RED: {', '.join(red)}")
        return 1 if args.gate else 0
    print("analysis gate green")
    return 0


if __name__ == "__main__":
    sys.exit(main())
