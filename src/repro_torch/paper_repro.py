"""End-to-end reproduction on the card: the paper's two scenarios,
four selection strategies, accuracy-vs-time curves and Tables I-IV
analogues.

The port's counterpart of ``examples/paper_repro.py``, with its flags:

    PYTHONPATH=src python -m repro_torch.paper_repro                 # full
    PYTHONPATH=src python -m repro_torch.paper_repro --fast          # reduced
    PYTHONPATH=src python -m repro_torch.paper_repro --engine scan   # one sweep

``--engine loop`` (the default) runs the trajectories one by one
(``fl.engine.run_fl``); ``--engine scan`` advances every trajectory of
the (seed x strategy x scenario) grid together (``fl.scan_engine``).
Each scenario's result is written as JSON under ``--out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.fl.experiments import HIGH_BIAS, MILD_BIAS, format_tables, run_grid


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--engine", choices=("loop", "scan"), default="loop",
                    help="'loop' = one run at a time; 'scan' = every "
                         "trajectory advanced together")
    ap.add_argument("--out", default="experiments/paper_repro")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scenarios = [HIGH_BIAS, MILD_BIAS]
    if args.fast:
        scenarios = [dataclasses.replace(
            s, n_rounds=120, n_runs=1, n_train=4000, n_test=800,
            n_devices=50) for s in scenarios]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = run_grid(scenarios, engine=args.engine, device=dev)
    for spec in scenarios:
        print(f"\n### scenario: {spec.name} (beta={spec.beta}, "
              f"tau={spec.tau_th}s, engine={args.engine}) ###")
        result = results[spec.name]
        (out_dir / f"{spec.name}.json").write_text(json.dumps(result, indent=1))
        print(format_tables(result, spec))


if __name__ == "__main__":
    main()
