"""Time the paper grid on one GPU, with its planning timed apart from its
sweep.

    PYTHONPATH=src python -m repro_torch.time_grid [--rounds K] [--reps R]

The grid is what ``chip_smoke.py`` [4] drives: ``run_grid`` over both
paper scenarios and all four strategies (16 trajectories) with the
fused-kernel solve.  After a short warm-up grid, each repetition times,
with the device synchronised at every mark:

* ``data_s``: ``make_problem_and_data`` for both scenarios;
* ``plan_s``: ``build_scenario_plans`` for both scenarios (the data
  again, one solve per strategy, ``plan_trajectory`` per trajectory);
* ``stack_s``: ``stack_plans`` and ``init_sweep_params``;
* ``sweep_s``: ``run_fl_sweep`` over the stacked plans;
* ``grid_s``: ``run_grid`` end to end, as ``chip_smoke.py`` [4] times it.

It prints one JSON object per repetition; ``--profile N`` then prints
the N functions of one more planning pass that took the most host time
of their own (``cProfile``).  It uses only functions that
the port's first slice already had, so the same file, copied into an
older checkout, times that checkout on the same card.
"""
from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import pstats
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per trajectory (default: the scenarios' 400)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--label", default="", help="tag for the printed lines")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="print the N costliest functions of one planning pass")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_grid: no CUDA device")
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.fl import experiments as ex
    from repro_torch.fl.scan_engine import (init_sweep_params, run_fl_sweep,
                                            stack_plans)
    from repro_torch.kernels import cuda_lib

    dev = resolve_device(None)
    cuda_lib.build()
    cuda_lib.library()

    def specs(rounds, eval_every=None):
        out = [dataclasses.replace(s, solver="fused_kernel")
               for s in (ex.HIGH_BIAS, ex.MILD_BIAS)]
        if rounds is not None:
            out = [dataclasses.replace(s, n_rounds=rounds) for s in out]
        if eval_every is not None:
            out = [dataclasses.replace(s, eval_every=eval_every) for s in out]
        return out

    def mark(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def plan(full):
        plans, cfgs, trains, tests = [], [], [], []
        for i, spec in enumerate(full):
            p, _, c, train, test = ex.build_scenario_plans(
                spec, dataset_id=i, device=dev)
            plans, cfgs = plans + p, cfgs + c
            trains.append(train)
            tests.append(test)
        torch.cuda.synchronize()
        return plans, cfgs, trains, tests

    ex.run_grid(specs(5, 5), verbose=False, device=dev)     # warm-up
    full = specs(args.rounds)
    for rep in range(args.reps):
        t0 = time.perf_counter()
        for spec in full:
            ex.make_problem_and_data(spec, 0, dev)
        data_s = mark(t0)
        t0 = time.perf_counter()
        plans, cfgs, trains, tests = plan(full)
        plan_s = mark(t0)
        t0 = time.perf_counter()
        stacked, params0 = stack_plans(plans), init_sweep_params(cfgs, device=dev)
        stack_s = mark(t0)
        t0 = time.perf_counter()
        run_fl_sweep(stacked, trains, tests, cfgs[0], params0, device=dev)
        sweep_s = mark(t0)
        del plans, stacked, params0
        t0 = time.perf_counter()
        ex.run_grid(full, verbose=False, device=dev)
        grid_s = mark(t0)
        print(json.dumps(dict(label=args.label, rep=rep, trajectories=len(cfgs),
                              rounds=full[0].n_rounds, data_s=data_s,
                              plan_s=plan_s, stack_s=stack_s, sweep_s=sweep_s,
                              grid_s=grid_s)), flush=True)
    if args.profile:
        prof = cProfile.Profile()
        prof.runcall(plan, full)
        pstats.Stats(prof).sort_stats("tottime").print_stats(args.profile)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
