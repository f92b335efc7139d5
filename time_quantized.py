"""Time the quantised sweep and its eq.-4 sums on one GPU.

    python time_quantized.py [--rounds K] [--reps R]

The sweep is what ``chip_smoke.py`` [5] drives: both paper scenarios x
three uplink schemes x three seeds (18 trajectories, N = 100, the paper's
CNN), every round's server sum through ``quantized_masked_aggregate``.
After a short warm-up sweep, each repetition times, with the device
synchronised at every mark:

* ``plan_s``: ``chip_smoke.quantized_plans`` (data, solves, plans);
* ``sweep_s``: ``run_fl_sweep`` over the stacked plans, with the
  operands of its round ``--round`` kept (the noise its generators
  would draw is drawn first and passed in, so the sweep computes what it
  does alone);

and then, by CUDA events over 20 repetitions, on three sets of operands
(8 leaves each): that round (``sweep``), the same round with every
coefficient made nonzero (``dense``, the sum's worst case), and the
faulted closed loop's round-10 operands at T = 1 (``closed_loop``, the
grid ``chip_smoke.py`` [10] runs, without its crash):

* ``scale_ms``: the scale pass the wrapper runs (``row_scale_batched``
  where the checkout has it, else ``row_scale``);
* ``scale_library_ms``: the same scales from PyTorch's library
  (``torch.linalg.vector_norm(ord=inf)``, the clamp, the division);
* ``sum_ms``: ``quantized_masked_aggregate_batched``, given the scales;
* ``wrapper_ms``: ``quantized_masked_aggregate`` leaf by leaf, what the
  sweep calls;

and each again as device time (``*_dev_ms``, ``chip_smoke.queued_ms``:
the calls queued behind a spin kernel, so they run back to back), which
leaves out the host's gaps between the 8 launches.

It prints one JSON object per repetition.  It imports ``chip_smoke.py``
from its own directory and, of the port, only functions that it had
before the scale kernel: copied with ``chip_smoke.py`` into the root of
an older checkout, it times that checkout on the same card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per trajectory (default: the scenarios' 400)")
    ap.add_argument("--round", type=int, default=10,
                    help="the sweep round whose operands are timed")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--label", default="", help="tag for the printed lines")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_quantized: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as C
    from repro_torch.device import resolve_device
    from repro_torch.fl import closed_loop as cl
    from repro_torch.fl import scan_engine
    from repro_torch.fl.scan_engine import (init_sweep_params, run_fl_sweep,
                                            stack_plans)
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.masked_aggregate import ops, ref
    from repro_torch.serve import FaultPlan
    from repro_torch.tree import tree_leaves

    dev = resolve_device(None)
    cuda_lib.build()
    cuda_lib.library()
    scale_fn = getattr(ops, "row_scale_batched", ops.row_scale)

    def mark(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def sweep(rounds, every, record, k):
        t0 = time.perf_counter()
        plans, _, cfgs, trains, tests, _ = C.quantized_plans(torch, dev, rounds,
                                                              every)
        plan_s = mark(t0)
        stacked, params0 = stack_plans(plans), init_sweep_params(cfgs, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with C.wrapped(scan_engine, "quantized_aggregate_pytree",
                       C.captured_operands(record, k)):
            run_fl_sweep(stacked, trains, tests, cfgs[0], params0, device=dev)
        return plan_s, mark(t0)

    def timed(operands):
        gstack, coef, bits, noise = operands
        t, n = coef.shape
        coef = coef.contiguous()
        bits = torch.as_tensor(bits, dtype=torch.float32, device=dev)
        levels = ref.quantizer_levels(bits).expand(t, n).contiguous()
        gs = [g.reshape(t, n, -1).contiguous() for g in tree_leaves(gstack)]
        us = [u.reshape(t, n, -1).contiguous() for u in tree_leaves(noise)]
        scales = [scale_fn(g, levels) for g in gs]
        fns = dict(
            scale=lambda: [scale_fn(g, levels) for g in gs],
            scale_library=lambda: [torch.clamp(torch.linalg.vector_norm(
                g, ord=math.inf, dim=-1), min=1e-12) / levels for g in gs],
            sum=lambda: [
                ops.quantized_masked_aggregate_batched(g, coef, u, s, levels)
                for g, u, s in zip(gs, us, scales)],
            wrapper=lambda: [
                ops.quantized_masked_aggregate(g, coef, u, bits)
                for g, u in zip(tree_leaves(gstack), tree_leaves(noise))])
        row = dict(t=t, n=n, live=int((coef != 0).sum()))
        for name, fn in fns.items():
            row[f"{name}_ms"] = C.cuda_ms(torch, fn, 20)
            row[f"{name}_dev_ms"] = C.queued_ms(torch, fn, 10)
        return row

    sweep(3, 3, {}, 0)                                        # warm-up
    fcfg = cl.ClosedLoopConfig(**C.CLOSED_LOOP, n_seeds=C.CLOSED_LOOP_SEEDS,
                               fault_plan=FaultPlan(**C.CLOSED_LOOP_FAULTS))
    for rep in range(args.reps):
        record: dict = {}
        plan_s, sweep_s = sweep(args.rounds, None, record, args.round)
        row = dict(label=args.label, rep=rep, plan_s=plan_s, sweep_s=sweep_s,
                   sweep=timed(record["operands"]))
        gstack, coef, bits, noise = record.pop("operands")
        dense = torch.rand(coef.shape, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(rep))
        row["dense"] = timed((gstack, dense + 1e-3, bits, noise))
        del gstack, noise
        loop: dict = {}
        C.closed_loop_grid(torch, dev, fcfg, loop,
                           operands_round=C.CLOSED_LOOP_OPERANDS_ROUND)
        row["closed_loop"] = timed(loop["operands"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
