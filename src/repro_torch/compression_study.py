"""Beyond-paper study: quantised uplink x joint selection/power.

The paper treats the gradient payload S as fixed (fp32).  Compressing the
uplink to b bits shrinks S by 32/b, which relaxes the time constraint
(7c): the solver returns higher selection probabilities and more
expected participants per round, at the price of quantisation noise.
Each width trains with ``run_fl``'s stacked path, whose server sum is
the ``masked_aggregate`` kernel at 32 bits and the
``quantized_masked_aggregate`` kernel at 8 and 4 on the card.

The port's counterpart of ``examples/compression_study.py``, at its
sizes by default; the flags set the sizes, the output and the device.

    PYTHONPATH=src python -m repro_torch.compression_study
    PYTHONPATH=src python -m repro_torch.compression_study --device cpu \\
        --devices 8 --rounds 3 --train 240 --test 60 --out /tmp/study.json
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.core import (GRAD_SIZE_BITS_FP32, ProbabilisticScheduler,
                              sample_problem)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl.engine import FLConfig, run_fl
from repro_torch.fleet_scale import device_name

BITS = (32, 8, 4)
# the fp32 payload every sampled problem carries (core.problem's default)
BASE_S = GRAD_SIZE_BITS_FP32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=100, help="fleet size")
    ap.add_argument("--rounds", type=int, default=150, help="FL rounds")
    ap.add_argument("--eval-every", type=int, default=30,
                    help="rounds between evaluations")
    ap.add_argument("--train", type=int, default=6000, help="training-set size")
    ap.add_argument("--test", type=int, default=1000, help="test-set size")
    ap.add_argument("--out", default="experiments/compression_study.json",
                    help="where the results are written as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    train, test = make_mnist_like(args.train, args.test, seed=0)
    parts = dirichlet_partition(train, args.devices, beta=0.3, seed=1)
    sizes = np.array([len(p) for p in parts])

    results = {}
    for bits in BITS:
        prob = sample_problem(2, args.devices, tau_th=0.08,
                              grad_size_bits=BASE_S * bits / 32,
                              dirichlet_sizes=sizes, device=dev)
        sch = ProbabilisticScheduler(solver="optimal")
        state = sch.precompute(prob)
        exp_parts = float(state.a.sum())
        cfg = FLConfig(n_rounds=args.rounds, eval_every=args.eval_every,
                       batch_per_client=8, lr=0.1, aggregate="stacked",
                       uplink_bits=None if bits == 32 else bits, seed=3)
        res = run_fl(prob, sch, train, parts, test, cfg, device=dev)
        h = res.history
        results[bits] = {
            "expected_participants": exp_parts,
            "objective": float(state.a @ prob.weights),
            "final_acc": float(h.eval_acc[-1]),
            "time_to_final": float(h.sim_time[-1]),
            "energy": float(h.energy[-1]),
            "acc_curve": h.eval_acc.tolist(),
            "time_curve": h.eval_time.tolist(),
        }
        print(f"bits={bits:2d}: E[parts]={exp_parts:6.2f} "
              f"final_acc={h.eval_acc[-1]:.3f} "
              f"sim_time={h.sim_time[-1]:8.0f}s energy={h.energy[-1]:7.0f}J "
              f"[{device_name(dev)}]", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"\nwritten to {out}")
    return results


if __name__ == "__main__":
    main()
