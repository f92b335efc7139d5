"""Quickstart: solve the paper's joint selection/power problem and run a
short federated training with it.

The port's counterpart of ``examples/quickstart.py``, at its sizes by
default; the flags set the sizes and the device.

    PYTHONPATH=src python -m repro_torch.quickstart
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu --devices 16 --rounds 4
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (ProbabilisticScheduler, sample_problem,
                              solve_joint_optimal, solve_joint_trace)
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.device import resolve_device
from repro_torch.fl.engine import FLConfig, run_fl
from repro_torch.fleet_scale import device_name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=100, help="fleet size")
    ap.add_argument("--rounds", type=int, default=100, help="FL rounds")
    ap.add_argument("--train", type=int, default=4000, help="training-set size")
    ap.add_argument("--test", type=int, default=800, help="test-set size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. the wireless scenario (paper Sec. V-A) -----------------------
    problem = sample_problem(0, n_devices=args.devices, tau_th=0.08,
                             device=dev)

    # --- 2. Algorithm 2: alternating closed-form solve -------------------
    sol, trace = solve_joint_trace(problem)
    print("Algorithm 2 objective trace:", [f"{t:.5f}" for t in trace])
    print(f"expected participants/round: {float(sol.a.sum()):.2f}")

    # --- 3. beyond-paper: exact bisection optimum -------------------------
    opt = solve_joint_optimal(problem)
    gain = float(opt.objective) / max(float(sol.objective), 1e-12) - 1
    print(f"global-optimal solver objective: +{gain:.1%} vs Algorithm 2")

    # --- 4. short FL run with probabilistic participation ------------------
    train, test = make_mnist_like(args.train, args.test, seed=0)
    parts = dirichlet_partition(train, args.devices, beta=0.3, seed=1)
    problem = sample_problem(
        2, args.devices, tau_th=0.5,
        dirichlet_sizes=np.array([len(p) for p in parts]), device=dev)
    cfg = FLConfig(n_rounds=args.rounds, eval_every=25, lr=0.1,
                   batch_per_client=8)
    res = run_fl(problem, ProbabilisticScheduler(), train, parts, test, cfg,
                 device=dev)
    h = res.history
    print(f"FL: acc={h.eval_acc[-1]:.3f} after {h.sim_time[-1]:.0f}s "
          f"simulated, {h.energy[-1]:.0f} J consumed, "
          f"{h.participants.mean():.1f} participants/round "
          f"[{device_name(dev)}]")
    return dict(trace=trace, optimal_gain=gain, history=h)


if __name__ == "__main__":
    main()
