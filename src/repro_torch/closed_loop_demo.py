"""Closed-loop demo: the drift-aware online control plane driving FL
training.

The port's counterpart of ``examples/closed_loop_demo.py``, with its
flags and defaults.  Runs the full loop of ``repro_torch.fl.closed_loop``
on a Gauss-Markov drifting metro cell: every round's selection
probabilities and powers come from a warm-started
``FleetControlService`` solve on that round's channel, the strategy suite
(proposed probabilistic, per-round deterministic top-k, uniform,
channel-aware greedy, Lyapunov virtual queues, joint bits) turns the
solutions into per-round plans, and the sweep engine trains and accounts
every strategy.  Prints the paper-style (Sec. V) comparison table.

    PYTHONPATH=src python -m repro_torch.closed_loop_demo
    PYTHONPATH=src python -m repro_torch.closed_loop_demo \\
        --devices 32 --rounds 12 --coherence 0.95 --seeds 2
    PYTHONPATH=src python -m repro_torch.closed_loop_demo --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.fl.closed_loop import (
    CLOSED_LOOP_STRATEGIES,
    ClosedLoopConfig,
    format_closed_loop_table,
    run_closed_loop_grid,
)
from repro_torch.fleet_scale import device_name
from repro_torch.serve import FleetControlService, ServiceConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=24,
                    help="devices in the drifting cell")
    ap.add_argument("--rounds", type=int, default=8, help="FL rounds")
    ap.add_argument("--coherence", type=float, default=0.9,
                    help="Gauss-Markov channel coherence in [0, 1)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="FL seeds per strategy (shared control plane)")
    ap.add_argument("--train", type=int, default=1024,
                    help="training-set size")
    ap.add_argument("--power-solver", default=None,
                    choices=["dinkelbach", "analytic"],
                    help="service inner power solver (dinkelbach shows "
                         "the warm-start iteration drop)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ClosedLoopConfig(n_devices=args.devices, n_rounds=args.rounds,
                           coherence=args.coherence, n_seeds=args.seeds,
                           n_train=args.train, n_test=max(args.train // 4, 64),
                           eval_every=max(args.rounds // 2, 1))
    service = None
    if args.power_solver:
        service = FleetControlService(ServiceConfig(
            method="alternating" if args.power_solver == "dinkelbach"
            else "fused", power_solver=args.power_solver), device=dev)
    out = run_closed_loop_grid(cfg, CLOSED_LOOP_STRATEGIES, service=service,
                               device=dev)
    print(format_closed_loop_table(out))
    svc = out["control"]["service"]
    print(f"control plane: warm_fraction={svc['warm_fraction']:.2f} "
          f"p50={svc['p50_latency_s'] * 1e3:.1f} ms "
          f"p99={svc['p99_latency_s'] * 1e3:.1f} ms "
          f"mean_inner_iters={svc['mean_inner_iters']:.1f} "
          f"[{device_name(dev)}]")

    prop = out["strategies"]["probabilistic"]
    uni = out["strategies"]["uniform"]
    print(f"proposed vs uniform: energy {prop['total_energy_j']:.2f} J "
          f"vs {uni['total_energy_j']:.2f} J "
          f"({uni['total_energy_j'] / max(prop['total_energy_j'], 1e-9):.1f}x)")
    return out


if __name__ == "__main__":
    main()
