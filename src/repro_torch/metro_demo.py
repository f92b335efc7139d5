"""Metro demo: one coupled multi-cell control tick (``core.multicell``).

The port's counterpart of ``examples/metro_demo.py``, with its flags and
defaults.  Builds a 16-cell ``metro_coupled`` metro (per-cell paper
problems on a square grid, inter-cell interference, one shared backhaul
link) and solves a coupled tick through ``FleetControlService``: the
dual-decomposition outer loop, one fused union solve per iteration.
Prints per-cell expected participation coupled against uncoupled, the
backhaul price and load, and the warm-dual effect of a second tick.

    PYTHONPATH=src python -m repro_torch.metro_demo
    PYTHONPATH=src python -m repro_torch.metro_demo --cells 8 --devices 32 --no-budget
    PYTHONPATH=src python -m repro_torch.metro_demo --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.batch import solve_joint_batch
from repro_torch.core.scenarios import make_problem
from repro_torch.device import resolve_device
from repro_torch.fleet_scale import device_name
from repro_torch.serve import FleetControlService, ServiceConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=16, help="cells in the metro")
    ap.add_argument("--devices", type=int, default=64,
                    help="devices per cell")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-budget", action="store_true",
                    help="drop the shared backhaul budget "
                         "(interference coupling only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kw = {"backhaul_fraction": None} if args.no_budget else {}
    metro = make_problem("metro_coupled", seed=args.seed, n_cells=args.cells,
                         n_devices=args.devices, device=dev, **kw)
    uncoupled = solve_joint_batch(metro.cells, method="fused")

    svc = FleetControlService(ServiceConfig(), device=dev)
    tick = svc.solve_coupled("metro-demo", metro)
    sol = tick.solution

    print(f"metro_coupled: C={args.cells} cells x N={args.devices} devices, "
          f"seed={args.seed} [{device_name(dev)}]")
    print(f"outer loop: {sol.outer_iters} iterations, "
          f"residual={sol.residual:.2e}, converged={sol.converged}")
    if metro.backhaul_bits is not None:
        load = float(np.max(np.atleast_1d(sol.backhaul_load)))
        mu = float(np.max(np.atleast_1d(sol.mu)))
        print(f"backhaul: load/budget={load / metro.backhaul_bits:.4f}, "
              f"price mu={mu:.3e}")
    else:
        print("backhaul: no shared budget (interference coupling only)")

    a_c = sol.batch.a.cpu().numpy()[:args.cells, :args.devices]
    a_u = uncoupled.a.cpu().numpy()
    print(f"\n{'cell':>4} {'uncoupled':>10} {'coupled':>10} {'delta':>8}   "
          f"interference (W)")
    for c in range(args.cells):
        i_c = float(np.max(np.atleast_1d(sol.interference[c])))
        print(f"{c:>4} {a_u[c].sum():>10.3f} {a_c[c].sum():>10.3f} "
              f"{a_c[c].sum() - a_u[c].sum():>8.3f}   {i_c:.3e}")
    print(f"{'sum':>4} {a_u.sum():>10.3f} {a_c.sum():>10.3f} "
          f"{a_c.sum() - a_u.sum():>8.3f}")

    tick2 = svc.solve_coupled("metro-demo", metro)
    print(f"\nwarm tick: {tick2.solution.outer_iters} outer iteration(s) "
          f"(cold: {sol.outer_iters}), "
          f"warm_started={tick2.warm_started}, "
          f"latency {tick2.latency_s * 1e3:.1f} ms "
          f"(cold: {tick.latency_s * 1e3:.1f} ms) [{device_name(dev)}]")
    return tick, tick2


if __name__ == "__main__":
    main()
