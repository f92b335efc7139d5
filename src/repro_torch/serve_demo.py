"""Serving demo: the online fleet control plane on a drifting channel.

The port's counterpart of ``examples/serve_demo.py``, with its flags and
defaults.  Streams per-cell solve requests for a metro area through
``repro_torch.serve.FleetControlService`` (micro-batched, padded to
fixed slot shapes, warm-started from each cell's cached previous
solution) and prints steady-state throughput, latency percentiles and
the warm-start iteration drop against a cold-started service.

``--open-loop`` switches to the arrival-driven mode: warm every device
bucket, measure full-batch capacity, then drive a seeded Poisson trace
at ``--load`` times it, with per-request deadlines, and print sustained
throughput, latency percentiles, deadline misses and preemptions.

    PYTHONPATH=src python -m repro_torch.serve_demo
    PYTHONPATH=src python -m repro_torch.serve_demo --open-loop --load 0.7
    PYTHONPATH=src python -m repro_torch.serve_demo --device cpu --cells 2 --rounds 3
"""
from __future__ import annotations

import argparse

from repro_torch.core.scenarios import make_problem, slice_round
from repro_torch.device import resolve_device
from repro_torch.fleet_scale import device_name
from repro_torch.serve import (
    FleetControlService,
    ServiceConfig,
    drive,
    measure_capacity,
    poisson_trace,
)


def stream_rounds(service, cells, n_rounds, skip_stats_rounds=2):
    """Push every cell's per-round request through the service, round by
    round.  The stats restart after the first ``skip_stats_rounds``
    rounds (round 0 cold, round 1 the first warm one; the caches keep
    their state), or before the last round of a shorter run."""
    skip = min(skip_stats_rounds, n_rounds - 1)
    for k in range(n_rounds):
        for cell_id, prob in enumerate(cells):
            service.submit(cell_id, slice_round(prob, k))
        service.run()
        if k + 1 == skip:
            service.stats.reset()
    return service.stats


def closed_loop(cells, args, dev) -> dict:
    """Warm and cold services over the same stream: ``{label: summary}``."""
    results = {}
    for label, warm in (("warm", True), ("cold", False)):
        svc = FleetControlService(ServiceConfig(
            max_batch=args.max_batch, power_solver=args.power_solver,
            warm_start=warm), device=dev)
        s = stream_rounds(svc, cells, args.rounds).summary()
        results[label] = s
        print(f"[{label:4s}] {s['solves_per_sec']:8.1f} solves/s   "
              f"p50 {s['p50_latency_s'] * 1e3:7.2f} ms   "
              f"p99 {s['p99_latency_s'] * 1e3:7.2f} ms   "
              f"warm {s['warm_fraction']:.0%}   "
              f"inner iters/batch {s['mean_inner_iters']:.1f}   "
              f"[{device_name(dev)}]", flush=True)
    if args.power_solver == "dinkelbach":
        ratio = (results["cold"]["mean_inner_iters"]
                 / max(results["warm"]["mean_inner_iters"], 1e-9))
        print(f"warm start cuts Algorithm-1 iterations {ratio:.1f}x on "
              "this channel")
    return results


def open_loop(cells, args, dev) -> dict:
    """Warmup, measured capacity, then a seeded Poisson trace at
    ``--load`` times capacity with deadlines of 8 measured batch costs.
    Returns the steady-state summary plus ``capacity``, ``deadline_s``,
    ``offered_rate_hz`` and ``sustained_rate_hz``."""
    svc = FleetControlService(ServiceConfig(
        max_batch=args.max_batch, power_solver=args.power_solver),
        device=dev)
    probe = [slice_round(c, 0) for c in cells]
    wtimes = svc.warmup(probe[0], max_devices=args.devices)
    print(f"warmup: buckets {sorted(wtimes)} in "
          f"{sum(wtimes.values()):.2f} s [{device_name(dev)}]")
    cap = measure_capacity(svc, probe)
    svc.stats.reset()
    print(f"measured capacity: {cap:.1f} solves/s "
          f"(full {args.max_batch}-slot batches) [{device_name(dev)}]")

    deadline = 8.0 * args.max_batch / cap
    trace = poisson_trace(cells, rate_hz=args.load * cap,
                          n_requests=args.requests, seed=args.seed,
                          deadline_s=deadline)
    rep = drive(svc, trace, reset_stats_after=args.requests // 4)
    s = svc.stats.summary()
    print(f"open loop @ {args.load:.0%} capacity "
          f"({rep.offered_rate_hz:.1f} req/s offered, deadline "
          f"{deadline * 1e3:.1f} ms) [{device_name(dev)}]:")
    print(f"  sustained {rep.sustained_rate_hz:8.1f} solves/s   "
          f"p50 {s['p50_latency_s'] * 1e3:7.2f} ms   "
          f"p99 {s['p99_latency_s'] * 1e3:7.2f} ms")
    print(f"  deadline misses {s['deadline_miss_rate']:.1%}   "
          f"warm {s['warm_fraction']:.0%}   "
          f"preemptions {s['preemptions']}   closes {s['closes']}")
    return dict(s, capacity=cap, deadline_s=deadline,
                offered_rate_hz=rep.offered_rate_hz,
                sustained_rate_hz=rep.sustained_rate_hz)


def make_stream(args) -> list:
    """The demo's metro: ``--cells`` drifting_metro cells.  They live on
    the host, where a cell's report arrives; the service solves on its
    own device."""
    return [make_problem("drifting_metro", seed=s, n_devices=args.devices,
                         n_rounds=args.rounds, coherence=args.coherence,
                         device="cpu")
            for s in range(args.cells)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=8,
                    help="base-station cells submitting requests")
    ap.add_argument("--rounds", type=int, default=8,
                    help="FL rounds (requests per cell)")
    ap.add_argument("--devices", type=int, default=64,
                    help="devices per cell")
    ap.add_argument("--coherence", type=float, default=0.9,
                    help="Gauss-Markov channel coherence in [0, 1)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch instance slots")
    ap.add_argument("--power-solver", default="dinkelbach",
                    choices=["dinkelbach", "analytic"],
                    help="dinkelbach (Algorithm 1, shows the warm-start "
                         "iteration drop) or the closed-form analytic path")
    ap.add_argument("--open-loop", action="store_true",
                    help="arrival-driven mode: warmup + seeded Poisson "
                         "trace with deadlines")
    ap.add_argument("--load", type=float, default=0.7,
                    help="open-loop offered rate as a fraction of the "
                         "measured capacity")
    ap.add_argument("--requests", type=int, default=120,
                    help="open-loop trace length")
    ap.add_argument("--seed", type=int, default=1,
                    help="open-loop arrival trace seed")
    ap.add_argument("--device", default=None,
                    help="torch device the service solves on (default: "
                         "the card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cells = make_stream(args)
    print(f"fleet control plane: {args.cells} cells x {args.devices} "
          f"devices, {args.rounds} rounds, coherence {args.coherence} "
          f"[{device_name(dev)}]")
    if args.open_loop:
        return open_loop(cells, args, dev)
    return closed_loop(cells, args, dev)


if __name__ == "__main__":
    main()
