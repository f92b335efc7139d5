#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--rounds K] [--eval-every E]

By default both main paths run the paper scenarios' own depth (400
rounds, evaluated every 10); the flags set both.

Phases, each of which fails the run (non-zero exit, no result line):

1. build the port's CUDA kernels from ``src/repro_torch/csrc`` and print
   the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   slices' shapes and at ragged ones, within the stated tolerance;
3. time each kernel with CUDA events beside its bound, its plain version
   and (for the plain aggregate) one PyTorch library call, and profile a
   few rounds of each sweep;
4. drive the first slice: ``run_grid`` over both paper scenarios and all
   four strategies at N = 100 devices with the 199,213-parameter CNN, the
   fused-kernel solve and the kernel aggregate, plus one exact
   (``solve_joint_kernel``) solve per scenario; every kernel must launch,
   and the outputs are checked against the port's plain paths;
5. drive the quantised-uplink slice: one sweep of 18 trajectories (both
   scenarios x three uplink schemes x three seeds: the joint bit
   allocation over (8, 16, 32), a fixed 8-bit and a fixed 4-bit uplink)
   whose every round's server sum is the quantised kernel, and hold the
   loop engine against the sweep at 8 bits on the card;
6. print the kernel record, the card, and the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero without a CUDA device and
when run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): device memory and float32
# outside the tensor cores, the type every kernel here computes in
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per element, counting each float32 arithmetic operation,
# comparison, select and transcendental call as one (csrc/solve_common.cuh):
# fused: init 18, then 50 steps of 38; selection: 61 feasibility tests of
# 13, 60 bisection updates of 4, and 9 for P*
FUSED_OPS = 18 + 50 * 38
SELECTION_OPS = 61 * 13 + 60 * 4 + 9
# quantised sum per element: a true division, floor, subtraction,
# comparison, select, addition, max, min, two multiplies and an addition
QUANT_OPS = 11
SOLVE_TOL = 1e-5        # a* and P*: the reference's solver tolerance
AGG_TOL = 1e-5          # eq.-4 sum of O(1) values, same order of addition
QUANT_TOL = 0.0         # the quantised sum: same arithmetic, same order
# the CNN's parameter leaves (conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b)
CNN_LEAVES = (72, 8, 1152, 16, 195216, 249, 2490, 10)
# the quantised slice: the joint bit allocation's menu, and the schemes
# (None: the menu's per-device widths; b: a fixed b-bit uplink)
BIT_MENU = (8, 16, 32)
QUANT_SCHEMES = (("joint_bits", None), ("fixed_8", 8), ("fixed_4", 4))
GRID_KERNELS = ("fused_solve", "selection_solve", "masked_aggregate")
# a width that is not whole, as 32 sbits / S can give
NOT_WHOLE = 7.9999995
# loop against sweep under stochastic rounding: float-rounding differences
# in the gradients may put an element one level apart, so all but this
# share of the parameters agree at SOLVE_TOL, and each within one level
# per round (lr * max coef * max|g| / L, with |g| under 10 for the CNN)
FLIP_SHARE = 1e-3
GRAD_BOUND = 10.0


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases

def solver_elements(torch, n, tau, seed, dev):
    """One problem's flat element operands (pg, bw, emax, ec)."""
    from repro_torch.core.problem import sample_problem
    p = sample_problem(seed, n, tau_th=tau, device=dev)
    return [x.contiguous() for x in (p.path_gain(), p.bandwidth_hz,
                                     p.energy_budget_j, p.compute_energy())], p


def check_solvers(torch, dev) -> dict:
    """Both solve kernels against their plain versions; returns the
    largest errors and the problems used."""
    from repro_torch.kernels.selection_solve import ops, ref
    errs = {"fused_solve": 0.0, "selection_solve": 0.0}
    cases = [(100, 0.08, 2, False), (100, 0.5, 3, False), (1000, 0.3, 4, False),
             (4099, 0.08, 5, False), (4099, 0.5, 6, True),
             (1_000_000, 0.2, 7, False)]
    for n, tau, seed, typo in cases:
        els, p = solver_elements(torch, n, tau, seed, dev)
        kw = dict(s_bits=p.grad_size_bits, tau=p.tau_th, p_max=p.p_max)
        pairs = [("fused_solve",
                  ops.fused_solve(*els, **kw, faithful_eq13_typo=typo),
                  ref.fused_solve_ref(*els, **kw, faithful_eq13_typo=typo))]
        if not typo:
            pairs.append(("selection_solve", ops.selection_solve(*els, **kw),
                          ref.selection_solve_ref(*els, **kw)))
        torch.cuda.synchronize()
        for name, (a, pw), (a_r, p_r) in pairs:
            check(bool(torch.isfinite(a).all() and torch.isfinite(pw).all()),
                  f"{name} E={n}: non-finite output")
            err = max(float((a - a_r).abs().max()), float((pw - p_r).abs().max()))
            print(f"  {name:16s} E={n:>9,d} tau={tau} typo={typo}: "
                  f"max|kernel - plain| = {err:.3e} (tol {SOLVE_TOL:g})")
            check(err <= SOLVE_TOL, f"{name} E={n}: error {err} > {SOLVE_TOL}")
            errs[name] = max(errs[name], err)
    return errs


def check_aggregate(torch, dev) -> float:
    from repro_torch.kernels.masked_aggregate import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for d in CNN_LEAVES + (33, 1000):
        g = torch.randn(16, 100, d, device=dev, generator=gen)
        coef = torch.rand(16, 100, device=dev, generator=gen)
        coef = coef * (coef > 0.8) / 20.0
        out = ops.masked_aggregate_batched(g, coef)
        torch.cuda.synchronize()
        err = float((out - ref.masked_aggregate_ref(g, coef)).abs().max())
        print(f"  masked_aggregate T=16 N=100 D={d:>7,d}: "
              f"max|kernel - plain| = {err:.3e} (tol {AGG_TOL:g})")
        check(err <= AGG_TOL, f"masked_aggregate D={d}: error {err} > {AGG_TOL}")
        worst = max(worst, err)
    return worst


def check_quantized(torch, dev) -> float:
    """The quantised sum against its plain version, bit for bit: T in
    {1, 18}, N in {1, 100}, every CNN leaf size and two ragged ones, at
    widths 1 (ternary), 4, 8, 32, one that is not whole and a per-client
    mix, with an all-zero client row and noise at 0 and just below 1."""
    from repro_torch.kernels.masked_aggregate import ops, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    below_one = float(torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)))
    worst = 0.0
    for t in (1, 18):
        for n in (1, 100):
            mix = torch.tensor([1.0, 4.0, 8.0, 16.0, 32.0, NOT_WHOLE],
                               device=dev)[torch.randint(
                                   0, 6, (t, n), device=dev, generator=gen)]
            widths = [torch.full((t, n), b, device=dev)
                      for b in (1.0, 4.0, 8.0, 32.0, NOT_WHOLE)] + [mix]
            for d in (33, 1000) + CNN_LEAVES:
                g = torch.randn(t, n, d, device=dev, generator=gen)
                if n > 1:
                    g[:, n // 2] = 0.0          # an all-zero client row
                u = torch.rand(t, n, d, device=dev, generator=gen)
                u[..., ::7] = 0.0
                u[..., 3::7] = below_one
                coef = torch.rand(t, n, device=dev, generator=gen)
                coef = coef * (coef > 0.3) / n
                errs = []
                for bits in widths:
                    levels = ref.quantizer_levels(bits)
                    scale = ops.row_scale(g, levels)
                    out = ops.quantized_masked_aggregate_batched(
                        g, coef, u, scale, levels)
                    plain = ref.quantized_masked_aggregate_ref(
                        g, coef, u, scale, levels)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all()),
                          f"quantized T={t} N={n} D={d}: non-finite output")
                    errs.append(float((out - plain).abs().max()))
                wrapped = ops.quantized_masked_aggregate(g, coef, u, mix)
                check(bool(torch.equal(wrapped, out)),
                      "the quantised wrapper differs from the batched call")
                err = max(errs)
                print(f"  quantized_masked_aggregate T={t:>2} N={n:>3} "
                      f"D={d:>7,d}, 6 widths: max|kernel - plain| = "
                      f"{err:.3e} (tol {QUANT_TOL:g})")
                check(err <= QUANT_TOL,
                      f"quantized T={t} N={n} D={d}: error {err} > {QUANT_TOL}")
                worst = max(worst, err)
    return worst


def time_kernels(torch, dev) -> dict:
    """Kernel, plain and library times at the slice's shapes."""
    from repro_torch.kernels.masked_aggregate import ops as agg_ops
    from repro_torch.kernels.masked_aggregate import ref as agg_ref
    from repro_torch.kernels.selection_solve import ops, ref
    rec = {}
    for n in (100, 1_000_000):
        els, p = solver_elements(torch, n, 0.08, 2, dev)
        kw = dict(s_bits=p.grad_size_bits, tau=p.tau_th, p_max=p.p_max)
        io_bytes = 6 * 4 * n                      # 4 inputs read, 2 outputs written
        for name, kern, plain, ops_per in (
                ("fused_solve", ops.fused_solve, ref.fused_solve_ref, FUSED_OPS),
                ("selection_solve", ops.selection_solve,
                 ref.selection_solve_ref, SELECTION_OPS)):
            reps = 200 if n == 100 else 20
            ms = cuda_ms(torch, lambda: kern(*els, **kw), reps)
            plain_ms = cuda_ms(torch, lambda: plain(*els, **kw), max(reps // 20, 3))
            b_ms, b_by = bound_ms(io_bytes, ops_per * n)
            print(f"  {name:16s} E={n:>9,d}: kernel {ms:.6f} ms, plain "
                  f"{plain_ms:.6f} ms, bound {b_ms:.9f} ms ({b_by})")
            if n == 100:            # the slice's shape: one fleet of N = 100
                rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
    # one round's eq.-4 sums: every CNN leaf at T = 16 trajectories, N = 100
    gen = torch.Generator(device=dev).manual_seed(1)
    gs = [torch.randn(16, 100, d, device=dev, generator=gen) for d in CNN_LEAVES]
    coef = torch.rand(16, 100, device=dev, generator=gen)
    nbytes = sum(4 * (16 * 100 * d + 16 * 100 + 16 * d) for d in CNN_LEAVES)
    nops = sum(2 * 16 * 100 * d for d in CNN_LEAVES)
    ms = cuda_ms(torch, lambda: [agg_ops.masked_aggregate_batched(g, coef)
                                 for g in gs], 20)
    plain_ms = cuda_ms(torch, lambda: [agg_ref.masked_aggregate_ref(g, coef)
                                       for g in gs], 3)
    lib_ms = cuda_ms(torch, lambda: [torch.einsum("tnd,tn->td", g, coef)
                                     for g in gs], 20)
    b_ms, b_by = bound_ms(nbytes, nops)
    print(f"  masked_aggregate one round (8 leaves, T=16, N=100, "
          f"{nbytes / 1e9:.3f} GB): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"einsum {lib_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}); kernel at "
          f"{nbytes / ms / 1e6:.1f} GB/s")
    rec["masked_aggregate"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=lib_ms)
    del gs
    # one quantised round: every CNN leaf at T = 18 trajectories, N = 100,
    # 8 bits; no single PyTorch call computes quantise-plus-sum
    t, n = 18, 100
    gs = [torch.randn(t, n, d, device=dev, generator=gen) for d in CNN_LEAVES]
    us = [torch.rand(t, n, d, device=dev, generator=gen) for d in CNN_LEAVES]
    coef = torch.rand(t, n, device=dev, generator=gen)
    levels = agg_ref.quantizer_levels(torch.full((t, n), 8.0, device=dev))
    scales = [agg_ops.row_scale(g, levels) for g in gs]
    nbytes = sum(4 * (2 * t * n * d + 3 * t * n + t * d) for d in CNN_LEAVES)
    nops = sum(QUANT_OPS * t * n * d for d in CNN_LEAVES)
    ms = cuda_ms(torch, lambda: [
        agg_ops.quantized_masked_aggregate_batched(g, coef, u, sc, levels)
        for g, u, sc in zip(gs, us, scales)], 20)
    plain_ms = cuda_ms(torch, lambda: [
        agg_ref.quantized_masked_aggregate_ref(g, coef, u, sc, levels)
        for g, u, sc in zip(gs, us, scales)], 3)
    b_ms, b_by = bound_ms(nbytes, nops)
    print(f"  quantized_masked_aggregate one round (8 leaves, T=18, N=100, "
          f"8 bits, {nbytes / 1e9:.3f} GB): kernel {ms:.6f} ms, plain "
          f"{plain_ms:.6f} ms, library none, bound {b_ms:.6f} ms ({b_by}); "
          f"kernel at {nbytes / ms / 1e6:.1f} GB/s")
    rec["quantized_masked_aggregate"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return rec


def time_round_parts(torch, dev) -> None:
    """Device time of one sweep round's gradient work, for the breakdown:
    per-client gradients of T x N clients and the kernel's eq.-4 sums."""
    from repro_torch.fl.scan_engine import _grid_grads, init_sweep_params
    from repro_torch.fl.engine import FLConfig
    params = init_sweep_params([FLConfig(seed=s) for s in range(16)], device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.rand(16, 100, 8, 28, 28, 1, device=dev, generator=gen)
    labels = torch.randint(0, 10, (16, 100, 8), device=dev, generator=gen)
    coef = torch.rand(16, 100, device=dev, generator=gen)
    coef = coef / coef.sum(dim=1, keepdim=True)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: _grid_grads(params, images, labels, coef,
                                            False), 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  one round's per-client gradients + kernel sums (T=16, N=100, "
          f"b=8): {ms:.3f} ms device time, peak memory {peak:.2f} GiB")


def grid_plans(dev, rounds: int):
    """The first slice's sweep (both scenarios, four strategies) at
    ``rounds`` rounds: (plans, configs, trains, tests)."""
    from repro_torch.fl import experiments as ex
    plans, cfgs, trains, tests = [], [], [], []
    for i, spec in enumerate((ex.HIGH_BIAS, ex.MILD_BIAS)):
        spec = dataclasses.replace(spec, n_rounds=rounds, eval_every=rounds,
                                   solver="fused_kernel")
        p, _, c, train, test = ex.build_scenario_plans(spec, dataset_id=i,
                                                       device=dev)
        plans, cfgs = plans + p, cfgs + c
        trains.append(train)
        tests.append(test)
    return plans, cfgs, trains, tests


def profile_sweep(torch, dev, label: str, built, kernel: str,
                  rounds: int = 5) -> None:
    """Where a sweep round's time goes, at the slice's widths: wall time
    against device-busy time, the share of ``kernel``, and device time by
    kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl.scan_engine import init_sweep_params, run_fl_sweep, stack_plans
    plans, cfgs, trains, tests = built
    stacked, params0 = stack_plans(plans), init_sweep_params(cfgs, device=dev)

    def sweep():
        run_fl_sweep(stacked, trains, tests, cfgs[0], params0, device=dev)
        torch.cuda.synchronize()

    sweep()
    t0 = time.perf_counter()
    sweep()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same device time again
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / rounds
    kern_ms = sum(e.self_device_time_total for e in events
                  if re.search(rf"(?<!\w){kernel}_kernel\b", e.key)) / 1e3 / rounds
    print(f"  {label}: sweep of {len(plans)} trajectories, {rounds} rounds: "
          f"{wall_ms:.3f} ms wall per round (incl. one evaluation), device "
          f"busy {busy_ms:.3f} ms per round under the profiler"
          + (f", idle share {1 - busy_ms / wall_ms:.3f}; {kernel} "
             f"{kern_ms:.3f} ms per round, {kern_ms / busy_ms:.3f} of device "
             f"time, {kern_ms / wall_ms:.3f} of wall time" if busy_ms else
             "; device time not measured by the profiler"))
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3 / rounds:9.3f} ms/round "
              f"{e.count:6d} calls in {rounds} rounds  {e.key[:90]}")


def run_slice(torch, dev, rounds, eval_every) -> dict:
    """The main path, with every launch count zeroed just before it."""
    from repro_torch.fl import experiments as ex
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.selection_solve.ops import solve_joint_kernel
    specs = [dataclasses.replace(s, solver="fused_kernel")
             for s in (ex.HIGH_BIAS, ex.MILD_BIAS)]
    if rounds is not None:
        specs = [dataclasses.replace(s, n_rounds=rounds) for s in specs]
    if eval_every is not None:
        specs = [dataclasses.replace(s, eval_every=eval_every) for s in specs]
    rounds, eval_every = specs[0].n_rounds, specs[0].eval_every
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    results = ex.run_grid(specs, engine="scan", device=dev)
    t_grid = time.perf_counter() - t0
    problems, exact = [], []
    for spec in specs:           # one exact (solver="optimal") solve each
        problem = ex.make_problem_and_data(spec, 0, dev)[0]
        problems.append(problem)
        exact.append(solve_joint_kernel(problem))
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    n_evals = sum((k + 1) % eval_every == 0 or k == rounds - 1
                  for k in range(rounds))
    print(f"  run_grid: {t_grid:.3f} s wall for 2 scenarios x 4 strategies "
          f"({sum(s.n_runs * 2 + 2 for s in specs)} trajectories) x {rounds} rounds")
    print(f"  launches on the main path: {launches}")
    for name in GRID_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    for spec in specs:
        print(ex.format_tables(results[spec.name], spec))
        for strat, res in results[spec.name]["strategies"].items():
            for curve in res["curves"]:
                acc = curve["acc"]
                check(len(acc) == n_evals,
                      f"{spec.name}/{strat}: {len(acc)} evaluations")
                check(all(0.0 <= x <= 1.0 for x in acc),
                      f"{spec.name}/{strat}: accuracy out of [0, 1]")
                check(all(math.isfinite(t) and t >= 0 for t in curve["time"]),
                      f"{spec.name}/{strat}: bad simulated time")
            check(res["mean_participants"] > 0,
                  f"{spec.name}/{strat}: nobody participated")
    return dict(launches=launches, problems=problems, exact=exact,
                results=results)


def check_slice(torch, dev, out: dict) -> None:
    """The slice's outputs against the port's plain paths on the card."""
    from repro_torch.core.alternating import solve_joint
    from repro_torch.core.optimal import solve_joint_optimal
    from repro_torch.fl import experiments as ex
    from repro_torch.fl.scan_engine import init_sweep_params, run_fl_sweep, stack_plans
    from repro_torch.kernels.selection_solve.ops import solve_joint_fused_kernel
    from repro_torch.tree import tree_leaves
    for problem, exact in zip(out["problems"], out["exact"]):
        ref = solve_joint_optimal(problem)
        err = max(float((exact.a - ref.a).abs().max()),
                  float((exact.power - ref.power).abs().max()))
        print(f"  selection_solve kernel vs solve_joint_optimal: {err:.3e}")
        check(err <= SOLVE_TOL, f"exact solve differs by {err}")
        fused = solve_joint_fused_kernel(problem)
        ref = solve_joint(problem)
        err = max(float((fused.a - ref.a).abs().max()),
                  float((fused.power - ref.power).abs().max()))
        print(f"  fused_solve kernel vs solve_joint (Algorithm 2): {err:.3e}")
        check(err <= SOLVE_TOL, f"fused solve differs by {err}")
        check(bool(problem.constraints_satisfied(fused.a, fused.power,
                                                 rtol=1e-3).all()),
              "fused kernel solution violates the constraints")
    # a small sweep on the stacked path (per-client gradients, the kernel's
    # eq.-4 sum) against the fused path, which needs no eq.-4 sum: its one
    # backward pass over the coef-weighted loss gives the same gradient
    spec = dataclasses.replace(ex.HIGH_BIAS, n_devices=16, n_train=600,
                               n_test=200, n_rounds=4, eval_every=2, n_runs=1,
                               solver="fused_kernel")
    plans, _, cfgs, train, test = ex.build_scenario_plans(spec, device=dev)
    runs = [run_fl_sweep(stack_plans(plans), train, test,
                         dataclasses.replace(cfgs[0], aggregate=agg),
                         init_sweep_params(cfgs, device=dev), device=dev)
            for agg in ("stacked", "fused")]
    err = max(float((a - b).abs().max()) for a, b in
              zip(tree_leaves(runs[0].params), tree_leaves(runs[1].params)))
    print(f"  small sweep, kernel aggregate vs fused path: params {err:.3e}")
    check(err <= SOLVE_TOL, f"kernel sweep params differ by {err}")
    for h0, h1 in zip(runs[0].histories, runs[1].histories):
        check(bool((h0.participants == h1.participants).all())
              and abs(h0.sim_time[-1] - h1.sim_time[-1]) <= 1e-6 * max(1.0, h1.sim_time[-1]),
              "kernel sweep accounting differs")


def quantized_plans(torch, dev, rounds=None, eval_every=None):
    """The quantised slice's sweep: both paper scenarios at their widths,
    each with the three uplink schemes of ``QUANT_SCHEMES`` over its
    ``n_runs`` seeds, composed as the reference's closed loop composes
    its quantised group.  The joint scheme plans with the menu solve's
    state on the problem carrying the chosen widths; a fixed b-bit scheme
    solves the problem with a bits leaf of b.  Returns (plans, labels,
    configs, trains, tests, info) with each (scenario, scheme)'s
    expected participants and mean width in ``info``."""
    from repro_torch.core.schedulers import ProbabilisticScheduler
    from repro_torch.fl import experiments as ex
    from repro_torch.fl.engine import FLConfig
    from repro_torch.fl.scan_engine import plan_trajectory
    plans, labels, cfgs, trains, tests, info = [], [], [], [], [], {}
    for i, spec in enumerate((ex.HIGH_BIAS, ex.MILD_BIAS)):
        rounds_i = spec.n_rounds if rounds is None else rounds
        every = spec.eval_every if eval_every is None else eval_every
        problem, train, parts, test = ex.make_problem_and_data(spec, 0, dev)
        trains.append(train)
        tests.append(test)
        for scheme, b in QUANT_SCHEMES:
            if b is None:
                sch = ProbabilisticScheduler(solver="fused", bit_menu=BIT_MENU)
                bits = sch.solve(problem).bits
                qprob = dataclasses.replace(problem, bits=bits)
                state = sch.precompute(problem)
                fp32 = ProbabilisticScheduler(solver="fused").solve(problem)
                check(float(state.a.sum()) >= float(fp32.a.sum()) - SOLVE_TOL,
                      f"{spec.name}: the bit menu lost participation to fp32")
            else:
                qprob = dataclasses.replace(
                    problem, bits=torch.full_like(problem.weights, float(b)))
                sch = ProbabilisticScheduler(solver="fused")
                state = sch.precompute(qprob)
                bits = qprob.bits
            info[(spec.name, scheme)] = dict(
                participants=float(state.a.sum()), width=float(bits.mean()))
            for r in range(spec.n_runs):
                cfg = FLConfig(n_rounds=rounds_i, lr=spec.lr,
                               batch_per_client=spec.batch_per_client,
                               eval_every=every, aggregate="stacked",
                               uplink_bits=b, seed=101 * r)
                plans.append(plan_trajectory(
                    qprob, sch, parts, cfg, state=state, dataset_id=i,
                    bits=bits if b is None else None))
                labels.append((spec.name, scheme))
                cfgs.append(cfg)
    return plans, labels, cfgs, trains, tests, info


def run_quantized(torch, dev, rounds, eval_every) -> dict:
    """The quantised slice's main path, with every launch count zeroed
    just before it: planning and one sweep of all 18 trajectories."""
    from repro_torch.fl.scan_engine import init_sweep_params, run_fl_sweep, stack_plans
    from repro_torch.kernels import cuda_lib
    from repro_torch.tree import tree_leaves
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    plans, labels, cfgs, trains, tests, info = quantized_plans(
        torch, dev, rounds, eval_every)
    t1 = time.perf_counter()
    sweep = run_fl_sweep(stack_plans(plans), trains, tests, cfgs[0],
                         init_sweep_params(cfgs, device=dev), device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda_lib.LAUNCHES)
    rounds, eval_every = cfgs[0].n_rounds, cfgs[0].eval_every
    n_evals = sum((k + 1) % eval_every == 0 or k == rounds - 1
                  for k in range(rounds))
    print(f"  quantised sweep: {len(plans)} trajectories x {rounds} rounds, "
          f"{t2 - t1:.3f} s wall (planning {t1 - t0:.3f} s before it)")
    print(f"  launches on the main path: {launches}")
    check(launches["quantized_masked_aggregate"] == 8 * rounds,
          f"quantized_masked_aggregate launched "
          f"{launches['quantized_masked_aggregate']} times, not 8 x {rounds}")
    print(f"  {'scenario/scheme':28s} {'E[part]':>8} {'width':>6} "
          f"{'energy J':>10} {'time s':>9} {'final acc':>9}")
    for key, st in info.items():
        runs = [h for h, lab in zip(sweep.histories, labels) if lab == key]
        for h in runs:
            check(len(h.eval_acc) == n_evals and
                  all(0.0 <= x <= 1.0 for x in h.eval_acc),
                  f"{key}: bad evaluations {h.eval_acc}")
            check(all(math.isfinite(x) and x >= 0 for x in
                      (*h.sim_time, *h.energy)), f"{key}: bad accounting")
        check(sum(int(h.participants.sum()) for h in runs) > 0,
              f"{key}: nobody participated")
        energy = sum(h.energy[-1] for h in runs) / len(runs)
        sim_time = sum(h.sim_time[-1] for h in runs) / len(runs)
        acc = sum(h.eval_acc[-1] for h in runs) / len(runs)
        print(f"  {key[0] + '/' + key[1]:28s} {st['participants']:8.3f} "
              f"{st['width']:6.2f} {energy:10.3f} {sim_time:9.3f} {acc:9.4f}")
    for x in tree_leaves(sweep.params):
        check(bool(torch.isfinite(x).all()), "non-finite parameters")
    return dict(launches=launches)


def check_quantized_loop(torch, dev) -> None:
    """One trajectory at 8 bits over 4 rounds: the loop engine against
    the sweep on the card.  Both draw round k's noise from the generator
    of (seed, k); float rounding may still put an element one level
    apart (FLIP_SHARE)."""
    from repro_torch.core.schedulers import ProbabilisticScheduler
    from repro_torch.fl import experiments as ex
    from repro_torch.fl.engine import FLConfig, quantize_levels, run_fl
    from repro_torch.fl.scan_engine import run_fl_scan
    from repro_torch.tree import tree_leaves
    spec = ex.HIGH_BIAS
    problem, train, parts, test = ex.make_problem_and_data(spec, 0, dev)
    cfg = FLConfig(n_rounds=4, eval_every=2, lr=spec.lr,
                   batch_per_client=spec.batch_per_client,
                   aggregate="stacked", uplink_bits=8, seed=0)
    sch = ProbabilisticScheduler(solver="fused")
    loop = run_fl(problem, sch, train, parts, test, cfg, device=dev)
    scan = run_fl_scan(problem, sch, train, parts, test, cfg, device=dev)
    diff = torch.cat([(a - b).abs().ravel() for a, b in
                      zip(tree_leaves(loop.params), tree_leaves(scan.params))])
    ref = torch.cat([a.abs().ravel() for a in tree_leaves(loop.params)])
    off = float((diff > SOLVE_TOL + SOLVE_TOL * ref).float().mean())
    level = cfg.n_rounds * cfg.lr * GRAD_BOUND / quantize_levels(8)
    t_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                zip(scan.history.sim_time, loop.history.sim_time))
    print(f"  run_fl vs run_fl_scan, 8 bits, 4 rounds, N={problem.n_devices}: "
          f"params max "
          f"{float(diff.max()):.3e}, share beyond {SOLVE_TOL:g} {off:.2e} "
          f"(limits {level:.3e} and {FLIP_SHARE:g}); participants "
          f"{loop.history.participants.tolist()}; sim_time rel {t_err:.2e}; "
          f"acc {loop.history.eval_acc.tolist()} vs "
          f"{scan.history.eval_acc.tolist()}")
    check(int(loop.history.participants.sum()) > 0, "the loop check trained nobody")
    check((loop.history.participants == scan.history.participants).all(),
          "loop and sweep participants differ")
    check(t_err <= 1e-6, f"loop and sweep sim_time differ by {t_err}")
    check(off <= FLIP_SHARE and float(diff.max()) <= SOLVE_TOL + level,
          "loop and sweep parameters differ by more than a level")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per trajectory (default: the scenarios' 400)")
    ap.add_argument("--eval-every", type=int, default=None,
                    help="rounds between evaluations (default: the scenarios' 10)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib

    t_start = time.perf_counter()
    dev = resolve_device(None)
    card_line = card()
    print(f"[card] {card_line}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.build()
    cuda_lib.library()
    print(f"  built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log = cuda_lib.build_log(lib)
    for line in (log.read_text().splitlines() if log.exists() else
                 [f"(no compiler log beside {lib.name})"]):
        if "registers" in line or "spill" in line or line[:2] in ("==", "(n"):
            print("  " + line.strip())

    print("[2] kernels against their plain versions", flush=True)
    errs = check_solvers(torch, dev)
    errs["masked_aggregate"] = check_aggregate(torch, dev)
    errs["quantized_masked_aggregate"] = check_quantized(torch, dev)

    print("[3] times (CUDA events)", flush=True)
    rec = time_kernels(torch, dev)
    time_round_parts(torch, dev)
    profile_sweep(torch, dev, "grid", grid_plans(dev, 5), "masked_aggregate")
    plans, _, cfgs, trains, tests, _ = quantized_plans(torch, dev, 5, 5)
    profile_sweep(torch, dev, "quantised", (plans, cfgs, trains, tests),
                  "quantized_masked_aggregate")
    del plans

    print("[4] the slice: run_grid over both scenarios", flush=True)
    out = run_slice(torch, dev, args.rounds, args.eval_every)
    check_slice(torch, dev, out)

    print("[5] the quantised uplink: one sweep over both scenarios x three "
          "schemes", flush=True)
    qout = run_quantized(torch, dev, args.rounds, args.eval_every)
    check_quantized_loop(torch, dev)
    out["launches"]["quantized_masked_aggregate"] = \
        qout["launches"]["quantized_masked_aggregate"]

    sources = {"fused_solve": ("src/repro_torch/csrc/selection_solve.cu",
                               "src/repro/kernels/selection_solve/kernel.py:143"),
               "selection_solve": ("src/repro_torch/csrc/selection_solve.cu",
                                   "src/repro/kernels/selection_solve/kernel.py:83"),
               "masked_aggregate": ("src/repro_torch/csrc/masked_aggregate.cu",
                                    "src/repro/kernels/masked_aggregate/kernel.py:91"),
               "quantized_masked_aggregate": (
                   "src/repro_torch/csrc/masked_aggregate.cu",
                   "src/repro/kernels/masked_aggregate/kernel.py:58")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=out["launches"][name], max_abs_err=errs[name],
                    **rec[name])
               for name, (src, rep) in sources.items()]
    print(f"[6] done in {time.perf_counter() - t_start:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
