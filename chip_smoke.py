#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--rounds K] [--eval-every E]

By default both main paths run the paper scenarios' own depth (400
rounds, evaluated every 10); the flags set both.

Phases, each of which fails the run (non-zero exit, no result line):

1. build the port's CUDA kernels from ``src/repro_torch/csrc``, print
   each kernel function's registers, spills and shared memory, and the
   card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   slices' shapes and at ragged ones, within the stated tolerance;
3. time each kernel with CUDA events (the decode attention, whose
   launches are shorter than the host's cost of making them, and the SSD
   scan's passes by the profiler's device time) beside its bound, its
   plain version and (for the plain aggregate and the decode attention)
   one PyTorch library call, and profile a few rounds of each sweep;
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
6. drive the serving slice: gemma3-1b at full width (999,826,048
   parameters from a seeded generator), first teacher-forced decode
   against ``forward`` over 640 tokens, then ``BatchedServer`` on 8
   requests at 24 and at 600 new tokens, every attention layer of every
   decode step through the decode kernel, and profile a few steps; then
   the decode kernel's device time over the whole gen-600 run, every
   step's launches made again at its position under the profiler;
7. drive the Mamba2 slice: mamba2-780m at full width (780,382,464
   parameters from a seeded generator), prefilled through
   ``make_prefill_step`` at B = 1, S = 32,768 and at B = 4, S = 4,096,
   every layer's scan through the SSD kernel (48 launches a prefill, four
   passes each), one prefill profiled; then teacher-forced decode (the
   recurrence) against
   ``forward`` over 512 tokens, and ``BatchedServer`` on 8 requests;
8. drive the batched fleet solve: ``make_batch("rayleigh_fading", 64)``
   (E = 64,000) and a ragged ``make_mixed_batch`` of five scenarios
   (N_max = 1,000) through all five methods of ``solve_joint_batch``,
   the kernel methods held to ``optimal`` / ``fused``, each instance to
   its own solve and padded slots to 0; then ``make_batch(
   "mega_fleet_100k", 8)`` (E = 800,000) and one ``metro_1m_users`` draw
   (E = 1,000,000) through both kernel methods, every instance feasible,
   timed beside the kernels' bound, the work their function needs
   (``element_work``), and phase [1]'s count of the compiled loop;
9. print the kernel record, the card, and the last line
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
# TF32 on the tensor cores, dense; the SSD scan's 3xTF32 products make three
# passes through them for each float32 product
TF32_OPS_PER_S = 495e12
# operations per element, counting each float32 arithmetic operation,
# comparison, select and transcendental call as one (csrc/solve_common.cuh):
# fused: init 18, then 50 steps of 38; selection: 61 feasibility tests of
# 13, 60 bisection updates of 4, and 9 for P*
FUSED_OPS = 18 + 50 * 38
SELECTION_OPS = 61 * 13 + 60 * 4 + 9
# Kernels 1-2's bound: the work their function needs (csrc/solve_common.cuh
# as written), whatever code the compiler makes of it, in thread-level
# instructions on the FP32/ALU pipes and on the special-function (MUFU)
# pipe.  A multiply-add counts as one FFMA and a term that does not change
# across steps once an element; loop control counts nothing.  Each
# primitive's least cost, (FP32/ALU, MUFU):
#   a correctly rounded division (div.rn.f32): a reciprocal estimate
#     (1 MUFU.RCP), one Newton step (2 FFMA), the quotient, its residual
#     and the correction (3);
#   expm1f: the argument scaled and rounded to an integer j (2), the
#     remainder x - j ln 2 against a two-part ln 2 (2), a degree-6
#     polynomial on |r| <= ln 2 / 2 (6 FFMA, float32's 24 bits), 2^j
#     (1 MUFU.EX2) and 2^j (expm1(r) + 1) - 1 (2);
#   logf: the exponent and mantissa split (3 integer), a degree-8
#     polynomial in the mantissa (8 FFMA) and e ln 2 + p (1), no MUFU.
DIV, EXPM1, LOG = (5, 1), (12, 1), (12, 0)
# an SM's 128 FP32 lanes issue one instruction each a clock (the published
# 67 TFLOP/s counts an FFMA as two operations); its 16 MUFU lanes, 4 per
# partition (NVIDIA's Hopper architecture white paper), an eighth of that.
# Compares, selects, min and max are priced at the FP32 rate too, which
# they cannot beat.
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
MUFU_PER_S = FP32_INSTR_PER_S * 16 / 128
# the compiled code's count, a diagnostic beside the bound: an SM issues
# at most 4 warp-instructions a clock (one per scheduler)
ISSUE_PER_CLOCK = 4
MUFU_LANES_PER_CLOCK = 16
SOLVE_STEPS = {"fused_solve": 50, "selection_solve": 60}   # N_ALT, N_BISECT
# quantised sum per element: a true division, floor, subtraction,
# comparison, select, addition, max, min, two multiplies and an addition
QUANT_OPS = 11
SOLVE_TOL = 1e-5        # a* and P*: the reference's solver tolerance
AGG_TOL = 1e-5          # eq.-4 sum of O(1) values, same order of addition
QUANT_TOL = 0.0         # the quantised sum: same arithmetic, same order
DECODE_TOL = 2e-5       # decode attention: the reference's float32 tolerance
# the SSD scan: the reference's tolerances for its kernel against the
# sequential recurrence and for its wrapper against the chunked form
SSD_SEQ_TOL = 1e-4
SSD_TOL = 2e-4
SELF_CHECK_TOL = 1e-3   # full-width decode logits against forward's
# gemma3-1b's attention: MQA, one KV head for G = 4 query heads of 256
GEMMA3_HEADS = (1, 4, 256)
SERVE_GENS = (24, 600)  # the reference server's default, and past the window
# mamba2-780m's scan: 48 heads of P = 64, d_state 128, chunk 256; the
# prefills (B, S): prefill_32k's length with its batch cut from 32 (whose
# float32 logits alone would be 211 GB), and a batch of 4 at 4,096
MAMBA2_SSD = (48, 64, 128, 256)
MAMBA2_PREFILLS = ((1, 32768), (4, 4096))
MAMBA2_SELF_CHECK = (2, 512)        # teacher-forced decode: 2 chunks
# decode timings at gemma3's heads beyond the serving step: (B, W, window,
# distinct caches, repetitions); the serving runs' caches (W 88 at gen 24,
# 512 and 664 at gen 600) and a long cache at a larger batch
DECODE_TIMING_SHAPES = ((4, 88, None, 64, 50), (4, 88, 512, 64, 50),
                        (4, 512, 512, 32, 50), (4, 664, None, 24, 50),
                        (16, 512, 512, 8, 50), (16, 32768, None, 1, 20))
# the CNN's parameter leaves (conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b)
CNN_LEAVES = (72, 8, 1152, 16, 195216, 249, 2490, 10)
# the quantised slice: the joint bit allocation's menu, and the schemes
# (None: the menu's per-device widths; b: a fixed b-bit uplink)
BIT_MENU = (8, 16, 32)
QUANT_SCHEMES = (("joint_bits", None), ("fixed_8", 8), ("fixed_4", 4))
GRID_KERNELS = ("fused_solve", "selection_solve", "masked_aggregate")
# the batched fleet solve: its five methods, the ragged mixed ensemble
# (N_max 1,000 from dense_1k), the fused-kernel and kernel methods against
# the plain methods that solve the same problem
BATCH_METHODS = ("alternating", "fused", "optimal", "kernel", "fused_kernel")
MIXED_SCENARIOS = ("paper_static", "hetero_bandwidth", "dense_1k",
                   "bandwidth_starved", "sparse_energy_starved")
KERNEL_METHODS = (("kernel", "selection_solve", "optimal"),
                  ("fused_kernel", "fused_solve", "fused"))
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


def sm_count(torch) -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


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


def kernel_re(kernel: str) -> re.Pattern:
    """The device kernels a wrapper launches, by name: ``<kernel>_kernel``
    and its passes ``<kernel>_<pass>_kernel``."""
    return re.compile(rf"(?<!\w){kernel}(_[a-z]+)?_kernel\b")


def device_ms(torch, fn, reps: int, kernel: str | None = None):
    """Device time of ``fn`` per call from the profiler, over ``reps``
    warm calls: (all device operations, ``kernel``'s launches, and
    ``kernel``'s launches by function name).  Unlike CUDA events around
    back-to-back calls, it does not count the device's idle time while
    the host makes the next launch.  A profile that recorded no device
    time at all is taken again, up to twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            break
    check(total > 0, "the profiler recorded no device time")
    pat = kernel_re(kernel) if kernel else None
    mine = [e for e in events if pat and pat.search(e.key)]
    by_name = {e.key: e.self_device_time_total / 1e3 / reps for e in mine}
    return total / 1e3 / reps, sum(by_name.values()), by_name


def dynamic_smem(source: Path) -> None:
    """Print the dynamic shared memory a block of each kernel in
    ``source``, which the compiler's log does not show: the sizes its
    ``static_assert``s hold (the build has just checked them)."""
    for size, what in re.findall(
            r'static_assert\(sizeof\(\w+\) == (\d+), "(\w+): dynamic shared memory"\)',
            source.read_text()):
        print(f"  {what}: {int(size):,} bytes dynamic shared memory a block")


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
BRANCH = re.compile(r"\bBRA\s+(?:!?U?P\d,\s*)?0x([0-9a-f]+)")


def parse_sass(text: str) -> dict:
    """Each function's instructions in ``cuobjdump -sass`` output, as
    (address, text), by mangled name."""
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
        elif name and (m := SASS_LINE.search(line)):
            funcs[name].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def loop_step(instrs: list) -> dict:
    """One step of the function's main loop on its shortest path.

    The main loop is the backward branch whose body holds the most
    exponentials (``MUFU.EX2``).  Through the body, every conditional
    forward branch may be taken or not; the count is the shortest path
    that still computes every exponential of the body: it skips the
    divisions' slow-path calls (``FCHK``), the printed eq. (13)'s extra
    division and the a = 0 shortcut.  A body unrolled U times (U
    exponentials) gives per-step counts /U.  Every instruction on the
    path counts once, predicated-off ones and the split multiply-adds of
    a ``--fmad=false`` build too: it counts this build's issue slots, not
    the work the function needs (``element_work``)."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}

    def ex2(lo, hi):
        return sum("MUFU.EX2" in t for _, t in instrs[lo:hi + 1])

    loops = []
    for i, (addr, text) in enumerate(instrs):
        m = BRANCH.search(text)
        if m and int(m.group(1), 16) < addr:
            head = index[int(m.group(1), 16)]
            loops.append((ex2(head, i), i - head, head, i))
    _, _, head, end = max(loops)
    need = ex2(head, end)
    memo = {}

    def walk(i, seen):
        """(instructions, MUFU) from i to the loop's end having computed
        ``seen`` exponentials so far, or None."""
        key = (i, seen)
        if key in memo:
            return memo[key]
        text = instrs[i][1]
        seen += "MUFU.EX2" in text
        if i == end:
            best = (0, 0) if seen == need else None
        else:
            nexts = [i + 1]
            m = BRANCH.search(text)
            if m:
                target = index[int(m.group(1), 16)]
                nexts = [target] if not text.startswith("@") else [i + 1, target]
            paths = [r for r in (walk(j, seen) for j in nexts) if r is not None]
            best = min(paths) if paths else None
        memo[key] = None if best is None else (
            best[0] + 1, best[1] + opcode(text).startswith("MUFU"))
        return memo[key]

    count, mufu = walk(head, 0)
    return dict(instructions=count / need, mufu=mufu / need, unroll=need,
                body=end - head + 1)


def solve_sass(torch, lib: Path) -> dict:
    """Kernels 1-2's loop steps, counted from the built library."""
    from repro_torch.kernels import cuda_lib
    tool = Path(cuda_lib._nvcc()).parent / "cuobjdump"
    funcs = parse_sass(subprocess.run(
        [str(tool), "-sass", str(lib)], capture_output=True, text=True,
        timeout=300, check=True).stdout)
    out = dict(sms=sm_count(torch), clock_hz=sm_clock_hz())
    for name in ("fused_solve", "selection_solve"):
        (instrs,) = [v for k, v in funcs.items() if f"{name}_kernel" in k]
        out[name] = step = loop_step(instrs)
        print(f"  {name}_kernel SASS: {len(instrs)} instructions; its loop "
              f"body {step['body']} of them, {step['unroll']} step(s) an "
              f"iteration; one step on its shortest path "
              f"{step['instructions']:.2f} instructions, "
              f"{step['mufu']:.2f} of them MUFU")
    print(f"  priced at {ISSUE_PER_CLOCK} warp-instructions and "
          f"{MUFU_LANES_PER_CLOCK} MUFU lanes a clock on each of "
          f"{out['sms']} SMs at {out['clock_hz'] / 1e6:.0f} MHz")
    for name, steps in SOLVE_STEPS.items():
        instr, mufu = element_work(name, steps)
        print(f"  {name}: the work its function needs, {instr} FP32/ALU and "
              f"{mufu} MUFU instructions an element ({steps} steps; "
              f"element_work)")
    return out


def element_work(name: str, steps: int) -> tuple[int, int]:
    """(FP32/ALU, MUFU) instructions one element of kernel 1 or 2 needs.

    fused_solve: B tau and pg > 0 once, fused_init's a^0 (T(P^max) and
    eq. 13: 12 operations, 4 divisions, a log), then each of ``steps``
    steps of fused_step: P^min (3 operations and a select, 2 divisions,
    expm1), its clamps and gate (3), T(P) (3, 2 divisions, a log), lambda
    (5), the eq.-10 test (4), eq. 13 (9, 2 divisions) and the gated
    update (1).  selection_solve: B tau once, ``steps`` + 1 feasibility
    tests (P^min and F(a): 8 operations, 2 divisions, expm1), ``steps``
    bisection updates (the midpoint and two selects: 4), and P* (6, 2
    divisions, expm1)."""
    if name == "fused_solve":
        ops, div, expm1, log = (14 + 29 * steps, 4 + 6 * steps, steps,
                                1 + steps)
    else:
        ops, div, expm1, log = (1 + 8 * (steps + 1) + 4 * steps + 6,
                                2 * (steps + 2), steps + 2, 0)
    return (ops + div * DIV[0] + expm1 * EXPM1[0] + log * LOG[0],
            div * DIV[1] + expm1 * EXPM1[1] + log * LOG[1])


def solve_bound_ms(name: str, n: int) -> tuple[float, str]:
    """Kernel 1 or 2's least time for ``n`` elements: the work its function
    needs at the FP32/ALU pipes' rate or at the MUFU pipe's, or its bytes
    (4 inputs read, 2 outputs written) at the memory's rate, whichever
    is larger; and which of the three it is."""
    instr, mufu = element_work(name, SOLVE_STEPS[name])
    t, by = max((n * instr / FP32_INSTR_PER_S, "FP32 issue"),
                (n * mufu / MUFU_PER_S, "MUFU"),
                (6 * 4 * n / HBM_BYTES_PER_S, "bytes"))
    return t * 1e3, by


def sass_issue_ms(sass: dict, name: str, n: int) -> float:
    """The compiled loop's steps (phase [1]'s SASS) at the SM's issue rate
    and MUFU rate: what this build would take if it issued every cycle, a
    diagnostic beside ``solve_bound_ms``, not a bound on the function."""
    step, steps = sass[name], SOLVE_STEPS[name]
    warps = math.ceil(n / 32) * steps
    per_sm_clock = sass["sms"] * sass["clock_hz"]
    t_issue = warps * step["instructions"] / (ISSUE_PER_CLOCK * per_sm_clock)
    t_mufu = warps * step["mufu"] * 32 / (MUFU_LANES_PER_CLOCK * per_sm_clock)
    return max(t_issue, t_mufu) * 1e3


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


def time_kernels(torch, dev, sass: dict) -> dict:
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
            old_ms, old_by = bound_ms(io_bytes, ops_per * n)
            b_ms, b_by = solve_bound_ms(name, n)
            print(f"  {name:16s} E={n:>9,d}: kernel {ms:.6f} ms, plain "
                  f"{plain_ms:.6f} ms, bound {b_ms:.9f} ms ({b_by}; the "
                  f"kernel at {b_ms / ms:.3f} of it); each operation one "
                  f"float32 operation: {old_ms:.9f} ms ({old_by}); the "
                  f"compiled loop at the issue rate "
                  f"{sass_issue_ms(sass, name, n):.9f} ms")
            if n == 100:            # the slice's shape: one fleet of N = 100
                rec[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by="bytes" if b_by == "bytes"
                                 else "operations", library_ms=None)
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


# ------------------------------------------------------ batched fleet solve

def solve_err(got, ref) -> float:
    """The largest difference of two solutions in the form the solver
    tolerance takes (atol = rtol on P*): max |da|, |dP| / (1 + |P|) and
    |d objective|.  Two runs of the fixed point that stop at different
    steps differ by up to about 2e-5 in P* near P^max, since P^min
    magnifies a's last moves."""
    return max(float((got.a - ref.a).abs().max()),
               float(((got.power - ref.power).abs()
                      / (1.0 + ref.power.abs())).max()),
               float((got.objective - ref.objective).abs().max()))

def check_batch_solution(torch, label, batch, sols, problems, singles) -> None:
    """One ensemble's five solutions: the kernel methods against the
    plain methods that solve the same problem, padded slots 0, and each
    instance against its own solve and within the constraints."""
    for kern, _, plain in KERNEL_METHODS:
        err = solve_err(sols[kern], sols[plain])
        print(f"  {label}: max|{kern} - {plain}| = {err:.3e} (tol {SOLVE_TOL:g})")
        check(err <= SOLVE_TOL, f"{label}: {kern} differs from {plain} by {err}")
    pad = ~batch.mask
    for m, sol in sols.items():
        check(not bool(sol.a[pad].any()) and not bool(sol.power[pad].any()),
              f"{label}/{m}: a padded slot is not 0")
        check(bool(torch.isfinite(sol.a).all() and torch.isfinite(sol.power).all()),
              f"{label}/{m}: non-finite solution")
        err, steps = 0.0, 0
        for b, (problem, one) in enumerate(zip(problems, singles[m])):
            inst = sol.instance(b)
            err = max(err, solve_err(inst, one))
            # the fused method's one loop runs until its slowest instance
            # stops: its shared count is at least each instance's own
            steps = max(steps, one.n_iters - inst.n_iters if m == "fused"
                        else abs(inst.n_iters - one.n_iters))
            check(inst.converged == one.converged,
                  f"{label}/{m}: instance {b} converged differs")
            check(bool(problem.constraints_satisfied(inst.a, inst.power,
                                                     rtol=1e-3).all()),
                  f"{label}/{m}: instance {b} infeasible")
        print(f"  {label}/{m}: max|batch - per-instance solve| = {err:.3e}, "
              f"n_iters within {steps}, every instance feasible")
        check(err <= SOLVE_TOL and steps <= 1,
              f"{label}/{m}: batch differs from its per-instance solves")


def run_batched(torch, dev) -> dict:
    """The batched fleet solve, with every launch count zeroed just before
    it: two ensembles through all five methods of ``solve_joint_batch``,
    then the mega-fleet batch and a metro draw through the kernel
    methods.  Returns the launches and the four batches."""
    from repro_torch.core.alternating import solve_joint, solve_joint_fused
    from repro_torch.core.batch import solve_joint_batch
    from repro_torch.core.optimal import solve_joint_optimal
    from repro_torch.core.scenarios import make_batch, make_mixed_batch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.selection_solve.ops import (
        solve_joint_fused_kernel, solve_joint_kernel)
    single = dict(alternating=solve_joint, fused=solve_joint_fused,
                  optimal=solve_joint_optimal, kernel=solve_joint_kernel,
                  fused_kernel=solve_joint_fused_kernel)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    ensembles = [("rayleigh_fading x 64",
                  make_batch("rayleigh_fading", 64, seed=0, device=dev)),
                 ("mixed x 5", make_mixed_batch(MIXED_SCENARIOS, seed=0,
                                                device=dev))]
    results = []
    for label, batch in ensembles:
        sols = {}
        for m in BATCH_METHODS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sols[m] = solve_joint_batch(batch, method=m)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            print(f"  {label} (B={batch.batch_size}, N_max={batch.n_max}, "
                  f"E={sols[m].a.numel():,}) {m:13s}: {dt * 1e3:9.3f} ms, "
                  f"objective mean {float(sols[m].objective.mean()):.6f}, "
                  f"n_iters {sorted(set(sols[m].n_iters.tolist()))}")
        results.append((label, batch, sols))
    mega = [("mega_fleet_100k x 8", make_batch("mega_fleet_100k", 8, seed=0,
                                                device=dev)),
            ("metro_1m_users x 1", make_batch("metro_1m_users", 1, seed=0,
                                               device=dev))]
    mega_sols = [{m: solve_joint_batch(batch, method=m)
                  for m, _, _ in KERNEL_METHODS} for _, batch in mega]
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"  launches on the batched path: {launches}")
    for _, name, _ in KERNEL_METHODS:
        check(launches[name] == len(ensembles) + len(mega),
              f"kernel {name} launched {launches[name]} times on the batched "
              f"path, not once per batch ({len(ensembles) + len(mega)})")
    for label, batch, sols in results:
        problems = batch.unstack()
        singles = {m: [single[m](p) for p in problems] for m in BATCH_METHODS}
        check_batch_solution(torch, label, batch, sols, problems, singles)
    for (label, batch), sols in zip(mega, mega_sols):
        for m, name, plain in KERNEL_METHODS:
            sol = sols[m]
            err = solve_err(sol, solve_joint_batch(batch, method=plain))
            feasible = all(bool(p.constraints_satisfied(
                sol.instance(b).a, sol.instance(b).power, rtol=1e-3).all())
                for b, p in enumerate(batch.unstack()))
            print(f"  {label} {m}: objective mean "
                  f"{float(sol.objective.mean()):.6f}, E[participants] "
                  f"{float(sol.a.sum()) / batch.batch_size:.1f} per instance, "
                  f"max|{m} - {plain}| = {err:.3e}, feasible={feasible}")
            check(feasible, f"{label}/{m}: an instance is infeasible")
            check(err <= SOLVE_TOL, f"{label}/{m}: differs from {plain} by {err}")
    return dict(launches=launches, batches=[(label, batch) for label, batch, _
                                            in results] + mega)


def time_batched(torch, dev, batches, sass) -> None:
    """Kernels 1-2 at the batched shapes (CUDA events): each kernel alone
    on the batch's flattened elements, beside its bound, the compiled
    loop's issue time and its plain version, and the whole
    ``solve_joint_batch`` method; and the host's ``make_batch`` alone."""
    from repro_torch.core.batch import batch_elements, solve_joint_batch
    from repro_torch.core.scenarios import make_batch
    from repro_torch.kernels.selection_solve import ops, ref
    kernels = {"selection_solve": (ops.selection_solve, ref.selection_solve_ref),
               "fused_solve": (ops.fused_solve, ref.fused_solve_ref)}
    for label, batch in batches:
        el = batch_elements(batch)
        flat = [x.reshape(-1).contiguous() for x in el[:4]]
        n = flat[0].numel()
        kw = dict(s_bits=batch.problem.grad_size_bits,
                  tau=batch.problem.tau_th, p_max=batch.problem.p_max)
        for method, name, _ in KERNEL_METHODS:
            kern, plain = kernels[name]
            ms = cuda_ms(torch, lambda: kern(*flat, **kw), 20)
            plain_ms = cuda_ms(torch, lambda: plain(*flat, **kw), 3)
            method_ms = cuda_ms(torch, lambda: solve_joint_batch(
                batch, method=method), 5)
            b_ms, b_by = solve_bound_ms(name, n)
            print(f"  {label} {name:16s} E={n:>9,d}: kernel {ms:.6f} ms, "
                  f"bound {b_ms:.6f} ms ({b_by}; the kernel at "
                  f"{b_ms / ms:.3f} of it), the compiled loop at the issue "
                  f"rate {sass_issue_ms(sass, name, n):.6f} ms, plain "
                  f"{plain_ms:.6f} ms, solve_joint_batch(method={method!r}) "
                  f"{method_ms:.6f} ms")
    for name, count in (("mega_fleet_100k", 8), ("metro_1m_users", 1)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make_batch(name, count, seed=0, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"  host: make_batch({name!r}, {count}) draws, stacks and "
              f"copies in {', '.join(f'{t:.1f}' for t in times)} ms")


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


def profile_run(torch, label: str, fn, per: int, unit: str,
                kernel: str | None) -> None:
    """Where the time of a warm ``fn`` goes: wall time against device-busy
    time (torch.profiler), the idle share, ``kernel``'s share of device
    time where ``kernel`` names one, and device time by kernel.  ``fn(k)``
    is called twice, k = 0 timed and k = 1 profiled; one call makes
    ``per`` ``unit``s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / per
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(1)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same device time again
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / per
    kern_events = [e for e in events if kernel and kernel_re(kernel).search(e.key)]
    kern_ms = sum(e.self_device_time_total for e in kern_events) / 1e3 / per
    share = (f"; {kernel} {kern_ms:.3f} ms per {unit}, {kern_ms / busy_ms:.3f} "
             f"of device time, {kern_ms / wall_ms:.3f} of wall time"
             if kernel and busy_ms else "")
    print(f"  {label}: {wall_ms:.3f} ms wall per {unit}, device busy "
          f"{busy_ms:.3f} ms under the profiler "
          f"({sum(e.count for e in events) / per:.0f} device operations a {unit})"
          + (f", idle share {1 - busy_ms / wall_ms:.3f}{share}" if busy_ms else
             "; device time not measured by the profiler"))
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3 / per:10.4f} ms/{unit} "
              f"{e.count / per:8.1f} calls a {unit}  {e.key[:90]}")
    if len(kern_events) > 1:
        print(f"  {kernel} by kernel function:")
        for e in kern_events:
            print(f"    {e.self_device_time_total / 1e3 / per:10.4f} ms/{unit} "
                  f"{e.count / per:8.1f} calls a {unit}  {e.key[:90]}")


def profile_sweep(torch, dev, label: str, built, kernel: str,
                  rounds: int = 5) -> None:
    """Where a sweep round's time goes, at the slice's widths."""
    from repro_torch.fl.scan_engine import init_sweep_params, run_fl_sweep, stack_plans
    plans, cfgs, trains, tests = built
    stacked, params0 = stack_plans(plans), init_sweep_params(cfgs, device=dev)

    def sweep(_k=None):
        run_fl_sweep(stacked, trains, tests, cfgs[0], params0, device=dev)

    sweep()
    profile_run(torch, f"{label}: sweep of {len(plans)} trajectories, {rounds} "
                f"rounds (a round incl. one evaluation)", sweep, rounds, "round",
                kernel)


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


# --------------------------------------------------------- decode attention

def ring_positions(torch, w: int, qpos: int, dev):
    """pos_buf of a ring of W slots after writing positions 0..qpos: slot
    s holds the latest position p <= qpos with p % W == s, or -1."""
    latest = qpos - (qpos - torch.arange(w, device=dev)) % w
    return torch.where(latest >= 0, latest, -1).to(torch.int32)


def decode_operands(torch, dev, b, w, hkv, g, dh, seed):
    """q [B, Hkv, G, dh] pre-scaled by dh^-0.5, k and v [B, W, Hkv, dh]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, hkv, g, dh, device=dev, generator=gen) * dh ** -0.5
    k = torch.randn(b, w, hkv, dh, device=dev, generator=gen)
    v = torch.randn(b, w, hkv, dh, device=dev, generator=gen)
    return q, k, v


def check_decode(torch, dev) -> float:
    """The decode kernel against its plain version at the reference kernel
    tests' shapes (last 3 slots empty), at gemma3's heads for rings that
    are filling, full or wrapped (any W, either mask; W = 88 is the
    serving run's 64 + 24 cache, 512 and 664 its gen-600 caches), and at the
    reduced configs' head widths."""
    from repro_torch.kernels.swa_decode import ops, ref
    cases = []
    for w, hkv, g, dh, window in ((512, 4, 4, 64, None), (1024, 2, 8, 128, 300),
                                  (512, 1, 4, 128, 128), (256, 8, 1, 64, None)):
        pos = torch.where(torch.arange(w, device=dev) < w - 3,
                          torch.arange(w, device=dev), -1).to(torch.int32)
        cases.append((2, w, hkv, g, dh, window, w + 5, pos))
    for w in (88, 96, 97, 512, 664, 4096):
        for window in (None, 512):
            for qpos in (w // 2, w - 1, w + 37):
                cases.append((4, w, *GEMMA3_HEADS, window, qpos,
                              ring_positions(torch, w, qpos, dev)))
    for b, w, hkv, g, dh, window, qpos in ((2, 70, 1, 4, 64, None, 69),
                                           (2, 64, 1, 4, 16, 64, 129),
                                           (3, 130, 2, 3, 80, 64, 200),
                                           (3, 130, 2, 3, 30, None, 200)):
        cases.append((b, w, hkv, g, dh, window, qpos,
                      ring_positions(torch, w, qpos, dev)))
    worst = 0.0
    for i, (b, w, hkv, g, dh, window, qpos, pos) in enumerate(cases):
        q, k, v = decode_operands(torch, dev, b, w, hkv, g, dh, i)
        out = ops.swa_decode(q, k, v, pos, qpos, window=window)
        plain = ref.swa_decode_ref(q, k, v, pos, qpos, window=window)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        ok = bool(torch.isfinite(out).all()) and bool(torch.allclose(
            out, plain, rtol=DECODE_TOL, atol=DECODE_TOL))
        print(f"  swa_decode B={b} W={w:>5} Hkv={hkv} G={g} dh={dh:>3} "
              f"window={window} qpos={qpos:>5}: max|kernel - plain| = "
              f"{err:.3e} (rtol = atol = {DECODE_TOL:g})")
        check(ok, f"swa_decode W={w} G={g} dh={dh} window={window}: "
                  f"error {err} beyond {DECODE_TOL}")
        worst = max(worst, err)
    # the split's edges at gemma3's heads: split counts from one to many
    # (a W that none of them divides, rings filling so that the later
    # splits hold no valid slot, a window that empties most of them), a
    # single slot, and a long ring at B = 16 under a window
    for i, (b, w, window, qpos, splits) in enumerate((
            (4, 512, None, 100, (1, 2, 7, 33, 64)),
            (4, 97, 64, 300, (1, 5, 64)),
            (4, 664, 512, 1327, (1, 20, 64)),
            (2, 1, None, 0, (1,)),
            (16, 32768, 512, 40000, (1, 17, 64)))):
        q, k, v = decode_operands(torch, dev, b, w, *GEMMA3_HEADS, 50 + i)
        pos = ring_positions(torch, w, qpos, dev)
        plain = ref.swa_decode_ref(q, k, v, pos, qpos, window=window)
        for nsplit in splits:
            out = ops._launch(q, k, v, pos, qpos, window, nsplit)
            torch.cuda.synchronize()
            err = float((out - plain).abs().max())
            print(f"  swa_decode B={b:>2} W={w:>5} window={window} qpos={qpos:>5} "
                  f"nsplit={nsplit:>3}: max|kernel - plain| = {err:.3e}")
            check(bool(torch.isfinite(out).all()) and bool(torch.allclose(
                out, plain, rtol=DECODE_TOL, atol=DECODE_TOL)),
                f"swa_decode W={w} nsplit={nsplit}: error {err} beyond {DECODE_TOL}")
            worst = max(worst, err)
        del q, k, v, plain
    # no valid slot at all: the output is 0, with one split or many
    q, k, v = decode_operands(torch, dev, 2, 256, 2, 4, 64, 60)
    pos = torch.full((256,), -1, dtype=torch.int32, device=dev)
    for nsplit in (1, 4, 64):
        out = ops._launch(q, k, v, pos, 5, None, nsplit)
        check(bool((out == 0).all()), f"swa_decode, no valid slot, nsplit={nsplit}: "
              f"max|out| {float(out.abs().max())}")
    print("  swa_decode, no valid slot, nsplit 1, 4 and 64: every output 0")
    # the same bits from launch to launch at the split the wrapper picks
    for b, w in ((4, 664), (16, 32768)):
        q, k, v = decode_operands(torch, dev, b, w, *GEMMA3_HEADS, 70)
        pos = ring_positions(torch, w, 2 * w - 1, dev)
        outs = [ops.swa_decode(q, k, v, pos, 2 * w - 1, window=None)
                for _ in range(3)]
        check(all(torch.equal(outs[0], o) for o in outs[1:]),
              f"swa_decode B={b} W={w}: repeated launches differ")
        print(f"  swa_decode B={b:>2} W={w:>5} (nsplit "
              f"{ops.split_count(b, w, sm_count(torch))}): 3 launches, the "
              f"same bits")
    return worst


def decode_bound(b, w, hkv, g, dh) -> tuple[float, str]:
    """K and V read once, q read and out written once, pos read once;
    2 x 2 operations per (query row, slot, column) and 5 per score."""
    h = hkv * g
    nbytes = (2 * b * w * hkv * dh + 2 * b * h * dh + w) * 4
    return bound_ms(nbytes, 4 * b * h * w * dh + 5 * b * h * w)


def time_decode(torch, dev) -> dict:
    """CUDA-event times of the decode kernel, its plain version and one
    library call (scaled_dot_product_attention with the boolean mask and
    enable_gqa) on the same full rings.  Each shape gets enough distinct
    caches (at least 256 MB) that every launch reads its K and V from
    device memory, as the serving step's 26 layers do."""
    import torch.nn.functional as F
    from repro_torch.kernels.swa_decode import ops, ref

    def shape_calls(b, w, window, copies, seed):
        qpos = 2 * w - 1                      # every slot valid: a full ring
        pos = ring_positions(torch, w, qpos, dev)
        ops_ = [decode_operands(torch, dev, b, w, *GEMMA3_HEADS, seed + i)
                for i in range(copies)]
        valid = (pos >= 0) & (pos <= qpos)
        if window is not None:
            valid &= pos > qpos - window
        mask = valid[None, None, None, :]
        h = GEMMA3_HEADS[0] * GEMMA3_HEADS[1]
        kern = [lambda q=q, k=k, v=v: ops.swa_decode(q, k, v, pos, qpos, window=window)
                for q, k, v in ops_]
        plain = [lambda q=q, k=k, v=v: ref.swa_decode_ref(q, k, v, pos, qpos,
                                                          window=window)
                 for q, k, v in ops_]
        lib = [lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                   q.reshape(b, h, 1, -1), k.transpose(1, 2), v.transpose(1, 2),
                   attn_mask=mask, scale=1.0, enable_gqa=True)
               for q, k, v in ops_]
        lib_err = float((lib[0]().reshape(ops_[0][0].shape) - plain[0]()).abs().max())
        return kern, plain, lib, lib_err

    def timed(calls, reps, kernel=None):
        """Per round of ``calls``: the profiler's device time (the
        kernel's launches where ``kernel`` names it, else every device
        operation) and, beside it, CUDA events around back-to-back
        rounds, which also count the device's wait for the host."""
        def run():
            return [c() for c in calls]
        dev_all, dev_kern, _ = device_ms(torch, run, reps, kernel)
        return (dev_kern if kernel else dev_all), cuda_ms(torch, run, reps)

    b, hkv, g, dh = 4, *GEMMA3_HEADS
    # one decode step of the gen-600 serving run near its end: 22 local
    # rings of 512 (window 512) and 4 global caches of 664, all full
    local = shape_calls(b, 512, 512, 22, 100)
    glob = shape_calls(b, 664, None, 4, 200)
    step = [x + y for x, y in zip(local[:3], glob[:3])]
    (ms, ms_ev), (plain_ms, plain_ev), (lib_ms, lib_ev) = (
        timed(step[0], 50, "swa_decode"), timed(step[1], 5), timed(step[2], 20))
    lb, _ = decode_bound(b, 512, hkv, g, dh)
    gb, by = decode_bound(b, 664, hkv, g, dh)
    b_ms = 22 * lb + 4 * gb
    print(f"  swa_decode one serving step (26 launches: 22 x B=4 W=512 window 512, "
          f"4 x B=4 W=664), device time: kernel {ms:.6f} ms, plain {plain_ms:.6f} "
          f"ms, SDPA {lib_ms:.6f} ms (max|SDPA - plain| "
          f"{max(local[3], glob[3]):.2e}), bound {b_ms:.6f} ms ({by}); kernel "
          f"at {b_ms / ms:.3f} of its bound; CUDA events over back-to-back "
          f"steps: kernel {ms_ev:.6f}, plain {plain_ev:.6f}, SDPA {lib_ev:.6f} ms")
    rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=lib_ms)
    for bb, w, window, copies, reps in DECODE_TIMING_SHAPES:
        kern, plain, lib, lib_err = shape_calls(bb, w, window, copies, w)
        (k_ms, k_ev), (p_ms, p_ev), (l_ms, l_ev) = (
            timed(kern, reps, "swa_decode"), timed(plain, max(reps // 10, 2)),
            timed(lib, reps))
        k_ms, k_ev, p_ms, p_ev, l_ms, l_ev = (
            t / copies for t in (k_ms, k_ev, p_ms, p_ev, l_ms, l_ev))
        s_ms, s_by = decode_bound(bb, w, hkv, g, dh)
        print(f"  swa_decode B={bb:>2} W={w:>5} window={window} (nsplit "
              f"{ops.split_count(bb * hkv, w, sm_count(torch))}), device time: "
              f"kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, SDPA {l_ms:.6f} ms "
              f"(max|SDPA - plain| {lib_err:.2e}), bound {s_ms:.6f} ms ({s_by}); "
              f"kernel at {s_ms / k_ms:.3f} of its bound; CUDA events: kernel "
              f"{k_ev:.6f}, plain {p_ev:.6f}, SDPA {l_ev:.6f} ms")
        del kern, plain, lib
    return rec


def serve_gemma3(torch, dev) -> dict:
    """The serving slice's main path at full width, with the launch count
    zeroed just before each serve run and read just after it."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves
    cfg = get_arch("gemma3-1b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"  {cfg.name}: {n:,} parameters on the card in "
          f"{time.perf_counter() - t0:.3f} s ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab:,}, window {cfg.attn.window})")
    check(n == zoo.param_count(cfg), f"{n} parameters, not {zoo.param_count(cfg)}")

    # self-check: teacher-forced decode (the kernel) against forward (plain
    # attention, float32 products) over 640 tokens, past the 512 window
    b, s = 2, 640
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.perf_counter()
    full, _ = T.forward(cfg, params, {"tokens": tokens})
    cache = T.init_cache(cfg, b, s, device=dev)
    err = torch.zeros((), device=dev)
    for i in range(s):
        logits, cache = T.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        err = torch.maximum(err, (logits[:, 0] - full[:, i]).abs().max())
    err = float(err)
    check(bool(torch.isfinite(full).all()), "non-finite forward logits")
    print(f"  teacher-forced decode vs forward, B={b} S={s}: max|logits| "
          f"{float(full.abs().max()):.3f}, max error {err:.3e} (tol "
          f"{SELF_CHECK_TOL:g}) in {time.perf_counter() - t0:.3f} s")
    check(err <= SELF_CHECK_TOL, f"decode differs from forward by {err}")
    del full, cache, logits

    launches, per_gen = 0, {}
    for gen in SERVE_GENS:
        rng = np.random.default_rng(0)          # the reference server's recipe
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24))
                        .astype(np.int32), max_new=gen) for i in range(8)]
        server = BatchedServer(cfg, params, 4, cache_len=64 + gen, device=dev)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        stats = server.run(reqs)
        torch.cuda.synchronize()
        n_launch = cuda_lib.LAUNCHES["swa_decode"]
        steps = stats["decode_steps"]
        print(f"  BatchedServer batch 4, cache_len {64 + gen}, 8 requests x {gen} "
              f"new tokens: {stats['tokens']} tokens in {stats['wall_s']:.3f} s, "
              f"{stats['tok_per_s']:.1f} tok/s, {steps} decode steps, "
              f"{stats['wall_s'] / steps * 1e3:.3f} ms per step; swa_decode "
              f"launches {n_launch} ({steps} x {cfg.n_layers})")
        print(f"  completions (first 8 tokens): {stats['completions']}")
        check(stats["requests"] == 8 and all(len(r.out) == gen for r in reqs),
              f"gen {gen}: incomplete completions")
        check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
              f"gen {gen}: a token outside the vocabulary")
        check(n_launch == steps * cfg.n_layers,
              f"gen {gen}: {n_launch} swa_decode launches, not {steps} x "
              f"{cfg.n_layers}")
        launches += n_launch
        per_gen[gen] = n_launch
    # where a step's time goes near the end of the last wave (rings full)
    last = max(len(r.prompt) for r in reqs[4:]) + SERVE_GENS[-1]
    profile_decode(torch, dev, cfg, params, server.cache, last, server.b,
                   "swa_decode")
    n, run_s = replay_decode_run(torch, dev, cfg, reqs, server.b, SERVE_GENS[-1])
    check(n == per_gen[SERVE_GENS[-1]],
          f"the replay made {n} launches, the serving run {per_gen[SERVE_GENS[-1]]}")
    print(f"  swa_decode over the gen-{SERVE_GENS[-1]} serving run: {n} launches "
          f"made again at their positions, {run_s:.6f} s of device time "
          f"({run_s / n * 1e6:.3f} us a launch)")
    return dict(launches=launches, run_s=run_s)


def replay_decode_run(torch, dev, cfg, reqs, batch: int, gen: int):
    """The decode kernel's device time over a serving run like the one
    just made: each wave's decode steps (positions 0 .. its longest prompt
    + gen - 1, as ``BatchedServer`` makes them) at every attention layer,
    each layer on a cache of its served shape with the ring as that step
    leaves it, under the profiler.  The time of a launch depends on the
    shapes and the ring's fill, not on the values.  Returns (launches,
    seconds)."""
    from repro_torch.kernels.swa_decode import ops
    from repro_torch.models import layers as L
    hkv, g, dh = GEMMA3_HEADS
    rng = torch.Generator(device=dev).manual_seed(5)
    layers = []
    for mixer in cfg.layer_kinds():
        spec = L.layer_spec(cfg.attn, mixer)
        kv = L.kv_cache_init(batch, 64 + gen, spec, device=dev)
        layers.append((torch.randn(kv.k.shape, device=dev, generator=rng),
                       torch.randn(kv.v.shape, device=dev, generator=rng),
                       spec.window))
    q = torch.randn(batch, hkv, g, dh, device=dev, generator=rng) * dh ** -0.5
    positions = [i for w0 in range(0, len(reqs), batch)
                 for i in range(max(len(r.prompt) for r in reqs[w0:w0 + batch])
                                + gen)]
    qp = torch.tensor(positions, device=dev)[:, None]
    rings = {}
    for w in {k.shape[1] for k, _, _ in layers}:
        latest = qp - (qp - torch.arange(w, device=dev)) % w
        rings[w] = torch.where(latest >= 0, latest, -1).to(torch.int32)

    def run():
        for i, qpos in enumerate(positions):
            for k, v, window in layers:
                ops.swa_decode(q, k, v, rings[k.shape[1]][i], qpos, window=window)

    _, kern_ms, _ = device_ms(torch, run, 1, "swa_decode")
    return len(positions) * len(layers), kern_ms / 1e3


def profile_decode(torch, dev, cfg, params, cache, pos0: int, batch: int,
                   kernel: str | None, steps: int = 5) -> None:
    """Where a decode step's time goes on a filled cache, over a few steps
    from position ``pos0``."""
    from repro_torch.models import transformer as T
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def run(k):
        for i in range(steps):
            T.decode_step(cfg, params, cache, tok, pos0 + (k + 1) * steps + i)

    run(-1)
    profile_run(torch, f"decode step at positions {pos0}..{pos0 + 3 * steps - 1}",
                run, steps, "step", kernel)


# -------------------------------------------------------------- the SSD scan

def ssd_operands(torch, dev, b, s, h, p, n, seed, init=False):
    """Mamba-shaped scan operands at the reference kernel tests' ranges:
    x [B,S,H,P], dt [B,S,H], a [H], B/C [B,S,N], D [H], init [B,H,P,N]."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, device=dev, generator=gen)
    x = torch.randn(b, s, h, p, device=dev, generator=gen)
    dt = u((b, s, h), 0.001, 0.1)
    a = -u((h,), 0.5, 4.0)
    bm = torch.randn(b, s, n, device=dev, generator=gen) * 0.3
    cm = torch.randn(b, s, n, device=dev, generator=gen) * 0.3
    d = torch.randn(h, device=dev, generator=gen)
    s0 = torch.randn(b, h, p, n, device=dev, generator=gen) if init else None
    return (x, dt, a, bm, cm, d), s0


def layer0_operands(torch, dev, cfg, params, b, s, seed):
    """The scan operands of the full-width model's first Mamba2 layer on
    random tokens: dt and A in the model's own ranges."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.tree import tree_map
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    x = params["embed"][tokens] * float(math.sqrt(cfg.d_model))
    lp = tree_map(lambda t: t[0], params["stack"])["l0"]
    return M.ssd_inputs(lp["mamba"], L.rmsnorm(lp["ln"], x), cfg.ssm)[1]


def check_ssd(torch, dev, cfg, params) -> float:
    """The SSD kernel (y and final state) against its plain chunked
    version at mamba2-780m's widths (random and layer-0 operands), a
    single chunk, a given initial state, the reduced and ragged shapes;
    and y against the sequential recurrence at S <= 1,024."""
    from repro_torch.kernels.ssd_scan import ops, ref
    h, p, n, cs = MAMBA2_SSD
    cases = []       # (label, operands, init, chunk, against the recurrence)
    for b, s in MAMBA2_PREFILLS:
        ops_, _ = ssd_operands(torch, dev, b, s, h, p, n, s + b)
        cases.append((f"mamba2 B={b} S={s}", ops_, None, cs, False))
        cases.append((f"mamba2 layer 0 B={b} S={s}",
                      layer0_operands(torch, dev, cfg, params, b, s, b), None, cs,
                      False))
    for label, (b, s, hh, pp, nn, ch), init, seq in (
            ("mamba2, S=1024", (1, 1024, h, p, n, cs), False, True),
            ("mamba2, single chunk", (2, cs, h, p, n, cs), False, True),
            ("mamba2, init_state", (2, 1024, h, p, n, cs), True, False),
            ("reduced", (2, 128, 16, 32, 16, 32), False, True),
            ("reduced, init_state", (2, 128, 16, 32, 16, 32), True, False),
            ("ragged", (1, 192, 3, 48, 100, 96), False, True),
            ("ragged, init_state", (3, 40, 5, 7, 5, 8), True, False),
            ("ragged", (3, 40, 5, 7, 5, 8), False, True)):
        ops_, s0 = ssd_operands(torch, dev, b, s, hh, pp, nn, s + pp + nn, init)
        cases.append((label, ops_, s0, ch, seq))
    # decays of hundreds per step: above the diagonal exp(cum[l] - cum[s])
    # overflows, and must not leak into y or the state
    (x, dt, a, bm, cm, d), _ = ssd_operands(torch, dev, 1, 1024, h, p, n, 99)
    cases.append(("mamba2, dt x 300 and A x 4", (x, dt * 300.0, a * 4.0, bm, cm, d),
                  None, cs, False))
    worst = 0.0
    for label, ops_, s0, ch, seq in cases:
        x = ops_[0]
        b, s, hh, pp = x.shape
        y, state = ops.ssd_apply(*ops_, chunk=ch, init_state=s0, return_state=True)
        plain_y, plain_state = ref.ssd_chunked_ref(*ops_, ch, s0)
        torch.cuda.synchronize()
        ok = all(bool(torch.isfinite(t).all()) and bool(torch.allclose(
            t, u, rtol=SSD_TOL, atol=SSD_TOL)) for t, u in
            ((y, plain_y), (state, plain_state)))
        err = max(float((y - plain_y).abs().max()),
                  float((state - plain_state).abs().max()))
        line = (f"  ssd_scan {label}: B={b} S={s} H={hh} P={pp} "
                f"N={ops_[3].shape[-1]} chunk={ch}: max|y, state - chunked| = "
                f"{err:.3e} (rtol = atol = {SSD_TOL:g}; max|y| "
                f"{float(plain_y.abs().max()):.3g})")
        worst = max(worst, err)
        if seq:
            xf, dt, a, bm, cm, d = ops_
            rec = ref.ssd_scan_ref(
                xf.permute(0, 2, 1, 3).reshape(b * hh, s, pp),
                dt.permute(0, 2, 1).reshape(b * hh, s), a.repeat(b),
                bm.repeat_interleave(hh, dim=0), cm.repeat_interleave(hh, dim=0),
                d.repeat(b)).reshape(b, hh, s, pp).permute(0, 2, 1, 3)
            seq_err = float((y - rec).abs().max())
            ok = ok and bool(torch.allclose(y, rec, rtol=SSD_SEQ_TOL,
                                            atol=SSD_SEQ_TOL))
            line += (f"; max|y - recurrence| = {seq_err:.3e} (rtol = atol = "
                     f"{SSD_SEQ_TOL:g})")
            worst = max(worst, seq_err)
        print(line)
        check(ok, f"ssd_scan {label}: beyond tolerance ({err})")
        del y, state, plain_y, plain_state
    # the same bits from launch to launch, at the first prefill's shape
    ops_ = cases[0][1]
    runs = [ops.ssd_apply(*ops_, chunk=cs, return_state=True) for _ in range(3)]
    check(all(torch.equal(y, runs[0][0]) and torch.equal(st, runs[0][1])
              for y, st in runs[1:]), "ssd_scan: repeated launches differ")
    print(f"  ssd_scan {cases[0][0]}: 3 launches, the same bits")
    return worst


def ssd_work(b, s, h, p, n, cs) -> tuple[float, float, float]:
    """The least work of one scan, (operations of the products, the other
    operations, bytes): C.B^T once per (batch row, chunk) and the products
    over the causal triangle only (s <= l); x, B, C, dt, a, D read once, y
    and the final state written once.  Each multiply-add counts two
    operations, as do the elementwise steps (exp as one)."""
    tri = cs * (cs + 1) // 2
    products = 2 * tri * n + h * (      # C.B^T; then per head:
        2 * tri * p                     # the intra product
        + 2 * cs * p * n                # the inter product
        + 2 * cs * p * n)               # the state update
    other = h * (4 * tri                # L: diff, exp, two products
                 + cs * p + p * n       # the inter term's and the state's decay
                 + 3 * cs * p + 5 * cs)  # D x and the sums; cumsum and weights
    nc = b * (s // cs)
    nbytes = 4 * (2 * b * s * h * p + 2 * b * s * n + b * s * h + 2 * h
                  + b * h * p * n)
    return nc * products, nc * other, nbytes


def ssd_bound(b, s, h, p, n, cs) -> tuple[float, str, float]:
    """(bound, what bounds it, the float32-only bound): the kernel's
    products run on the tensor cores in 3xTF32, three TF32 products for
    each float32 one, and the rest in float32 on the CUDA cores.  The
    float32-only bound prices every operation at the CUDA cores' rate, as
    the bound of the first, SIMT design did."""
    products, other, nbytes = ssd_work(b, s, h, p, n, cs)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / (TF32_OPS_PER_S / 3) + other / FP32_OPS_PER_S
    fp32_ms = bound_ms(nbytes, products + other)[0]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", fp32_ms)


def time_ssd(torch, dev) -> tuple[dict, list]:
    """CUDA-event times of the SSD kernel (its four passes' device time
    apart, from the profiler) and its plain chunked version per launch at
    both prefill shapes.  Returns the record, which holds B = 1, S = 32,768
    (prefill_32k's row), and the kernel's ms at each prefill shape.  No
    single PyTorch call computes the scan."""
    from repro_torch.kernels.ssd_scan import ops, ref
    h, p, n, cs = MAMBA2_SSD
    rec, per_shape = None, []
    for b, s in MAMBA2_PREFILLS:
        ops_, _ = ssd_operands(torch, dev, b, s, h, p, n, 7 * s + b)
        ms = cuda_ms(torch, lambda: ops.ssd_apply(*ops_, chunk=cs), 10)
        _, dev_ms, passes = device_ms(
            torch, lambda: ops.ssd_apply(*ops_, chunk=cs), 3, "ssd_scan")
        plain_ms = cuda_ms(torch, lambda: ref.ssd_chunked_ref(*ops_, cs), 3)
        b_ms, b_by, fp32_ms = ssd_bound(b, s, h, p, n, cs)
        print(f"  ssd_scan B={b} S={s} (H={h} P={p} N={n} chunk={cs}): kernel "
              f"{ms:.6f} ms, plain {plain_ms:.6f} ms, library none, bound "
              f"{b_ms:.6f} ms ({b_by}: products at 495 / 3 TFLOP/s, the "
              f"rest at 67); kernel at {b_ms / ms:.3f} of its bound and "
              f"{fp32_ms / ms:.3f} of its float32-only bound ({fp32_ms:.6f} "
              f"ms, every operation at 67 TFLOP/s)")
        print(f"    its passes by the profiler ({dev_ms:.6f} ms of device time "
              f"a scan, by kernel function):")
        for name, t in passes.items():
            print(f"    {t:10.6f} ms  {t / dev_ms:.3f}  {name[:90]}")
        per_shape.append(ms)
        if rec is None:
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
        del ops_
    return rec, per_shape


def init_mamba2(torch, dev):
    """mamba2-780m at full width from a seeded generator: (cfg, params)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("mamba2-780m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return cfg, params


def profile_prefill(torch, prefill, params, tokens) -> None:
    """Where one (warm) prefill's time goes."""
    b, s = tokens.shape
    profile_run(torch, f"profiled prefill B={b} S={s}",
                lambda _k: prefill(params, {"tokens": tokens}), 1, "prefill",
                "ssd_scan")


def run_mamba2(torch, dev, cfg, params) -> dict:
    """The Mamba2 slice's main path at full width, with the launch count
    zeroed just before each prefill and read just after it; then decode
    against forward and the server."""
    import numpy as np
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"  {cfg.name}: {n:,} parameters on the card ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} heads of "
          f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk {cfg.ssm.chunk}, "
          f"vocab {cfg.vocab:,} padded to {T.padded_vocab(cfg):,})")
    check(n == zoo.param_count(cfg), f"{n} parameters, not {zoo.param_count(cfg)}")
    prefill = make_prefill_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    prefill(params, {"tokens": torch.zeros((1, cfg.ssm.chunk), dtype=torch.long,
                                           device=dev)})     # warm-up
    launches = 0
    for b, s in MAMBA2_PREFILLS:
        tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = cuda_lib.LAUNCHES["ssd_scan"]
        print(f"  prefill B={b} S={s}: {wall:.3f} s wall, {b * s / wall:,.0f} "
              f"tokens/s, ssd_scan launches {n_launch} ({cfg.n_layers} layers); "
              f"logits {tuple(logits.shape)}, max|logits| "
              f"{float(logits.abs().max()):.3f}")
        check(tuple(logits.shape) == (b, s, T.padded_vocab(cfg)),
              f"prefill logits of shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
        check(n_launch == cfg.n_layers,
              f"prefill B={b} S={s}: {n_launch} ssd_scan launches, not "
              f"{cfg.n_layers}")
        launches += n_launch
        del logits
    profile_prefill(torch, prefill, params,
                    torch.randint(0, cfg.vocab, MAMBA2_PREFILLS[0], device=dev,
                                  generator=gen))

    # teacher-forced decode (the recurrence, no kernel) against forward (the
    # kernel) over two chunks
    b, s = MAMBA2_SELF_CHECK
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
    t0 = time.perf_counter()
    full = prefill(params, {"tokens": tokens})
    cache = T.init_cache(cfg, b, s, device=dev)
    before = cuda_lib.LAUNCHES["ssd_scan"]
    err = torch.zeros((), device=dev)
    for i in range(s):
        logits, cache = T.decode_step(cfg, params, cache, tokens[:, i:i + 1], i)
        err = torch.maximum(err, (logits[:, 0, :cfg.vocab]
                                  - full[:, i, :cfg.vocab]).abs().max())
    err = float(err)
    print(f"  teacher-forced decode vs forward, B={b} S={s}: max|logits| "
          f"{float(full[..., :cfg.vocab].abs().max()):.3f}, max error {err:.3e} "
          f"(tol {SELF_CHECK_TOL:g}) in {time.perf_counter() - t0:.3f} s")
    check(cuda_lib.LAUNCHES["ssd_scan"] == before, "decode launched the scan")
    check(err <= SELF_CHECK_TOL, f"decode differs from forward by {err}")
    del full, cache, logits

    gen_len = SERVE_GENS[0]
    rng = np.random.default_rng(0)              # the reference server's recipe
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24))
                    .astype(np.int32), max_new=gen_len) for i in range(8)]
    server = BatchedServer(cfg, params, 4, cache_len=64 + gen_len, device=dev)
    stats = server.run(reqs)
    steps = stats["decode_steps"]
    print(f"  BatchedServer batch 4, 8 requests x {gen_len} new tokens: "
          f"{stats['tokens']} tokens in {stats['wall_s']:.3f} s, "
          f"{stats['tok_per_s']:.1f} tok/s, {steps} decode steps, "
          f"{stats['wall_s'] / steps * 1e3:.3f} ms per step")
    print(f"  completions (first 8 tokens): {stats['completions']}")
    check(stats["requests"] == 8 and all(len(r.out) == gen_len for r in reqs),
          "mamba2: incomplete completions")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "mamba2: a token outside the vocabulary")
    last = max(len(r.prompt) for r in reqs[4:]) + gen_len
    profile_decode(torch, dev, cfg, params, server.cache, last, server.b, None)
    return dict(launches=launches)


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

    def at() -> str:
        return f" (at {time.perf_counter() - t_start:.1f} s)"
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
        elif "entry function" in line:      # the kernel the next lines describe
            name = re.search(r"[a-z][a-z_]*_kernel(ILi\d+ELi\d+E)?", line)
            print("  " + (re.sub(r"ILi(\d+)ELi(\d+)E", r"<\1, \2>", name.group(0))
                          if name else line.strip()))
    dynamic_smem(cuda_lib.CSRC / "ssd_scan.cu")
    sass = solve_sass(torch, lib)

    print("[2] kernels against their plain versions" + at(), flush=True)
    errs = check_solvers(torch, dev)
    errs["masked_aggregate"] = check_aggregate(torch, dev)
    errs["quantized_masked_aggregate"] = check_quantized(torch, dev)
    errs["swa_decode"] = check_decode(torch, dev)
    mamba2 = init_mamba2(torch, dev)
    errs["ssd_scan"] = check_ssd(torch, dev, *mamba2)

    print("[3] times (CUDA events)" + at(), flush=True)
    rec = time_kernels(torch, dev, sass)
    rec["swa_decode"] = time_decode(torch, dev)
    rec["ssd_scan"], ssd_ms = time_ssd(torch, dev)
    time_round_parts(torch, dev)
    profile_sweep(torch, dev, "grid", grid_plans(dev, 5), "masked_aggregate")
    plans, _, cfgs, trains, tests, _ = quantized_plans(torch, dev, 5, 5)
    profile_sweep(torch, dev, "quantised", (plans, cfgs, trains, tests),
                  "quantized_masked_aggregate")
    del plans

    print("[4] the slice: run_grid over both scenarios" + at(), flush=True)
    out = run_slice(torch, dev, args.rounds, args.eval_every)
    check_slice(torch, dev, out)

    print("[5] the quantised uplink: one sweep over both scenarios x three "
          "schemes" + at(), flush=True)
    qout = run_quantized(torch, dev, args.rounds, args.eval_every)
    check_quantized_loop(torch, dev)
    out["launches"]["quantized_masked_aggregate"] = \
        qout["launches"]["quantized_masked_aggregate"]

    print("[6] serving gemma3-1b at full width" + at(), flush=True)
    served = serve_gemma3(torch, dev)
    out["launches"]["swa_decode"] = served["launches"]

    print("[7] mamba2-780m at full width: prefill and serving" + at(), flush=True)
    out["launches"]["ssd_scan"] = run_mamba2(torch, dev, *mamba2)["launches"]
    del mamba2
    per_prefill = out["launches"]["ssd_scan"] // len(MAMBA2_PREFILLS)
    ssd_s = per_prefill * sum(ssd_ms) / 1e3
    print(f"  the two kernels on their main paths: ssd_scan over the two "
          f"prefills {per_prefill} x ({ssd_ms[0]:.6f} + {ssd_ms[1]:.6f}) ms = "
          f"{ssd_s:.6f} s; swa_decode over the gen-{SERVE_GENS[-1]} serving run "
          f"{served['run_s']:.6f} s")

    print("[8] the batched fleet solve: ensembles, mega fleets" + at(),
          flush=True)
    batched = run_batched(torch, dev)
    time_batched(torch, dev, batched.pop("batches"), sass)

    sources = {"fused_solve": ("src/repro_torch/csrc/selection_solve.cu",
                               "src/repro/kernels/selection_solve/kernel.py:143"),
               "selection_solve": ("src/repro_torch/csrc/selection_solve.cu",
                                   "src/repro/kernels/selection_solve/kernel.py:83"),
               "masked_aggregate": ("src/repro_torch/csrc/masked_aggregate.cu",
                                    "src/repro/kernels/masked_aggregate/kernel.py:91"),
               "quantized_masked_aggregate": (
                   "src/repro_torch/csrc/masked_aggregate.cu",
                   "src/repro/kernels/masked_aggregate/kernel.py:58"),
               "swa_decode": ("src/repro_torch/csrc/swa_decode.cu",
                              "src/repro/kernels/swa_decode/kernel.py:75"),
               "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan/kernel.py:82")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=out["launches"][name], max_abs_err=errs[name],
                    **rec[name])
               for name, (src, rep) in sources.items()]
    print(f"[9] done in {time.perf_counter() - t_start:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
