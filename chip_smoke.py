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
   slices' shapes and at ragged ones, within the stated tolerance (the
   solve kernels bit for bit, also on adversarial elements and a padded
   mixed batch; the decode attention also with gemma2's softcap at its
   heads and at llama4-scout's odd group (G = 5), and without a softcap
   bit for bit the outputs recorded before it took one; the SSD scan's forward bit for bit the outputs recorded
   before its backward came);
3. time each kernel with CUDA events (the solve kernels as device time
   with their launches queued behind a spin kernel, beside the bound on
   the steps their function needs on these inputs; the decode attention, whose
   launches are shorter than the host's cost of making them, and the SSD
   scan's passes by the profiler's device time; the quantised sum's two
   kernels as device time with their launches queued behind a spin
   kernel; the decode attention with gemma2's softcap beside the same
   launches without it, and at llama4-scout's heads; the SSD scan's backward, its six passes apart,
   as device time queued behind a spin kernel at the training batch and
   at 32,768 tokens) beside its bound, its
   plain version and (for the plain aggregate, the quantised sum's scale
   pass and the decode attention) one PyTorch library call, and profile
   a few rounds of each sweep; the quantised sum with every row live is
   its worst case;
4. drive the first slice: ``run_grid`` over both paper scenarios and all
   four strategies at N = 100 devices with the 199,213-parameter CNN, the
   fused-kernel solve and the kernel aggregate, plus one exact
   (``solve_joint_kernel``) solve per scenario; every kernel must launch,
   and the outputs are checked against the port's plain paths;
5. drive the quantised-uplink slice: one sweep of 18 trajectories (both
   scenarios x three uplink schemes x three seeds: the joint bit
   allocation over (8, 16, 32), a fixed 8-bit and a fixed 4-bit uplink)
   whose every round's server sum is the scale kernel and the quantised
   kernel (8 launches of each a round), hold one round's own operands
   against the plain versions and time the two kernels on them beside
   the function's bound, and hold the loop engine against the sweep at 8
   bits on the card;
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
   (E = 1,000,000) through both kernel methods, every instance feasible;
   each kernel timed on each batch (device time, ``queued_ms``) beside
   the steps its function needs there (``needed_steps``: mean, max, the
   mean of each warp's largest), the bound on them (``element_work``)
   and on the fixed trip count, and phase [1]'s count of the compiled
   loop on the warps' counts; a time below its bound fails;
9. drive the fleet control plane (``repro_torch.serve``) at the
   reference demos' sizes: ``serve_demo``'s closed-loop stream (8
   drifting_metro cells of 64 devices, 8 rounds, Dinkelbach) warm against
   cold, whose warm inner iterations must stay below cold's; the open
   loop (warmup, measured capacity, a seeded Poisson trace of 120
   requests at 0.7 of it); the same trace on a virtual clock on the card
   and on the CPU, whose batch logs must be equal and answers within
   1e-5; ``metro_coupled`` (16 x 64, the backhaul budget) and
   ``interference_grid`` (16 x 32) through ``solve_coupled``, cold and
   warm from ``resume``, and zero coupling bit for bit the uncoupled
   solve; 16 ``dense_1k`` cells in bucket 1,024; and a chaos drive over
   every fault kind with no non-finite answer.  No kernel lies on this
   path;
10. drive the drift-aware closed loop (``repro_torch.fl.closed_loop``) at
   drifting_metro's registered size (N = 100, K = 20, coherence 0.9): all
   six strategies over one seed (cut from two for time) with the paper's
   CNN, the joint-bits sweep's every server sum through the quantised
   kernel; the card
   against the port's own CPU run (control trace 1e-5, iteration counts
   equal, every strategy's accounting 1e-5 relative); one profiled round
   of the quantised sweep; the same grid under a fault plan, its control
   pass crashed after round 9 and resumed on a fresh service bit for bit;
   the scale and quantised kernels on that faulted sweep's own operands of
   one round;
   and the entry points ``closed_loop_demo``, ``fading_rounds``,
   ``quickstart`` and ``compression_study`` on the card;
11. drive the training slice (``repro_torch.launch.train``): kernel 6
   under autograd must raise (it has no backward); the driver at
   demo-100m's full width (116,411,136 parameters) on the card
   against its own CPU run (B = 2, S = 64, 3 steps, the same parameters
   and draws: loss 1e-5, grad_norm 1e-4, parameters within the steps'
   learning rates); the driver at its defaults for 100 steps (cut from
   300), resumed from its step-50 checkpoint bit for bit under
   deterministic algorithms, with its step time, tokens/s and a profiled
   idle share; gemma3-1b at full width, 2 steps at B = 16, S = 256, each
   step's loss equal to ``lm_loss`` without autograd to 1e-5, and the peak
   device memory (no kernel lies on these paths); then mamba2: (d1) the
   SSD scan's backward kernel against its plain backward at mamba2-780m's
   widths (random and layer-0 operands at B = 4, S = 2,048 and B = 1,
   S = 32,768, an initial state and the final state's cotangent, the
   stress decays, reduced and ragged shapes), bitwise equal from call to
   call; (d2) mamba2-780m at full width cut to 4 of its 48 layers, 3
   steps at B = 2, S = 512 on the card against its own CPU run (random
   loss weights; parameters within the most two AdamW runs can part);
   (d3) the driver at mamba2-780m's full width and depth, 20 rounds at
   B = 4, S = 2,048 under deterministic algorithms, every train step
   launching kernel 5 96 times and its backward 48 times, with its step
   time, tokens/s, peak memory, a profiled idle share and kernel 5's
   device time a step; then the driver's resume at (d2)'s 4-layer cut and
   (d3)'s batch and rounds, from its round-10 checkpoint, bit for bit
   under deterministic algorithms (at full depth each of its checkpoints
   takes 9.4 GB); (d4) zamba2-7b reduced to 13 layers, a step on the
   card against the CPU;
12. the analysis gate (``repro_torch.analysis``) on the card: the
   rank-contract sweep (486 combinations, every round column bitwise the
   column-sliced rank-1 problem's) with no finding, and each of the five
   registered hot paths (``solve_joint_fused``, ``solve_joint_batch``,
   ``fleet_service_step``, ``scan_engine_sweep``,
   ``scan_engine_strategies``) with its launch counts zeroed just before
   it: no build and no load of the kernel library in its steady call,
   its host reads and its waits for the card within their forms
   (``analysis/budgets.json``), kernel 3 launched in both sweep paths'
   steady calls, and one line each with the counts, the units and the
   steady call's wall time (median of 5);
13. drive the remaining attention archs' serving path at full width,
   one after the other, each's weights from a seeded generator and freed
   before the next's: h2o-danube-3-4b (3,838,959,360 parameters),
   phi3-medium-14b (14,145,704,960), gemma2-27b cut to 24 of its 46
   layers (14,769,418,752; its 108.9 GB of float32 weights do not fit
   the card) and zamba2-7b (8,640,318,160, its 13 shared-block layers'
   unread MLPs included); each count against ``zoo.param_count``,
   teacher-forced decode (``make_serve_step``) against forward
   (``make_prefill_step``) at B = 2, S = 512 within 1e-3,
   ``BatchedServer(batch=4)`` on 8 requests x 24 new tokens with kernel 6
   launched exactly steps x attention layers (24, 40, 24, 13) times, a
   profiled decode step and the peak device memory; zamba2 also prefills
   at B = 1, S = 4,096 with exactly 81 ``ssd_scan`` launches; then the
   two MoE archs: deepseek-v2-lite-16b at full width and depth
   (15,496,769,024 parameters, 2,451,435,008 active; MLA, which launches
   no kernel, and 64 experts top-6) and llama4-scout-17b-a16e cut to one
   4-layer period of its 48 (9,843,880,960; 16 experts top-1; kernel 6 at
   G = 5 on its four attention layers), each with its active-parameter
   count, a prefill at B = 1, S = 4,096, the self-check at capacity factor
   E / k (no token dropped, so forward routes as decode does) compared up
   to each row's first route flip, every flip's margin under 1e-5 and at
   least three quarters of the positions compared, the dropped share of
   a forward at the arch's own capacity factor 1.25, the served decode
   step beside the bound of reading its weights;
14. print the kernel record, the card, and the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero without a CUDA device and
when run outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
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
# Kernels 1-2's bound: the work their function needs on these inputs
# (csrc/solve_common.cuh as written, each element's steps up to the first
# that leaves its state unchanged: ``needed_steps``), whatever code the
# compiler makes of it, in thread-level
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
# kernel 1's (n_iters, faithful_eq13_typo) held against its plain version
FUSED_VARIANTS = ((50, False), (50, True), (7, False), (7, True), (2, False),
                  (1, True))
# quantised sum per element: a true division, floor, subtraction,
# comparison, select, addition, max, min, two multiplies and an addition
QUANT_OPS = 11
SOLVE_TOL = 1e-5        # a* and P*: the reference's solver tolerance
# kernels 1-2 against their plain versions: bit for bit (bit_err)
AGG_TOL = 1e-5          # eq.-4 sum of O(1) values, same order of addition
QUANT_TOL = 0.0         # the quantised sum: same arithmetic, same order
DECODE_TOL = 2e-5       # decode attention: the reference's float32 tolerance
# the SSD scan: the reference's tolerances for its kernel against the
# sequential recurrence and for its wrapper against the chunked form
SSD_SEQ_TOL = 1e-4
SSD_TOL = 2e-4
# its backward against the plain backward on the same forward scratch: each
# gradient's max|kernel - plain| over its max|plain|, the forward's 2e-4
# (products in 3xTF32 and sums in another order, about 1e-6 apart).  Under
# the stress decays (dt x 300, A x 4) a's gradient sums dt (up to 30) times
# a reverse cumsum over the chunk in which terms up to the chunk's whole
# intra sum cancel: float32 rounding alone puts the plain version 1.7e-4 to
# 4.6e-4 of its max-norm from float64 there (CPU), so 2e-3 for it
SSD_BWD_TOL = 2e-4
SSD_BWD_STRESS_DA_TOL = 2e-3
SSD_GRADS = ("dx", "ddt", "da", "dB", "dC", "dD", "d_init")
# kernel 5's forward bit for bit as it was before its backward came: (B, S,
# H, P, N, chunk, init) of numpy-made operands (``ssd_digests``), and the
# first 16 hex digits of the SHA-256 of y's and the final state's bytes,
# as the kernels built from the tree before the backward gave them on an
# H100 (CUDA 12.8, torch 2.11)
SSD_DIGEST_CASES = ((1, 1024, 48, 64, 128, 256, True),
                    (2, 128, 16, 32, 16, 32, False),
                    (3, 40, 5, 7, 5, 8, True),
                    (1, 192, 3, 48, 100, 96, False))
SSD_DIGESTS = ("712db070cb8b4a68", "6d4d82f4a723d956", "5397dbadc82db638",
               "84f568af2787ee27")
SELF_CHECK_TOL = 1e-3   # full-width decode logits against forward's
# gemma3-1b's attention: MQA, one KV head for G = 4 query heads of 256
GEMMA3_HEADS = (1, 4, 256)
# gemma2-27b's: 16 KV heads for G = 2 query heads each, dh 128, window 4096
# on the local layers, and its attention-logit softcap
GEMMA2_HEADS = (16, 2, 128)
GEMMA2_WINDOW = 4096
GEMMA2_SOFTCAP = 50.0
# llama4-scout's: 8 KV heads for G = 5 query heads each (an odd group, which
# the kernel's MAXG = 8 instance runs), dh 128, window 8,192 on the local
# layers
LLAMA4_HEADS = (8, 5, 128)
LLAMA4_WINDOW = 8192
# kernel 6 without a softcap, bit for bit as it was before it took one:
# (B, W, Hkv, G, dh, window, qpos, nsplit) of numpy-made operands
# (``decode_digests``), and the first 16 hex digits of the SHA-256 of the
# output bytes, as the kernel built from the tree without the softcap gave
# them on an H100 (CUDA 12.8, torch 2.11)
DIGEST_CASES = ((4, 664, 1, 4, 256, None, 1327, 21),
                (2, 97, 2, 3, 30, None, 200, 3),
                (2, 4100, 16, 2, 128, 4096, 9000, 7),
                (2, 200, 32, 1, 112, None, 120, 1),
                (2, 88, 8, 4, 120, 64, 150, 3))
DECODE_DIGESTS = ("e2ffc9a2d616b7ff", "5225d919b9febb93", "4362ac52e0ddf2cf",
                  "39be377c2690a2c2", "99130235968891eb")
SERVE_GENS = (24, 600)  # the reference server's default, and past the window
# mamba2-780m's scan: 48 heads of P = 64, d_state 128, chunk 256; the
# prefills (B, S): prefill_32k's length with its batch cut from 32 (whose
# float32 logits alone would be 211 GB), and a batch of 4 at 4,096
MAMBA2_SSD = (48, 64, 128, 256)
MAMBA2_PREFILLS = ((1, 32768), (4, 4096))
MAMBA2_SELF_CHECK = (2, 512)        # teacher-forced decode: 2 chunks
# the backward's shapes (B, S): the training run's batch, and prefill_32k's
# length
MAMBA2_BWD = ((4, 2048), (1, 32768))
# phase [13]: the remaining archs at full width, one after the other;
# gemma2-27b cut to 24 of its 46 layers (12 local/global pairs), since its
# 108.9 GB of float32 weights do not fit the card's 80 GB, and
# llama4-scout-17b-a16e to one 4-layer period of its 48 (426.9 GB whole;
# 8 layers would take 74.6 GB)
ARCH_RUNS = (("h2o-danube-3-4b", None), ("phi3-medium-14b", None),
             ("gemma2-27b", 24), ("zamba2-7b", None),
             ("deepseek-v2-lite-16b", None), ("llama4-scout-17b-a16e", 4))
ARCH_SELF_CHECK = (2, 512)   # teacher-forced decode (B, S): 2 of zamba2's chunks
ARCH_PREFILL = (1, 4096)     # zamba2's and the MoE archs' timed prefill
# the MoE self-check: a route flip between forward and decode (the k-th and
# (k+1)-th router probabilities of a token within rounding) must have a
# margin under this, and at least this share of positions be compared
FLIP_MARGIN = 1e-5
COMPARED_SHARE = 0.75
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
# phase [10]: the closed loop at drifting_metro's registered size
CLOSED_LOOP = dict(n_devices=100, n_rounds=20, coherence=0.9)
# one seed, cut from the issue's two: at two the port's CPU run of the
# same grid alone took 68.8 s on the chip machine's host (PERF.md, PR 23)
CLOSED_LOOP_SEEDS = 1
CLOSED_LOOP_FAULTS = dict(seed=3, device_rate=0.25, drop_rate=0.3)
CLOSED_LOOP_CRASH = 10      # the control pass raises after round 9 (index)
CLOSED_LOOP_TOL = 1e-5      # card against CPU: the solver tolerance
CLOSED_LOOP_GATED = ("expected_participants", "mean_participants", "mean_bits",
                     "total_energy_j", "completion_time_s")
CLOSED_LOOP_OPERANDS_ROUND = 10    # the round whose kernel-4 operands are held
QUANT_OPERANDS_ROUND = 10          # the quantised sweep's round held in [5]
# phase [11]: training.  (a) the driver on the card against its own CPU run
# at demo-100m's full width, cut to B = 2, S = 64 and 3 steps for the CPU's
# sake; (b) the driver at its defaults (B = 16, S = 256, 64 clients,
# tau 2.0), cut from 300 steps to 100 for the phase's time, resumed from
# its step-50 checkpoint; profiled over 5 steps; (c) gemma3-1b at full
# width, 2 steps at B = 16, S = 256
TRAIN_CARD_CPU = ["--arch", "demo-100m", "--steps", "3", "--batch", "2",
                  "--seq", "64", "--log-every", "1"]
TRAIN_STEPS, TRAIN_DEFAULT_STEPS, TRAIN_CKPT = 100, 300, 50
TRAIN_TIMED_FROM = 10          # the step time's median over steps 10-100
TRAIN_FREE_STEPS = 20          # steps timed without deterministic algorithms
TRAIN_PROFILED = 5
GEMMA3_TRAIN = (16, 256, 2)    # B, S, steps
# (d) mamba2 training through kernel 5 and its backward: (d2) mamba2-780m
# at full width cut to 4 of its 48 layers for the CPU's sake, card against
# CPU; (d3) the driver at full width and depth, B = 4, S = 2,048, 20
# rounds; its resume, checkpointed at round 10, at (d2)'s 4-layer cut (a
# checkpoint of the full depth's parameters and moments takes 9.4 GB, and
# three writes and a read of it took about 60 s on the H100); (d4) zamba2-7b
# reduced to 13 layers (two stacked units of five Mamba2 mixers and the
# shared block, and a tail)
MAMBA2_CARD_CPU = (4, 2, 512, 3)       # layers, B, S, steps
MAMBA2_TRAIN = ["--arch", "mamba2-780m", "--batch", "4", "--seq", "2048",
                "--steps", "20", "--log-every", "1"]
MAMBA2_TRAIN_CKPT = 10
# mamba2-780m's 3.1 GB gradient payload leaves E[participants] at 0.56 of
# the driver's 64 clients, so about 2 rounds in 5 train (8 of 20 on the
# H100); the step time is the median over the trained steps from
# the third on
MAMBA2_TIMED_FROM = 3
MAMBA2_PROFILED = 2
ZAMBA2_TRAIN = (13, 2, 64, 1)          # layers, B, S, steps
# the CPU tests' tolerances (tests/test_torch_train.py): the loss 1e-5
# relative; grad_norm 1e-4 (it sums the squares of gradients rounded to
# bfloat16 on their way back through cast_bf16, where float32 sums in
# another order flip a rounding now and then); after k steps every
# parameter within k learning rates (a flipped gradient takes another
# AdamW step, at most about lr) and all but 1e-3 of them within 1e-5.
# The mamba2 and zamba2 checks (train_against_cpu) hold each parameter
# instead within the most two AdamW runs from one start can part
# (adam_apart_bound, about 2 lr a step): where a gradient lies near eps,
# its float32 rounding alone can move the parameter by up to lr one way
# on one device and about 0 on the other, so k lr is reached by
# construction (zamba2's one step read 0.99 of it on the H100); the share
# beyond 1e-5 is the check that bites
TRAIN_LR = 3e-4
ADAM_BETAS = (0.9, 0.999)              # make_train_step's AdamW
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
TRAIN_PARAM_ATOL = 1e-5
TRAIN_PARAM_SHARE = 1e-3
# phase [12]: kernel 3's launches in each sweep path's steady call, one a
# parameter leaf a round for all trajectories together, over 3 rounds
# (scan_engine_strategies runs two sweeps); steady calls timed
ANALYSIS_KERNEL3 = {"scan_engine_sweep": 8 * 3, "scan_engine_strategies": 8 * 3 * 2}
ANALYSIS_REPS = 5


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
    the host makes the next launch.  The profiler can leave launches at
    the start of a profile unrecorded, which reads short: a profile that
    recorded no device time, or a count of ``kernel``'s launches that is
    not a multiple of ``reps``, is taken again, up to twice, and a line
    marks the third profile's numbers if they are still short.  The
    kernel records of the quantised sum use ``queued_ms`` instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    pat = kernel_re(kernel) if kernel else None
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events)
        mine = [e for e in events if pat and pat.search(e.key)]
        counts = [e.count for e in mine]
        if total > 0 and all(c % reps == 0 for c in counts):
            break
        print(f"  device_ms: profile {attempt + 1} recorded {sum(counts)} "
              f"launches of {kernel}, not a multiple of {reps} calls; "
              + ("taken again" if attempt < 2 else "its short numbers used"))
    check(total > 0, "the profiler recorded no device time")
    by_name = {e.key: e.self_device_time_total / 1e3 / reps for e in mine}
    return total / 1e3 / reps, sum(by_name.values()), by_name


def queued_ms(torch, fn, reps: int) -> float:
    """Device time of ``fn`` per call, by CUDA events around ``reps``
    calls that the host queues while a spin kernel holds the device: the
    calls then run back to back, so the time counts no wait for the host
    (as ``cuda_ms`` does) and loses no launch (as the profiler can).  The
    spin is lengthened until it outlasts the host's queueing; a ``fn``
    that waits for the device never satisfies that, and fails."""
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(5):
        hold, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        t0 = time.perf_counter()
        hold.record()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_ms_host = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if hold.elapsed_time(start) > 1.5 * queued_ms_host:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail(f"the host took {queued_ms_host:.3f} ms to queue {reps} calls, "
         f"longer than a {hold.elapsed_time(start):.3f} ms spin")


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
    the work the function needs (``element_work``).  A branch out of the
    body (an element's exit once its state stops changing) ends no step."""
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
            paths = [r for r in (walk(j, seen) for j in nexts
                                 if head <= j <= end) if r is not None]
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
        (i0, m0), (i1, m1) = element_work(name, 0), element_work(name, 1)
        print(f"  {name}: the work its function needs, {i0} FP32/ALU and "
              f"{m0} MUFU instructions an element, and {i1 - i0} and "
              f"{m1 - m0} a step it needs (at most {steps}; element_work)")
    return out


def element_work(name: str, steps: int) -> tuple[int, int]:
    """(FP32/ALU, MUFU) instructions one element of kernel 1 or 2 needs,
    ``steps`` being the steps it needs (``needed_steps``).

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


def solve_bound_ms(name: str, n: int, steps: int) -> tuple[float, str]:
    """Kernel 1 or 2's least time for ``n`` elements that need ``steps``
    steps in all: the work its function needs (``element_work`` is linear
    in the steps) at the FP32/ALU pipes' rate or at the MUFU pipe's, or its
    bytes (4 inputs read, 2 outputs written) at the memory's rate,
    whichever is larger; and which of the three it is."""
    (i0, m0), (i1, m1) = element_work(name, 0), element_work(name, 1)
    instr, mufu = n * i0 + steps * (i1 - i0), n * m0 + steps * (m1 - m0)
    t, by = max((instr / FP32_INSTR_PER_S, "FP32 issue"),
                (mufu / MUFU_PER_S, "MUFU"),
                (6 * 4 * n / HBM_BYTES_PER_S, "bytes"))
    return t * 1e3, by


def sass_issue_ms(sass: dict, name: str, warp_steps: int) -> float:
    """The compiled loop's steps (phase [1]'s SASS) at the SM's issue rate
    and MUFU rate, ``warp_steps`` warp-steps in all (a warp runs until its
    slowest lane stops): what this build would take if it issued every
    cycle, a diagnostic beside ``solve_bound_ms``, not a bound on the
    function."""
    step, warps = sass[name], warp_steps
    per_sm_clock = sass["sms"] * sass["clock_hz"]
    t_issue = warps * step["instructions"] / (ISSUE_PER_CLOCK * per_sm_clock)
    t_mufu = warps * step["mufu"] * 32 / (MUFU_LANES_PER_CLOCK * per_sm_clock)
    return max(t_issue, t_mufu) * 1e3


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def needed_steps(torch, name: str, els, kw):
    """Each element's steps that kernel 1 or 2's function needs on these
    operands (at the wrappers' defaults), counted by its plain version run
    step by step: up to the first step that leaves the loop's state (the
    fused fixed point's a; the bisection's lo and hi) bitwise unchanged,
    after which every step repeats it, or the fixed trip count; no
    bisection step where a = 1 is feasible (the reference discards its
    lo)."""
    from repro_torch.core.alternating import (FleetElements, _fused_step,
                                              fused_init)
    from repro_torch.kernels.selection_solve.ref import _feasible

    def bits(x):
        return x.view(torch.int32)
    pg = els[0]
    steps = torch.zeros(pg.shape, dtype=torch.int64, device=pg.device)
    if name == "fused_solve":
        el = FleetElements(*els)
        kw = dict(kw, faithful_eq13_typo=False)
        a, _ = fused_init(el, **kw)
        live = torch.ones_like(pg, dtype=torch.bool)
        for _ in range(SOLVE_STEPS[name]):
            new, _, _ = _fused_step(a, el=el, power_solver="analytic", **kw)
            steps += live
            live &= bits(new) != bits(a)
            a = new
        return steps
    args = (*els, kw["s_bits"], kw["tau"], kw["p_max"])
    lo, hi = torch.zeros_like(pg), torch.ones_like(pg)
    live = ~_feasible(hi, *args)
    for _ in range(SOLVE_STEPS[name]):
        mid = 0.5 * (lo + hi)
        ok = _feasible(mid, *args)
        new_lo, new_hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        steps += live
        live &= (bits(new_lo) != bits(lo)) | (bits(new_hi) != bits(hi))
        lo, hi = new_lo, new_hi
    return steps


def step_stats(torch, steps) -> dict:
    """``needed_steps``' mean and max, the mean over warps (32 elements in
    launch order) of each warp's largest count, and the two sums."""
    warps = torch.cat([steps, steps.new_zeros(-steps.numel() % 32)])
    warps = warps.view(-1, 32).amax(1)
    return dict(mean=float(steps.double().mean()), max=int(steps.max()),
                warp_mean=float(warps.double().mean()), total=int(steps.sum()),
                warp_total=int(warps.sum()))


def solve_times(torch, label: str, name: str, els, kw, reps: int,
                sass: dict | None = None) -> dict:
    """Kernel 1 or 2 on the flat operands ``els``: its device time
    (``queued_ms``) beside its CUDA-event time, its plain version's time by
    CUDA events (its thousands of launches a call fill the launch queue,
    which ``queued_ms`` cannot outlast), the steps its function needs
    (``needed_steps``), the bound on them and, labelled, on the fixed trip
    count, and (given phase [1]'s ``sass``) the compiled loop's issue time
    on the warps' largest counts.  Fails if the kernel reads below its
    bound."""
    from repro_torch.kernels.selection_solve import ops, ref
    kern, plain = {"fused_solve": (ops.fused_solve, ref.fused_solve_ref),
                   "selection_solve": (ops.selection_solve,
                                       ref.selection_solve_ref)}[name]
    n = els[0].numel()
    st = step_stats(torch, needed_steps(torch, name, els, kw))
    out = dict(n=n, steps=st, ms=queued_ms(torch, lambda: kern(*els, **kw), reps),
               events_ms=cuda_ms(torch, lambda: kern(*els, **kw), reps),
               plain_ms=cuda_ms(torch, lambda: plain(*els, **kw), 3))
    out["bound_ms"], by = solve_bound_ms(name, n, st["total"])
    out["bound_by"] = "bytes" if by == "bytes" else "operations"
    out["fixed_bound_ms"], _ = solve_bound_ms(name, n, n * SOLVE_STEPS[name])
    issue = (f"; the compiled loop at the issue rate on the warps' counts "
             f"{sass_issue_ms(sass, name, st['warp_total']):.6f} ms" if sass else "")
    print(f"  {label} {name:16s} E={n:>9,d}: needed steps mean {st['mean']:.3f}, "
          f"max {st['max']}, warp max mean {st['warp_mean']:.3f} (of "
          f"{SOLVE_STEPS[name]}); kernel {out['ms']:.6f} ms device time "
          f"({out['events_ms']:.6f} by events); bound on the needed steps "
          f"{out['bound_ms']:.6f} ms ({by}; the kernel at "
          f"{out['bound_ms'] / out['ms']:.3f} of it), on {SOLVE_STEPS[name]} "
          f"fixed steps {out['fixed_bound_ms']:.6f} ms{issue}; plain "
          f"{out['plain_ms']:.6f} ms by events", flush=True)
    check(out["ms"] >= out["bound_ms"], f"{label} {name}: {out['ms']} ms "
          f"reads below its bound {out['bound_ms']} ms")
    return out


# ------------------------------------------------------------------ phases

def solver_elements(torch, n, tau, seed, dev):
    """One problem's flat element operands (pg, bw, emax, ec)."""
    from repro_torch.core.problem import sample_problem
    p = sample_problem(seed, n, tau_th=tau, device=dev)
    return [x.contiguous() for x in (p.path_gain(), p.bandwidth_hz,
                                     p.energy_budget_j, p.compute_energy())], p


def batch_operands(batch):
    """A batch's flattened element operands (pg, bw, emax, ec), as the
    kernel methods hand them to kernels 1-2, and its scalars."""
    from repro_torch.core.batch import batch_elements
    el, p = batch_elements(batch), batch.problem
    return ([x.reshape(-1).contiguous() for x in el[:4]],
            dict(s_bits=p.grad_size_bits, tau=p.tau_th, p_max=p.p_max))


# gains that no registry draw gives: NaN, +-inf, +-0, a negative, subnormals
SPECIAL_GAINS = (math.nan, math.inf, -math.inf, 0.0, -0.0, -1e6, 1e-40, 1e-45)


def adversarial_elements(torch, n: int, seed: int, dev):
    """Flat operands and scalars for kernels 1-2's edge cases: the
    reference kernel tests' distributions, and in every 16 elements one of
    ``SPECIAL_GAINS`` as the gain, a zero energy budget, an element
    feasible at a = 1 (a large gain and bandwidth), and a NaN or an inf in
    the bandwidth, the budget or the compute energy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pg, bw = rng.uniform(1e4, 1e8, n), rng.uniform(5e4, 5e6, n)
    emax, ec = np.exp(rng.uniform(-7, 4, n)), np.exp(rng.uniform(-8, -2, n))
    k = np.arange(n) % 16
    for j, g in enumerate(SPECIAL_GAINS):
        pg[k == j] = g
    emax[k == 8] = 0.0
    one = k == 9
    pg[one], bw[one], emax[one], ec[one] = 1e12, 1e9, 1e3, 1e-6
    bw[k == 10], emax[k == 11], ec[k == 12] = math.nan, math.inf, math.nan
    return ([torch.from_numpy(x.astype(np.float32)).to(dev)
             for x in (pg, bw, emax, ec)],
            dict(s_bits=6.4e6, tau=0.08, p_max=1.0))


def check_solvers(torch, dev) -> dict:
    """Both solve kernels against their plain versions, bit for bit (NaN
    at the same places): sampled problems, adversarial elements and a
    ragged mixed batch with its padded slots, kernel 1 at each of
    ``FUSED_VARIANTS``.  Returns the largest errors (``bit_err``: 0.0)."""
    from repro_torch.core.scenarios import make_mixed_batch
    from repro_torch.kernels.selection_solve import ops, ref
    errs = {"fused_solve": 0.0, "selection_solve": 0.0}
    sets = []
    for n, tau, seed in ((100, 0.08, 2), (100, 0.5, 3), (1000, 0.3, 4),
                         (4099, 0.08, 5), (4099, 0.5, 6), (1_000_000, 0.2, 7)):
        els, p = solver_elements(torch, n, tau, seed, dev)
        sets.append((f"sampled E={n:,} tau={tau}", els,
                     dict(s_bits=p.grad_size_bits, tau=p.tau_th, p_max=p.p_max),
                     True))
    sets.append(("adversarial E=4,099", *adversarial_elements(torch, 4099, 8, dev),
                 False))
    batch = make_mixed_batch(MIXED_SCENARIOS, seed=0, device=dev)
    sets.append((f"mixed x 5 E={batch.mask.numel():,} "
                 f"({int((~batch.mask).sum()):,} padded)", *batch_operands(batch),
                 True))
    for label, els, kw, finite in sets:
        runs = [("selection_solve", "", ops.selection_solve(*els, **kw),
                 ref.selection_solve_ref(*els, **kw))]
        for n_iters, typo in FUSED_VARIANTS:
            fkw = dict(kw, n_iters=n_iters, faithful_eq13_typo=typo)
            runs.append(("fused_solve", f" n_iters={n_iters} typo={typo}",
                         ops.fused_solve(*els, **fkw), ref.fused_solve_ref(*els, **fkw)))
        torch.cuda.synchronize()
        for name, variant, got, want in runs:
            err = max(bit_err(torch, g, w) for g, w in zip(got, want))
            check(err == 0.0, f"{name} {label}{variant}: not bit for bit its "
                  f"plain version (error {err})")
            check(not finite or all(bool(torch.isfinite(x).all()) for x in got),
                  f"{name} {label}{variant}: non-finite output")
            errs[name] = max(errs[name], err)
        print(f"  {label}: both kernels bit for bit their plain versions (NaN "
              f"at the same places), kernel 1 at {len(FUSED_VARIANTS)} "
              f"(n_iters, typo) pairs")
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


def nan_err(torch, got, want) -> float:
    """max|got - want| where ``want`` is not NaN; inf where the NaNs
    differ in place or where an inf is not matched."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return math.inf
    g, w = got[~nan], want[~nan]
    if not torch.equal(torch.isinf(g), torch.isinf(w)) or not torch.equal(
            g[torch.isinf(w)], w[torch.isinf(w)]):
        return math.inf
    fin = torch.isfinite(w)
    return float((g[fin] - w[fin]).abs().max()) if bool(fin.any()) else 0.0


def bit_err(torch, got, want) -> float:
    """0.0 where ``got`` holds ``want``'s bits, and NaN (of any payload)
    where it is NaN; else ``nan_err``, or inf where that reads 0 (a zero
    of the other sign)."""
    nan = torch.isnan(want)
    if torch.equal(torch.isnan(got), nan) and torch.equal(
            torch.where(nan, 0.0, got).view(torch.int32),
            torch.where(nan, 0.0, want).view(torch.int32)):
        return 0.0
    return nan_err(torch, got, want) or math.inf


def check_quantized(torch, dev) -> tuple[float, float]:
    """The scale kernel against ``row_scale`` and the quantised sum
    against its plain version, bit for bit: T in {1, 18}, N in {1, 100},
    every CNN leaf size and two ragged ones, at widths 1 (ternary), 4, 8,
    32, one that is not whole and a per-client mix, with an all-zero
    client row and noise at 0 and just below 1; then the sparse and the
    non-finite cases (``check_sparse_quantized``).  Returns the sum's and
    the scale pass's largest error."""
    from repro_torch.kernels.masked_aggregate import ops, ref
    gen = torch.Generator(device=dev).manual_seed(3)
    below_one = float(torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)))
    worst = scale_worst = 0.0
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
                    scale_worst = max(scale_worst, nan_err(
                        torch, ops.row_scale_batched(g, levels), scale))
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
    print(f"  row_scale kernel against row_scale over the same operands: "
          f"max error {scale_worst:.3e} (tol {QUANT_TOL:g})")
    check(scale_worst <= QUANT_TOL, f"row_scale kernel: error {scale_worst}")
    sparse, sparse_scale = check_sparse_quantized(torch, dev)
    return max(worst, sparse), max(scale_worst, sparse_scale)


def check_sparse_quantized(torch, dev) -> tuple[float, float]:
    """The wrapper (scale kernel, then the sum that reads only the rows
    with a nonzero coefficient) against ``row_scale`` and the plain sum,
    at T in {1, 18}, N = 100, every CNN leaf size and a ragged one, mixed
    widths: no live client, one, 22 % and all of them; then a client
    whose coefficient is 0 but whose row holds a NaN, an inf, or zeros at
    a width whose scale underflows to 0 (127 bits), in trajectory 0 only:
    NaN exactly where the plain version has NaN, all else equal."""
    from repro_torch.kernels.masked_aggregate import ops, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    worst = scale_worst = 0.0
    n = 100
    for t in (1, 18):
        bits = torch.tensor([4.0, 8.0, 16.0, 32.0], device=dev)[
            torch.randint(0, 4, (t, n), device=dev, generator=gen)]
        for case in ("none", "one", "22pct", "all", "nan", "inf", "underflow"):
            errs, scale_errs, n_nan = [], [], 0
            for d in (1001,) + CNN_LEAVES:
                g = torch.randn(t, n, d, device=dev, generator=gen)
                u = torch.rand(t, n, d, device=dev, generator=gen)
                keep = {"none": 0, "one": 1, "all": n}.get(case, 22)
                coef = torch.rand(t, n, device=dev, generator=gen) + 0.01
                order = torch.rand(t, n, device=dev,
                                   generator=gen).argsort(dim=1)
                coef.scatter_(1, order[:, keep:], 0.0)
                b = bits.clone()
                dead = int(order[0, -1])            # coefficient 0
                if case in ("nan", "inf"):
                    g[0, dead, d // 2] = float(case)
                elif case == "underflow":
                    g[0, dead] = 0.0
                    b[0, dead] = 127.0
                levels = ref.quantizer_levels(b)
                scale = ops.row_scale(g, levels)
                scale_errs.append(nan_err(
                    torch, ops.row_scale_batched(g, levels), scale))
                out = ops.quantized_masked_aggregate(g, coef, u, b)
                plain = ref.quantized_masked_aggregate_ref(g, coef, u, scale,
                                                           levels)
                torch.cuda.synchronize()
                errs.append(nan_err(torch, out, plain))
                n_nan += int(torch.isnan(plain).any(dim=1).sum())
                check(case not in ("nan", "inf", "underflow") or (
                    bool(torch.isnan(plain[0]).all())
                    and bool(torch.isfinite(plain[1:]).all())),
                    f"sparse quantised case {case}: the plain version's NaN "
                    f"are not where the case puts them")
            err, scale_err = max(errs), max(scale_errs)
            print(f"  quantized wrapper T={t:>2} N={n} {case:9s} ({keep if case in ('none', 'one', 'all') else 22} "
                  f"live a trajectory, 9 leaves): max|kernels - plain| = "
                  f"{err:.3e}, scale {scale_err:.3e} (tol {QUANT_TOL:g}); "
                  f"{n_nan} NaN trajectory rows, at the plain version's places")
            check(err <= QUANT_TOL and scale_err <= QUANT_TOL,
                  f"sparse quantised case {case} T={t}: error {err}, "
                  f"scale {scale_err}")
            worst, scale_worst = max(worst, err), max(scale_worst, scale_err)
    return worst, scale_worst


def quant_round_bounds(t: int, n: int, ds, live: int) -> dict:
    """Bounds (ms, by) of one round's quantised sums over leaves of widths
    ``ds`` with ``live`` (trajectory, client) rows of nonzero coefficient:
    the scale pass (every row read once, levels read, scales written),
    the sum given the scales (coefficients, scales and levels, then g and
    noise of the live rows, the output), the function (one read of every
    row for its max, g and noise again for the live rows) and the function
    priced over every row."""
    d, k = sum(ds), len(ds)
    return dict(
        scale=bound_ms(4 * (t * n * d + 2 * t * n * k), t * n * d),
        sum=bound_ms(4 * (3 * t * n * k + 2 * live * d + t * d),
                     QUANT_OPS * live * d),
        pair=bound_ms(4 * (t * n * d + 2 * t * n * k + 2 * live * d + t * d),
                      t * n * d + QUANT_OPS * live * d),
        all_rows=bound_ms(4 * (3 * t * n * d + 2 * t * n * k + t * d),
                          t * n * d + QUANT_OPS * t * n * d))


def time_quant_round(torch, label: str, leaves, coef, levels, tag: str = "",
                     reps: int = 20) -> dict:
    """One round's quantised sums on ``leaves`` [(g, noise)], each [T, N,
    D_leaf], with ``coef`` and ``levels`` [T, N]: the scale kernel
    against ``row_scale`` and the sum against its plain version, bit for
    bit; then, by CUDA events over back-to-back calls (host time between
    launches included) and as device time, the scale
    kernel, ``row_scale`` (the plain scale pass), the library's scale
    pass (``torch.linalg.vector_norm(ord=inf)``, the one PyTorch call for
    max|g|, then the clamp and the division), the sum given the scales,
    the pair and the plain sum; each beside ``quant_round_bounds``.  The
    device times are ``queued_ms``'s (the plain sum's the profiler's); a
    kernel's below its bound fails.
    Returns the numbers."""
    from repro_torch.kernels.masked_aggregate import ops, ref
    t, n = coef.shape
    ops_ = [(g, coef, u, ops.row_scale_batched(g, levels), levels)
            for g, u in leaves]
    err = scale_err = 0.0
    for g, _, _, scale, _ in ops_:
        scale_err = max(scale_err, nan_err(torch, scale, ops.row_scale(g, levels)))
    for op in ops_:
        out = ops.quantized_masked_aggregate_batched(*op)
        plain = ref.quantized_masked_aggregate_ref(*op)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        err = max(err, nan_err(torch, out, plain))

    fns = dict(
        scale=lambda: [ops.row_scale_batched(g, levels) for g, _ in leaves],
        scale_plain=lambda: [ops.row_scale(g, levels) for g, _ in leaves],
        scale_library=lambda: [torch.clamp(torch.linalg.vector_norm(
            g, ord=math.inf, dim=-1), min=1e-12) / levels for g, _ in leaves],
        sum=lambda: [ops.quantized_masked_aggregate_batched(*op) for op in ops_],
        pair=lambda: [ops.quantized_masked_aggregate_batched(
            g, coef, u, ops.row_scale_batched(g, levels), levels)
            for g, u in leaves],
        plain=lambda: [ref.quantized_masked_aggregate_ref(*op) for op in ops_])
    ms, dev = {}, {}
    for name, fn in fns.items():
        r = 3 if name == "plain" else reps
        ms[name] = cuda_ms(torch, fn, r)
        # device time: the launches back to back, without the host's gaps
        # between them (small leaves take the host longer than the card);
        # at most 10 calls, so the launches fit the device's queue.  The
        # plain sum's temporaries (GBs) make the host wait on the device,
        # so its calls cannot be queued: the profiler times it.
        dev[name] = (device_ms(torch, fn, r)[0] if name == "plain"
                     else queued_ms(torch, fn, min(r, 10)))
    live = int((coef != 0).sum())
    ds = [g.shape[-1] for g, _ in leaves]
    b = quant_round_bounds(t, n, ds, live)
    gb = 4 * t * n * sum(ds) / 1e9
    print(f"  {label}: T={t} N={n}, {len(ds)} leaves, D={sum(ds):,d}, "
          f"{live} of {t * n} rows with a nonzero coefficient ({gb:.3f} GB of "
          f"g): max|kernel - plain| {err:.3e}, scale {scale_err:.3e} (tol "
          f"{QUANT_TOL:g}) {tag}")
    print(f"    scale kernel {ms['scale']:.6f} ms by events, {dev['scale']:.6f} "
          f"device (bound {b['scale'][0]:.6f}, at {b['scale'][0] / dev['scale']:.3f}"
          f"); row_scale {ms['scale_plain']:.6f} / {dev['scale_plain']:.6f}; "
          f"vector_norm(inf), clamp, divide {ms['scale_library']:.6f} / "
          f"{dev['scale_library']:.6f} (events / device)")
    print(f"    kernel 4 {ms['sum']:.6f} ms by events, {dev['sum']:.6f} device "
          f"(bound {b['sum'][0]:.6f}, at {b['sum'][0] / dev['sum']:.3f}); plain "
          f"{ms['plain']:.6f} / {dev['plain']:.6f} ms")
    print(f"    the pair {ms['pair']:.6f} ms by events, {dev['pair']:.6f} "
          f"device, against the function's bound {b['pair'][0]:.6f} ms "
          f"({b['pair'][1]}; at {b['pair'][0] / ms['pair']:.3f} / "
          f"{b['pair'][0] / dev['pair']:.3f}); the bound over all {t * n} rows "
          f"{b['all_rows'][0]:.6f} ms; row_scale + kernel 4 "
          f"{ms['scale_plain'] + ms['sum']:.6f} / "
          f"{dev['scale_plain'] + dev['sum']:.6f} ms")
    check(err <= QUANT_TOL and scale_err <= QUANT_TOL,
          f"{label}: error {err}, scale {scale_err} > {QUANT_TOL}")
    for part in ("scale", "sum"):
        check(dev[part] >= b[part][0], f"{label}: {part} read "
              f"{dev[part]:.6f} ms device time, below its bound "
              f"{b[part][0]:.6f} ms")
    return dict(ms=ms, dev=dev, bounds=b, live=live, err=err,
                scale_err=scale_err)


def time_kernels(torch, dev, sass: dict) -> dict:
    """Kernel, plain and library times at the slice's shapes."""
    from repro_torch.kernels.masked_aggregate import ops as agg_ops
    from repro_torch.kernels.masked_aggregate import ref as agg_ref
    rec = {}
    for n in (100, 1_000_000):
        els, p = solver_elements(torch, n, 0.08, 2, dev)
        kw = dict(s_bits=p.grad_size_bits, tau=p.tau_th, p_max=p.p_max)
        for name in ("fused_solve", "selection_solve"):
            t = solve_times(torch, "sampled", name, els, kw,
                            200 if n == 100 else 20, sass)
            if n == 100:            # the slice's shape: one fleet of N = 100
                rec[name] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                                 bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                                 library_ms=None)
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
    # one quantised round with every row live, the sum's worst case: every
    # CNN leaf at T = 18 trajectories, N = 100, 8 bits, coefficients in
    # (0, 1); no single PyTorch call computes quantise-plus-sum
    t, n = 18, 100
    leaves = [(torch.randn(t, n, d, device=dev, generator=gen),
               torch.rand(t, n, d, device=dev, generator=gen))
              for d in CNN_LEAVES]
    coef = torch.rand(t, n, device=dev, generator=gen) + 1e-3
    levels = agg_ref.quantizer_levels(torch.full((t, n), 8.0, device=dev))
    time_quant_round(torch, "quantised round, every row live (dense case)",
                     leaves, coef, levels)
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


# ------------------------------------------------- the fleet control plane

def served_err(responses, yardstick) -> tuple[float, float]:
    """max |a - a_cpu| and the largest P* error in units of 1 + |P_cpu|
    (the atol = rtol test) over responses matched by sequence number."""
    import numpy as np
    want = {r.seq: r for r in yardstick}
    err_a = err_p = 0.0
    for r in responses:
        w = want[r.seq].solution
        err_a = max(err_a, float(np.max(np.abs(r.solution.a - w.a))))
        err_p = max(err_p, float(np.max(np.abs(r.solution.power - w.power)
                                        / (1.0 + np.abs(w.power)))))
    return err_a, err_p


def coupled_err(torch, sol, cpu) -> float:
    return max(float((sol.batch.a.cpu() - cpu.batch.a).abs().max()),
               float(((sol.batch.power.cpu() - cpu.batch.power).abs()
                      / (1.0 + cpu.batch.power.abs())).max()))


def control_plane_layers(torch, dev, cells, args, tag: str) -> None:
    """Where a served micro-batch's time goes: one full batch of the
    demo's cells (round 1, warm from round 0; 64 devices, a power-of-two
    bucket), median of 5, by layer:
    intake (health mask, key), stacking, the batched solve (warm, ending
    in a synchronise), the host reads, and the whole ``step``; then the
    solve's device-busy time from the profiler."""
    import statistics
    from repro_torch.core.batch import pad_batch, stack_problems
    from repro_torch.core.scenarios import slice_round
    from repro_torch.serve import FleetControlService, ServiceConfig
    svc = FleetControlService(ServiceConfig(
        max_batch=args.max_batch, power_solver=args.power_solver), device=dev)
    svc.run([(i, slice_round(c, 0)) for i, c in enumerate(cells)])
    probs = [slice_round(c, 1) for c in cells[:args.max_batch]]
    parts = {k: [] for k in ("intake", "stack", "solve", "reads", "step")}
    for _ in range(5):
        t0 = time.perf_counter()
        reqs = [svc.submit(i, p) for i, p in enumerate(probs)]
        t1 = time.perf_counter()
        svc.step()
        t2 = time.perf_counter()
        batch = pad_batch(stack_problems([r.problem for r in reqs],
                                         device=dev),
                          batch_size=args.max_batch, n_max=args.devices)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        # each request's cached state, as the service packs it
        init = [torch.zeros(svc._sol_shape(batch), device=dev)
                for _ in range(2)]
        for i in range(len(reqs)):
            seed = svc._cell_cache.get(i)
            init[0][i, :args.devices] = torch.from_numpy(seed.a).to(dev)
            init[1][i, :args.devices] = torch.from_numpy(seed.power).to(dev)
        sol = svc._solve(batch, init=init)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        torch.stack([sol.a, sol.power]).cpu()
        torch.stack([sol.objective.double(), sol.converged.double(),
                     sol.n_iters.double()]).cpu()
        t5 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t3 - t2, t4 - t3, t5 - t4,
                                t2 - t1)):
            parts[k].append(v * 1e3)
    med = {k: statistics.median(v) for k, v in parts.items()}
    total, _, _ = device_ms(torch, lambda: svc._solve(batch, init=init), 5)
    print(f"  a served batch of {args.max_batch} (median of 5): intake "
          f"{med['intake']:.3f} ms, stacking {med['stack']:.3f}, the warm "
          f"solve {med['solve']:.3f} (device busy {total:.3f}, idle "
          f"{1 - total / med['solve']:.3f}), host reads {med['reads']:.3f}; "
          f"step() {med['step']:.3f} ms {tag}")


def run_control_plane(torch, dev, card_line: str) -> None:
    """The fleet control plane at the reference demos' own sizes: the
    closed-loop stream warm against cold, the open loop at 0.7 of the
    measured capacity, the coupled metros cold and warm, a dense_1k
    batch in bucket 1,024, a chaos drive over every fault kind, and the
    card's answers against the port's own CPU run of the same trace."""
    import numpy as np
    from repro_torch import serve_demo
    from repro_torch.core.batch import solve_joint_batch
    from repro_torch.core.multicell import solve_coupled
    from repro_torch.core.scenarios import make_problem, slice_round
    from repro_torch.serve import (FAULT_KINDS, FaultPlan, FleetControlService,
                                   ServiceConfig, chaos_drive, drive,
                                   measure_capacity, poisson_trace)
    tag = f"[{card_line}]"
    args = serve_demo.parser().parse_args([])
    cells = serve_demo.make_stream(args)
    print(f"  serve_demo defaults: {args.cells} drifting_metro cells x "
          f"{args.devices} devices x {args.rounds} rounds (requests on the "
          f"host), max_batch {args.max_batch}, {args.power_solver}")

    inner = {}
    for label, warm in (("warm", True), ("cold", False)):
        svc = FleetControlService(ServiceConfig(
            max_batch=args.max_batch, power_solver=args.power_solver,
            warm_start=warm), device=dev)
        s = serve_demo.stream_rounds(svc, cells, args.rounds).summary()
        inner[label] = s["mean_inner_iters"]
        print(f"  closed loop [{label}] {s['solves_per_sec']:.1f} solves/s, "
              f"p50 {s['p50_latency_s'] * 1e3:.3f} ms, p99 "
              f"{s['p99_latency_s'] * 1e3:.3f} ms, inner iters/batch "
              f"{s['mean_inner_iters']:.2f}, warm share "
              f"{s['warm_fraction']:.2f}, {s['batches']} batches {tag}")
    check(inner["warm"] < inner["cold"],
          f"warm inner iterations {inner['warm']} not below cold "
          f"{inner['cold']}")

    svc = FleetControlService(ServiceConfig(
        max_batch=args.max_batch, power_solver=args.power_solver), device=dev)
    probe = [slice_round(c, 0) for c in cells]
    wtimes = svc.warmup(probe[0], max_devices=args.devices)
    cap = measure_capacity(svc, probe)
    svc.stats.reset()
    deadline = 8.0 * args.max_batch / cap
    rate = args.load * cap
    trace = poisson_trace(cells, rate_hz=rate, n_requests=args.requests,
                          seed=args.seed, deadline_s=deadline)
    rep = drive(svc, trace, reset_stats_after=args.requests // 4)
    s = svc.stats.summary()
    print(f"  warmup: buckets {sorted(wtimes)} in "
          f"{sum(wtimes.values()) * 1e3:.1f} ms; capacity {cap:.1f} "
          f"solves/s {tag}")
    print(f"  open loop at {args.load} x capacity ({rep.offered_rate_hz:.1f} "
          f"req/s offered, deadline {deadline * 1e3:.3f} ms, "
          f"{args.requests} requests): sustained "
          f"{rep.sustained_rate_hz:.1f} solves/s, p50 "
          f"{s['p50_latency_s'] * 1e3:.3f} ms, p99 "
          f"{s['p99_latency_s'] * 1e3:.3f} ms, deadline misses "
          f"{s['deadline_miss_rate']:.4f}, warm share "
          f"{s['warm_fraction']:.4f}, closes {s['closes']} {tag}")
    check(len(rep.responses) == args.requests, "the open loop lost requests")
    control_plane_layers(torch, dev, cells, args, tag)

    # the same seeded trace on a virtual clock, on the card and on the CPU
    logs, answers = [], []
    for where in (dev, torch.device("cpu")):
        t = poisson_trace(cells, rate_hz=rate, n_requests=args.requests,
                          seed=args.seed, deadline_s=deadline)
        vsvc = FleetControlService(ServiceConfig(
            max_batch=args.max_batch, power_solver=args.power_solver,
            cost_smoothing=0.0, record_batches=True), device=where)
        answers.append(drive(vsvc, t, clock="virtual").responses)
        logs.append(vsvc.batch_log)
    err_a, err_p = served_err(*answers)
    print(f"  virtual clock, card against CPU: {len(logs[0])} batches, "
          f"logs equal {logs[0] == logs[1]}, max|a| {err_a:.3e}, "
          f"P* {err_p:.3e}")
    check(logs[0] == logs[1], "the card's batch log differs from the CPU's")
    check(err_a <= SOLVE_TOL and err_p <= SOLVE_TOL,
          f"the card's answers differ from the CPU's ({err_a}, {err_p})")

    for name in ("metro_coupled", "interference_grid"):
        mc = make_problem(name, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = solve_coupled(mc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        warm = solve_coupled(mc, init=cold.resume)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cpu = solve_coupled(make_problem(name, seed=0, device="cpu"))
        err = coupled_err(torch, cold, cpu)
        print(f"  {name} ({mc.n_cells} x {mc.cells.n_max}): cold "
              f"{cold.outer_iters} outer iterations, residual "
              f"{cold.residual:.3e}, {(t1 - t0) * 1e3:.1f} ms; warm "
              f"{warm.outer_iters}, residual {warm.residual:.3e}, "
              f"{(t2 - t1) * 1e3:.1f} ms; mu {np.max(cold.mu):.4e}; "
              f"against CPU {err:.3e} ({cpu.outer_iters} outer) {tag}")
        check(cold.converged and warm.converged, f"{name} did not converge")
        check(warm.outer_iters < cold.outer_iters,
              f"{name}: warm duals took {warm.outer_iters} outer steps")
        check(cold.outer_iters == cpu.outer_iters and err <= SOLVE_TOL,
              f"{name}: the card's solve differs from the CPU's ({err})")
    zero = make_problem("metro_coupled", seed=0, device=dev,
                        coupling_gain=0.0, backhaul_fraction=None)
    sol, plain = solve_coupled(zero), solve_joint_batch(zero.cells,
                                                        method="fused")
    check(torch.equal(sol.batch.a, plain.a)
          and torch.equal(sol.batch.power, plain.power),
          "zero coupling differs from the uncoupled fused solve")
    print("  zero coupling: bit for bit the uncoupled fused solve")

    dense = [make_problem("dense_1k", seed=s, device=dev) for s in range(16)]
    dsvc = FleetControlService(ServiceConfig(max_batch=16), device=dev)
    got = dsvc.run(list(enumerate(dense)))
    buckets, lat = dsvc.buckets_used, dsvc.stats.latency_percentile(50)
    on_cpu = FleetControlService(ServiceConfig(max_batch=16), device="cpu")
    err_a, err_p = served_err(got, on_cpu.run(
        [(i, p.to("cpu")) for i, p in enumerate(dense)]))
    feasible = all(bool(p.constraints_satisfied(
        torch.from_numpy(r.solution.a).to(dev),
        torch.from_numpy(r.solution.power).to(dev), rtol=1e-3).all())
        for p, r in zip(dense, sorted(got, key=lambda r: r.seq)))
    print(f"  dense_1k x 16 (bucket {sorted(buckets)}, "
          f"{16 * 1024:,} elements a batch): {lat * 1e3:.3f} ms, "
          f"feasible={feasible}, against CPU max|a| {err_a:.3e}, "
          f"P* {err_p:.3e} {tag}")
    check(buckets == {1024} and feasible and max(err_a, err_p) <= SOLVE_TOL,
          "dense_1k batch failed")

    csvc = FleetControlService(ServiceConfig(
        max_batch=args.max_batch, cost_smoothing=0.0), device=dev)
    plan = FaultPlan(kinds=FAULT_KINDS, seed=args.seed, fault_rate=0.25,
                     device_rate=0.1)
    chaos = chaos_drive(csvc, poisson_trace(cells, rate_hz=rate,
                                            n_requests=args.requests,
                                            seed=args.seed), plan)
    print(f"  chaos over {FAULT_KINDS}: {chaos.n_faulted} of "
          f"{args.requests} arrivals faulted, {chaos.n_unhealthy_devices} "
          f"devices sanitised, {chaos.n_unconverged} unconverged, "
          f"{chaos.n_shed} shed, non-finite responses {chaos.nan_escapes}")
    check(chaos.nan_escapes == 0 and chaos.n_unhealthy_devices > 0
          and len(chaos.report.responses) == args.requests,
          "the chaos drive leaked a non-finite answer or lost a request")


def time_batched(torch, dev, batches, sass) -> None:
    """Kernels 1-2 at the batched shapes: each kernel alone on the batch's
    flattened elements (``solve_times``: device time, the steps its
    function needs, its bound on them and on the fixed trip count, the
    compiled loop's issue time, its plain version), the whole
    ``solve_joint_batch`` method by CUDA events; and the host's
    ``make_batch`` alone."""
    from repro_torch.core.batch import solve_joint_batch
    from repro_torch.core.scenarios import make_batch
    for label, batch in batches:
        flat, kw = batch_operands(batch)
        for method, name, _ in KERNEL_METHODS:
            solve_times(torch, label, name, flat, kw, 20, sass)
            method_ms = cuda_ms(torch, lambda: solve_joint_batch(
                batch, method=method), 5)
            print(f"  {label} solve_joint_batch(method={method!r}) "
                  f"{method_ms:.6f} ms (CUDA events)")
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
                kernel) -> dict:
    """Where the time of a warm ``fn`` goes: wall time against device-busy
    time (torch.profiler), the idle share, the share of device time of
    ``kernel`` (a name, a tuple of names or None), and device time by
    kernel.  ``fn(k)`` is called twice, k = 0 timed and k = 1 profiled;
    one call makes ``per`` ``unit``s.  Returns each named kernel's device
    ms per ``unit``."""
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
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel or ())
    kern_events = {name: [e for e in events if kernel_re(name).search(e.key)]
                   for name in names}
    kern_ms = {name: sum(e.self_device_time_total for e in evs) / 1e3 / per
               for name, evs in kern_events.items()}
    share = "".join(f"; {name} {ms:.3f} ms per {unit}, {ms / busy_ms:.3f} of "
                    f"device time, {ms / wall_ms:.3f} of wall time"
                    for name, ms in kern_ms.items()) if busy_ms else ""
    print(f"  {label}: {wall_ms:.3f} ms wall per {unit}, device busy "
          f"{busy_ms:.3f} ms under the profiler "
          f"({sum(e.count for e in events) / per:.0f} device operations a {unit})"
          + (f", idle share {1 - busy_ms / wall_ms:.3f}{share}" if busy_ms else
             "; device time not measured by the profiler"))
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3 / per:10.4f} ms/{unit} "
              f"{e.count / per:8.1f} calls a {unit}  {e.key[:90]}")
    for name, evs in kern_events.items():
        if len(evs) > 1:
            print(f"  {name} by kernel function:")
            for e in evs:
                print(f"    {e.self_device_time_total / 1e3 / per:10.4f} ms/{unit} "
                      f"{e.count / per:8.1f} calls a {unit}  {e.key[:90]}")
    return kern_ms


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
    from repro_torch.fl import scan_engine
    from repro_torch.fl.scan_engine import init_sweep_params, run_fl_sweep, stack_plans
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.masked_aggregate import ref as agg_ref
    from repro_torch.tree import tree_leaves
    record: dict = {}
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    plans, labels, cfgs, trains, tests, info = quantized_plans(
        torch, dev, rounds, eval_every)
    t1 = time.perf_counter()
    capture = captured_operands(
        record, min(QUANT_OPERANDS_ROUND, cfgs[0].n_rounds - 1))
    with wrapped(scan_engine, "quantized_aggregate_pytree", capture):
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
    for name in ("row_scale", "quantized_masked_aggregate"):
        check(launches[name] == 8 * rounds,
              f"{name} launched {launches[name]} times, not 8 x {rounds}")
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
    del sweep
    gstack, coef, bits, noise = record["operands"]
    t, n = coef.shape
    leaves = [(g.reshape(t, n, -1).contiguous(), u.reshape(t, n, -1).contiguous())
              for g, u in zip(tree_leaves(gstack), tree_leaves(noise))]
    levels = agg_ref.quantizer_levels(torch.as_tensor(
        bits, dtype=torch.float32, device=dev)).expand(t, n).contiguous()
    timed = time_quant_round(
        torch, f"the quantised sweep's own round {record['round']}", leaves,
        coef.contiguous(), levels, f"[{card()}]")
    return dict(launches=launches, round=timed)


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
                                           (3, 130, 2, 3, 30, None, 200),
                                           # danube's, phi3's and zamba2's
                                           # heads at their serving caches
                                           (4, 88, 8, 4, 120, 4096, 60),
                                           (4, 88, 10, 4, 128, None, 60),
                                           (4, 88, 32, 1, 112, 4096, 60),
                                           (2, 512, 32, 1, 112, 4096, 700)):
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
    worst = max(worst, check_softcap_decode(torch, dev))
    worst = max(worst, check_llama4_decode(torch, dev))
    got = decode_digests(torch, dev)
    print(f"  swa_decode without a softcap on {len(got)} numpy-made cases: "
          f"output digests {got}")
    check(got == list(DECODE_DIGESTS),
          f"swa_decode without a softcap: digests {got}, not the kernel's "
          f"recorded {DECODE_DIGESTS}")
    print("  swa_decode without a softcap: every output bit for bit the "
          "recorded one")
    return worst


def check_llama4_decode(torch, dev) -> float:
    """Kernel 6 at llama4-scout's heads (Hkv 8, G 5, dh 128: the odd group
    that the MAXG = 8 instance runs with three dead lanes) against its
    plain version: the serving run's cache of 88 slots, filling and
    wrapped, and a local ring of 8,192 slots (B = 4) full and wrapped,
    each under the 8,192 window and without one, through the wrapper and
    at forced split counts."""
    worst = 0.0
    for i, (b, w, qpos, splits) in enumerate((
            (4, 88, 60, (1, 3)), (4, 88, 150, (1, 3)),
            (4, LLAMA4_WINDOW, 2 * LLAMA4_WINDOW - 1, (1, 7, 64)),
            (4, LLAMA4_WINDOW, 9000, (1, 7, 64)))):
        q, k, v = decode_operands(torch, dev, b, w, *LLAMA4_HEADS, 90 + i)
        pos = ring_positions(torch, w, qpos, dev)
        for window in (LLAMA4_WINDOW, None):
            worst = max(worst, hold_decode_splits(
                torch, q, k, v, pos, qpos, window, splits, None,
                f"B={b} W={w:>4} Hkv={LLAMA4_HEADS[0]} G={LLAMA4_HEADS[1]} "
                f"dh={LLAMA4_HEADS[2]} window={window} qpos={qpos}"))
        del q, k, v
    return worst


def time_llama4_decode(torch, dev) -> list:
    """Device time of kernel 6 at llama4-scout's heads on full rings, its
    launches queued behind a spin kernel (``queued_ms``: the profiler
    left a few of the long ring's launches unrecorded), beside the
    profiler's device time of its plain version and of one library call
    (scaled_dot_product_attention with the boolean mask and enable_gqa),
    whose many launches the host queues slower than they run, and the
    bound: the serving run's cache of
    88 slots and the local window's 8,192 (B = 4), each over enough
    distinct caches that every launch reads its K and V from device
    memory.  Returns one record a shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.swa_decode import ops, ref
    hkv, g, dh = LLAMA4_HEADS
    out = []
    for b, w, copies, reps in ((4, 88, 96, 10), (4, LLAMA4_WINDOW, 2, 20)):
        qpos = 2 * w - 1
        pos = ring_positions(torch, w, qpos, dev)
        ops_ = [decode_operands(torch, dev, b, w, *LLAMA4_HEADS, 400 + i)
                for i in range(copies)]
        mask = ((pos >= 0) & (pos <= qpos) & (pos > qpos - LLAMA4_WINDOW))[None, None, None, :]

        def calls(fn):
            return lambda: [fn(q, k, v) for q, k, v in ops_]
        kern = calls(lambda q, k, v: ops.swa_decode(q, k, v, pos, qpos,
                                                    window=LLAMA4_WINDOW))
        plain = calls(lambda q, k, v: ref.swa_decode_ref(q, k, v, pos, qpos,
                                                         window=LLAMA4_WINDOW))
        lib = calls(lambda q, k, v: F.scaled_dot_product_attention(
            q.reshape(b, hkv * g, 1, dh), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=1.0, enable_gqa=True))
        lib_err = float((lib()[0].reshape(ops_[0][0].shape) - plain()[0]).abs().max())
        k_ms = queued_ms(torch, kern, reps) / copies
        p_ms = device_ms(torch, plain, max(reps // 10, 2))[0] / copies
        l_ms = device_ms(torch, lib, reps)[0] / copies
        b_ms, by = decode_bound(b, w, hkv, g, dh)
        print(f"  swa_decode llama4-scout's heads B={b} W={w:>4} window "
              f"{LLAMA4_WINDOW} Hkv={hkv} G={g} dh={dh} (nsplit "
              f"{ops.split_count(b * hkv, w, sm_count(torch))}), device time: "
              f"kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, SDPA {l_ms:.6f} ms "
              f"(max|SDPA - plain| {lib_err:.2e}), bound {b_ms:.6f} ms ({by}); "
              f"kernel at {b_ms / k_ms:.3f} of its bound")
        out.append(dict(shape=f"B={b} W={w} Hkv={hkv} G={g} dh={dh}", ms=k_ms,
                        plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                        library_ms=l_ms))
        del ops_
    return out


def decode_digests(torch, dev) -> list:
    """The first 16 hex digits of the SHA-256 of kernel 6's output bytes
    without a softcap, on operands drawn with numpy for each of
    ``DIGEST_CASES``, at its split count."""
    import hashlib
    import numpy as np
    from repro_torch.kernels.swa_decode import ops
    out = []
    for i, (b, w, hkv, g, dh, window, qpos, nsplit) in enumerate(DIGEST_CASES):
        rng = np.random.default_rng(100 + i)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
                   for shape in ((b, hkv, g, dh), (b, w, hkv, dh), (b, w, hkv, dh)))
        q = q * dh ** -0.5
        o = ops._launch(q, k, v, ring_positions(torch, w, qpos, dev), qpos,
                        window, nsplit)
        out.append(hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()[:16])
    return out


def hold_decode_splits(torch, q, k, v, pos, qpos, window, splits, softcap,
                       label: str) -> float:
    """Kernel 6 through its wrapper and at each of ``splits`` (forced split
    counts) against its plain version at ``DECODE_TOL``: one line printed,
    the largest error returned."""
    from repro_torch.kernels.swa_decode import ops, ref
    plain = ref.swa_decode_ref(q, k, v, pos, qpos, window=window, softcap=softcap)
    runs = [("wrapper", ops.swa_decode(q, k, v, pos, qpos, window=window,
                                       softcap=softcap))]
    runs += [(f"nsplit={n}", ops._launch(q, k, v, pos, qpos, window, n, softcap))
             for n in splits]
    torch.cuda.synchronize()
    errs, worst = [], 0.0
    for name, out in runs:
        err = float((out - plain).abs().max())
        check(bool(torch.isfinite(out).all()) and bool(torch.allclose(
            out, plain, rtol=DECODE_TOL, atol=DECODE_TOL)),
            f"swa_decode {label} {name}: error {err} beyond {DECODE_TOL}")
        errs.append(f"{name} {err:.2e}")
        worst = max(worst, err)
    print(f"  swa_decode {label}: max|kernel - plain| " + ", ".join(errs))
    return worst


def check_softcap_decode(torch, dev) -> float:
    """Kernel 6 with gemma2's softcap (50) at gemma2's heads against its
    plain version: a ragged local ring of 4,100 slots wrapped under the
    4,096 window and without one, the serving run's cache of 88 and a
    filling ring, each through the wrapper and at forced split counts;
    the queries as drawn (scores of spread about 1, where the cap barely
    bends them) and scaled by 30 (spread about 30, bent hard)."""
    worst = 0.0
    for i, (b, w, window, qpos, splits) in enumerate((
            (4, 4100, GEMMA2_WINDOW, 9000, (1, 7, 64)),
            (4, 4100, None, 9000, (1, 7, 64)),
            (4, 88, None, 60, (1, 3)),
            (2, 1000, GEMMA2_WINDOW, 700, (1, 17)))):
        q, k, v = decode_operands(torch, dev, b, w, *GEMMA2_HEADS, 80 + i)
        pos = ring_positions(torch, w, qpos, dev)
        for hot in (1.0, 30.0):
            worst = max(worst, hold_decode_splits(
                torch, q * hot, k, v, pos, qpos, window, splits, GEMMA2_SOFTCAP,
                f"softcap {GEMMA2_SOFTCAP:g} B={b} W={w:>4} Hkv={GEMMA2_HEADS[0]} "
                f"G={GEMMA2_HEADS[1]} dh={GEMMA2_HEADS[2]} window={window} "
                f"qpos={qpos} q x{hot:g}"))
        del q, k, v
    return worst


def decode_bound(b, w, hkv, g, dh, softcap: bool = False) -> tuple[float, str]:
    """K and V read once, q read and out written once, pos read once;
    2 x 2 operations per (query row, slot, column) and 5 per score, 4 more
    with a softcap (a division, the tanh, two products)."""
    h = hkv * g
    nbytes = (2 * b * w * hkv * dh + 2 * b * h * dh + w) * 4
    per_score = 9 if softcap else 5
    return bound_ms(nbytes, 4 * b * h * w * dh + per_score * b * h * w)


def time_softcap_decode(torch, dev) -> None:
    """Device time (the profiler's) of kernel 6 with gemma2's softcap,
    beside the same launches without it, its plain version and the bound,
    at gemma2's heads on full rings: the serving run's cache of 88 slots
    and a local ring of 4,096 under the window, each over enough distinct
    caches that every launch reads its K and V from device memory."""
    from repro_torch.kernels.swa_decode import ops, ref
    for b, w, copies, reps in ((4, 88, 48, 50), (4, 4096, 4, 20)):
        qpos = 2 * w - 1
        pos = ring_positions(torch, w, qpos, dev)
        ops_ = [decode_operands(torch, dev, b, w, *GEMMA2_HEADS, 300 + i)
                for i in range(copies)]

        def run(cap, fn=ops.swa_decode):
            return lambda: [fn(q, k, v, pos, qpos, window=GEMMA2_WINDOW,
                               softcap=cap) for q, k, v in ops_]
        capped = device_ms(torch, run(GEMMA2_SOFTCAP), reps, "swa_decode")[1] / copies
        free = device_ms(torch, run(None), reps, "swa_decode")[1] / copies
        plain = device_ms(torch, run(GEMMA2_SOFTCAP, ref.swa_decode_ref),
                          max(reps // 10, 2))[0] / copies
        b_ms, by = decode_bound(b, w, *GEMMA2_HEADS, softcap=True)
        print(f"  swa_decode softcap {GEMMA2_SOFTCAP:g} B={b} W={w:>4} "
              f"window={GEMMA2_WINDOW} Hkv={GEMMA2_HEADS[0]} G={GEMMA2_HEADS[1]} "
              f"dh={GEMMA2_HEADS[2]} (nsplit "
              f"{ops.split_count(b * GEMMA2_HEADS[0], w, sm_count(torch))}), "
              f"device time: kernel {capped:.6f} ms, without the softcap "
              f"{free:.6f} ms, plain {plain:.6f} ms, bound {b_ms:.6f} ms "
              f"({by}); kernel at {b_ms / capped:.3f} of its bound")
        del ops_


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
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import BatchedServer
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
        reqs = serve_requests(cfg, gen)
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
    got = ssd_digests(torch, dev)
    print(f"  ssd_scan forward digests {got} (recorded before the backward "
          f"came: {list(SSD_DIGESTS)})")
    check(got == list(SSD_DIGESTS), "ssd_scan's forward changed its bits")
    return worst


def ssd_digests(torch, dev) -> list:
    """The first 16 hex digits of the SHA-256 of kernel 5's outputs (y,
    then the final state) on operands drawn with numpy for each of
    ``SSD_DIGEST_CASES``."""
    import hashlib
    import numpy as np
    from repro_torch.kernels.ssd_scan import ops
    out = []
    for i, (b, s, h, p, n, cs, init) in enumerate(SSD_DIGEST_CASES):
        rng = np.random.default_rng(200 + i)
        arrays = (rng.normal(size=(b, s, h, p)), rng.uniform(0.001, 0.1, (b, s, h)),
                  -rng.uniform(0.5, 4.0, h), rng.normal(size=(b, s, n)) * 0.3,
                  rng.normal(size=(b, s, n)) * 0.3, rng.normal(size=h),
                  rng.normal(size=(b, h, p, n)) if init else None)
        x, dt, a, bm, cm, d, s0 = (
            None if v is None else torch.from_numpy(v.astype(np.float32)).to(dev)
            for v in arrays)
        with torch.no_grad():
            y, state = ops.ssd_apply(x, dt, a, bm, cm, d, chunk=cs,
                                     init_state=s0, return_state=True)
        out.append(hashlib.sha256(y.cpu().numpy().tobytes()
                                  + state.cpu().numpy().tobytes()).hexdigest()[:16])
    return out


def grad_err(got, want) -> float:
    """max|got - want| over max|want| (over 1 where want is zero)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


def ssd_backward_pair(torch, ops_, s0, chunk, seed, cotangent_state=True):
    """Kernel 5's forward on the card, then its backward kernel and the
    plain backward on the same scratch, for cotangents drawn from
    ``seed``: (kernel's gradients, plain gradients)."""
    from repro_torch.kernels.ssd_scan import ops, ref
    x = ops_[0]
    b, _, h, p = x.shape
    gen = torch.Generator(device=x.device).manual_seed(seed)
    dy = torch.randn(x.shape, device=x.device, generator=gen)
    d_final = (torch.randn((b, h, p, ops_[3].shape[-1]), device=x.device,
                           generator=gen) if cotangent_state else None)
    with torch.no_grad():
        _, _, cum, states, scores = ops._forward_card(*ops_, chunk, s0)
        got = ops._backward_card(dy, d_final, *ops_, chunk, cum, states, scores)
        want = ref.ssd_bwd_passes_ref(dy, d_final, *ops_, chunk, cum, states,
                                      scores)
    return got, want


def check_ssd_bwd(torch, dev, cfg=None, params=None) -> float:
    """(d1) The backward kernel against the plain backward at mamba2-780m's
    widths (random and, given the model, layer-0 operands) at the training
    batch and prefill_32k's length, with an initial state and the final
    state's cotangent, the stress decays, and the reduced and ragged
    shapes; each gradient within SSD_BWD_TOL of its max-norm; then three
    calls at the first shape, the same bits.  Returns the largest
    max|kernel - plain| of any gradient."""
    h, p, n, cs = MAMBA2_SSD
    cases = []      # (label, operands, init, chunk, the final state's cotangent)
    for b, s in MAMBA2_BWD:
        ops_, s0 = ssd_operands(torch, dev, b, s, h, p, n, 3 * s + b, init=True)
        cases.append((f"mamba2 B={b} S={s}, init_state", ops_, s0, cs, True))
        if params is not None:
            cases.append((f"mamba2 layer 0 B={b} S={s}",
                          layer0_operands(torch, dev, cfg, params, b, s, b), None,
                          cs, False))
    (x, dt, a, bm, cm, d), _ = ssd_operands(torch, dev, 1, 1024, h, p, n, 99)
    cases.append(("mamba2, dt x 300 and A x 4", (x, dt * 300.0, a * 4.0, bm, cm, d),
                  None, cs, True))
    for label, (b, s, hh, pp, nn, ch), init in (
            ("reduced, init_state", (2, 128, 16, 32, 16, 32), True),
            ("ragged", (1, 192, 3, 48, 100, 96), False),
            ("ragged, init_state", (3, 40, 5, 7, 5, 8), True),
            ("ragged", (1, 130, 2, 33, 1, 65), False)):
        ops_, s0 = ssd_operands(torch, dev, b, s, hh, pp, nn, s + pp + nn, init)
        cases.append((label, ops_, s0, ch, init))
    worst = 0.0
    for i, (label, ops_, s0, ch, cot) in enumerate(cases):
        got, want = ssd_backward_pair(torch, ops_, s0, ch, 50 + i, cot)
        torch.cuda.synchronize()
        errs = {name: grad_err(u, v) for name, u, v in zip(SSD_GRADS, got, want)}
        stress = "dt x 300" in label
        tol = {name: SSD_BWD_STRESS_DA_TOL if stress and name == "da"
               else SSD_BWD_TOL for name in SSD_GRADS}
        b, s, hh, pp = ops_[0].shape
        print(f"  ssd_scan_bwd {label}: B={b} S={s} H={hh} P={pp} "
              f"N={ops_[3].shape[-1]} chunk={ch}: max|kernel - plain| / "
              f"max|plain| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {SSD_BWD_TOL:g}" + (f"; da {SSD_BWD_STRESS_DA_TOL:g}"
                                           if stress else "") + ")")
        check(all(bool(torch.isfinite(u).all()) for u in got),
              f"ssd_scan_bwd {label}: a non-finite gradient")
        bad = [k for k, v in errs.items() if not v <= tol[k]]
        check(not bad, f"ssd_scan_bwd {label}: {bad} beyond tolerance: {errs}")
        worst = max([worst] + [float((u - v).abs().max())
                               for u, v in zip(got, want)])
        del got, want
    # the same bits from call to call, at the first shape
    label, ops_, s0, ch, cot = cases[0]
    runs = [ssd_backward_pair(torch, ops_, s0, ch, 50, cot)[0] for _ in range(3)]
    check(all(torch.equal(u, v) for run in runs[1:] for u, v in zip(run, runs[0])),
          "ssd_scan_bwd: repeated calls differ")
    print(f"  ssd_scan_bwd {label}: 3 calls, the same bits")
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


def ssd_bwd_work(b, s, h, p, n, cs) -> tuple[float, float, float]:
    """The least work of the scan's backward, (operations of the products,
    the other operations, bytes), counted as ``ssd_work``: per head the
    gradient of the entering state (e dy)^T C, of C's inter term (e dy)
    S_in (summed over the heads after), U = B dS^T and (w x)^T dS, each
    cs P N; dM = dy x^T and M^T dy over the causal triangle; then dG B
    and dG^T C once per (batch row, chunk), C.B^T read from the forward.
    The other operations: per entry of the triangle and head the decay's
    exponent and its products with G, dt, dM and the sums (11), per
    (step, head, p) the state term's, skip's and dots' (11), per state
    entry the carry's (5), per step and head the reverse sums (20).
    Bytes: x, dy, B, C, dt, a, D, the final state's cotangent and the
    forward's scratch (cum, entering states, C.B^T) read once; dx, ddt,
    da, dB, dC, dD and the initial state's gradient written once."""
    tri = cs * (cs + 1) // 2
    products = 2 * (2 * tri * n + h * (4 * cs * p * n + 2 * tri * p))
    other = h * (11 * tri + 11 * cs * p + 5 * p * n + 20 * cs)
    nc = b * (s // cs)
    nbytes = 4 * (3 * b * s * h * p + 4 * b * s * n + 3 * b * s * h + 4 * h
                  + 2 * b * h * p * n + nc * (h * p * n + cs * cs))
    return nc * products, nc * other, nbytes


def ssd_bwd_bound(b, s, h, p, n, cs) -> tuple[float, str]:
    """(bound ms, what bounds it): the products at the 3xTF32 rate, the
    rest at float32's, or the bytes at the memory's rate."""
    products, other, nbytes = ssd_bwd_work(b, s, h, p, n, cs)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / (TF32_OPS_PER_S / 3) + other / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ssd_bwd(torch, dev) -> dict:
    """The backward kernel's device time (``queued_ms``, its six passes
    apart by the profiler) and the plain backward's (CUDA events) on the
    same forward scratch, beside the bound, at the training batch and at
    prefill_32k's length.  Returns the record at the training batch, the
    shape the main path gives it.  No single PyTorch call computes it."""
    from repro_torch.kernels.ssd_scan import ops, ref
    h, p, n, cs = MAMBA2_SSD
    rec = None
    for b, s in MAMBA2_BWD:
        ops_, s0 = ssd_operands(torch, dev, b, s, h, p, n, 5 * s + b, init=True)
        gen = torch.Generator(device=dev).manual_seed(s)
        dy = torch.randn(ops_[0].shape, device=dev, generator=gen)
        d_final = torch.randn((b, h, p, n), device=dev, generator=gen)
        with torch.no_grad():
            _, _, cum, states, scores = ops._forward_card(*ops_, cs, s0)
            args = (dy, d_final, *ops_, cs, cum, states, scores)
            ms = queued_ms(torch, lambda: ops._backward_card(*args), 10)
            _, dev_ms, passes = device_ms(
                torch, lambda: ops._backward_card(*args), 3, "ssd_bwd")
            plain_ms = cuda_ms(torch, lambda: ref.ssd_bwd_passes_ref(*args), 3)
        b_ms, b_by = ssd_bwd_bound(b, s, h, p, n, cs)
        print(f"  ssd_scan_bwd B={b} S={s} (H={h} P={p} N={n} chunk={cs}): "
              f"kernel {ms:.6f} ms (device time, queued), plain {plain_ms:.6f} "
              f"ms, library none, bound {b_ms:.6f} ms ({b_by}: products at 495 "
              f"/ 3 TFLOP/s, the rest at 67); kernel at {b_ms / ms:.3f} of its "
              f"bound")
        print(f"    its passes by the profiler ({dev_ms:.6f} ms of device time "
              f"a call, by kernel function):")
        for name, t in passes.items():
            print(f"    {t:10.6f} ms  {t / dev_ms:.3f}  {name[:90]}")
        if rec is None:
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
        del ops_, s0, dy, d_final, cum, states, scores, args
    return rec


def init_mamba2(torch, dev):
    """mamba2-780m at full width from a seeded generator: (cfg, params)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch("mamba2-780m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return cfg, params


def profile_prefill(torch, prefill, params, tokens, kernel="ssd_scan") -> None:
    """Where one (warm) prefill's time goes."""
    b, s = tokens.shape
    profile_run(torch, f"profiled prefill B={b} S={s}",
                lambda _k: prefill(params, {"tokens": tokens}), 1, "prefill",
                kernel)


def run_mamba2(torch, dev, cfg, params) -> dict:
    """The Mamba2 slice's main path at full width, with the launch count
    zeroed just before each prefill and read just after it; then decode
    against forward and the server."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import BatchedServer
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
    reqs = serve_requests(cfg, gen_len)
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


# ------------------------------------------------- the remaining archs

def serve_requests(cfg, gen: int):
    """The reference server's request recipe: 8 requests, prompts of 4-23
    tokens drawn from ``default_rng(0)``."""
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(4, 24))
                    .astype(np.int32), max_new=gen) for i in range(8)]


def timed_prefill(torch, dev, cfg, params, gen, n_ssd: int) -> int:
    """A warm prefill at ``ARCH_PREFILL`` through ``make_prefill_step``,
    with the launch counts zeroed just before it and read just after (the
    arch's Mamba2 mixers launch kernel 5 once each, nothing launches kernel
    6), then a profiled one.  Returns kernel 5's launches."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as T
    counts = cuda_lib.LAUNCHES
    prefill = make_prefill_step(cfg)
    b, s = ARCH_PREFILL
    warm = cfg.ssm.chunk if n_ssd else 64
    prefill(params, {"tokens": torch.zeros((1, warm), dtype=torch.long,
                                           device=dev)})
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"  prefill B={b} S={s}: {wall:.3f} s wall, {b * s / wall:,.0f} "
          f"tokens/s, ssd_scan launches {counts['ssd_scan']} ({n_ssd} "
          f"Mamba2 mixers), swa_decode {counts['swa_decode']}; max|logits| "
          f"{float(logits.abs().max()):.3f}")
    check(tuple(logits.shape) == (b, s, T.padded_vocab(cfg))
          and bool(torch.isfinite(logits).all()),
          f"prefill logits of shape {tuple(logits.shape)}, or not finite")
    check(counts["ssd_scan"] == n_ssd and counts["swa_decode"] == 0,
          f"prefill: {counts['ssd_scan']} ssd_scan launches, not {n_ssd}")
    del logits
    profile_prefill(torch, prefill, params, tokens,
                    "ssd_scan" if n_ssd else None)
    return counts["ssd_scan"]


@contextlib.contextmanager
def recorded_routes(record: list):
    """Inside the block, every MoE call's routing appended to ``record``:
    (its top-k experts, each row's sorted, [T, k]; the k-th minus the
    (k+1)-th router probability, [T]), on the device."""
    from repro_torch.models import moe

    def wrapper(route):
        def recording(params, x, cfg):
            logits, probs, gates, idx = route(params, x, cfg)
            top = probs.topk(cfg.top_k + 1, dim=-1).values
            record.append((idx.sort(-1).values,
                           top[:, cfg.top_k - 1] - top[:, cfg.top_k]))
            return logits, probs, gates, idx
        return recording

    with wrapped(moe, "route", wrapper):
        yield


def first_route_flips(torch, fwd: list, dec: list, b: int, s: int) -> list:
    """Each batch row's first position whose experts decode chose apart
    from forward's at some MoE layer (``s`` where none), from the routes
    ``recorded_routes`` took: forward's one call a layer over all B S
    rows, decode's one a layer a step.  Prints every row's first flip
    (its layer and both runs' margins, which must be under
    ``FLIP_MARGIN``) and the count of flips after it, which that first
    one's changed state may cause."""
    n_moe = len(fwd)
    check(len(dec) == s * n_moe, f"{len(dec)} decode routes, not {s} x {n_moe}")
    f_idx = torch.stack([r[0] for r in fwd]).reshape(n_moe, b, s, -1)
    f_m = torch.stack([r[1] for r in fwd]).reshape(n_moe, b, s)
    d_idx = torch.stack([r[0] for r in dec]).reshape(s, n_moe, b, -1).permute(1, 2, 0, 3)
    d_m = torch.stack([r[1] for r in dec]).reshape(s, n_moe, b).permute(1, 2, 0)
    flips = sorted((row, pos, layer) for layer, row, pos in
                   (f_idx != d_idx).any(-1).nonzero().tolist())
    firsts = []
    for row in range(b):
        mine = [f for f in flips if f[0] == row]
        if not mine:
            firsts.append(s)
            print(f"  routes, row {row}: no flip over {s} positions x {n_moe} MoE layers")
            continue
        _, pos, layer = mine[0]
        fm, dm = float(f_m[layer, row, pos]), float(d_m[layer, row, pos])
        print(f"  routes, row {row}: first flip at position {pos}, MoE layer "
              f"{layer}: margin {fm:.3e} in forward, {dm:.3e} in decode (limit "
              f"{FLIP_MARGIN:g}); {len(mine) - 1} flips after it")
        check(max(fm, dm) < FLIP_MARGIN,
              f"row {row}: a route flip at position {pos} with margin {max(fm, dm)}")
        firsts.append(pos)
    return firsts


def run_arch(torch, dev, cfg) -> dict:
    """One arch's serving path at full width (depth as ``cfg`` has it):
    the parameters from a seeded generator, the prefill of zamba2 and the
    MoE archs, teacher-forced decode against forward, ``BatchedServer``
    and a profiled decode step, each with the launch counts zeroed just
    before it and read just after.  An MoE arch's self-check runs at
    capacity factor E / k (C >= T: forward drops nothing, as decode at T =
    B drops nothing) and compares each row up to its first route flip;
    its forward at the arch's own capacity factor prints the dropped
    share.  Returns the main path's launches of kernels 5 and 6."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves
    counts = cuda_lib.LAUNCHES
    kinds = T.layer_plan(cfg).all_layers()
    n_attn = sum(k[0] in ("attn", "gattn", "shared_attn") for k in kinds)
    n_ssd = sum(k[0] in ("mamba", "shared_attn") for k in kinds)
    n_moe = sum(k[1] == "moe" for k in kinds)
    a = cfg.attn
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in tree_leaves(params))
    blocks = (f"{sum(k[0] == 'mla' for k in kinds)} MLA (kv_lora "
              f"{cfg.mla.kv_lora_rank}, {a.n_heads} heads)" if cfg.mla else
              f"{n_attn} attention ({a.n_heads} heads over {a.n_kv_heads} KV, "
              f"dh {a.d_head}, window {a.window}, softcap {a.logit_softcap})")
    if cfg.moe:
        blocks += (f", {n_moe} MoE ({cfg.moe.n_experts} experts top-"
                   f"{cfg.moe.top_k}, {cfg.moe.n_shared} shared, capacity "
                   f"factor {cfg.moe.capacity_factor})")
    print(f"  {cfg.name}: {n:,} parameters ({n * 4 / 1e9:.2f} GB float32) on the "
          f"card in {time.perf_counter() - t0:.3f} s; {cfg.n_layers} layers, "
          f"{blocks}, {n_ssd} Mamba2; d_model {cfg.d_model}, vocab {cfg.vocab:,}")
    check(n == zoo.param_count(cfg), f"{n} parameters, not {zoo.param_count(cfg)}")
    if cfg.moe:
        active = zoo.param_count(cfg, active_only=True)
        print(f"  active parameters (zoo.param_count(active_only=True): the "
              f"routed experts at top_k / n_experts): {active:,}")
    got = {"swa_decode": 0, "ssd_scan": 0}
    gen = torch.Generator(device=dev).manual_seed(1)
    if n_ssd or cfg.moe:
        got["ssd_scan"] += timed_prefill(torch, dev, cfg, params, gen, n_ssd)

    # teacher-forced decode (kernel 6) against forward (plain attention)
    b, s = ARCH_SELF_CHECK
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen)
    check_cfg = cfg if not cfg.moe else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    fwd_routes, dec_routes = [], []
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_routes(fwd_routes):
        full, aux = T.forward(check_cfg, params, {"tokens": tokens}, remat=False)
    check(counts["ssd_scan"] == n_ssd, f"forward: {counts['ssd_scan']} "
          f"ssd_scan launches, not {n_ssd}")
    got["ssd_scan"] += counts["ssd_scan"]
    step = make_serve_step(check_cfg)
    cache = T.init_cache(check_cfg, b, s, device=dev)
    errs = []
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    with recorded_routes(dec_routes):
        for i in range(s):
            logits, cache = step(params, cache, {"tokens": tokens[:, i:i + 1],
                                                 "pos": i})
            errs.append((logits[:, 0, :cfg.vocab]
                         - full[:, i, :cfg.vocab]).abs().amax(-1))
    errs = torch.stack(errs, 1)                   # [B, S]
    t2 = time.perf_counter()
    check(bool(torch.isfinite(full).all()), "non-finite forward logits")
    compared = ""
    if cfg.moe:
        c = moe.capacity(b * s, check_cfg.moe)
        print(f"  self-check at capacity factor {check_cfg.moe.capacity_factor:g} "
              f"(C = {c} slots an expert for T = {b * s}): forward's dropped share "
              f"{float(aux[2]):g}, load balance {float(aux[0]):.4f}, z-loss "
              f"{float(aux[1]):.4f} (summed over {n_moe} MoE layers)")
        check(float(aux[2]) == 0.0, f"forward at C = {c} dropped tokens")
        upto = first_route_flips(torch, fwd_routes, dec_routes, b, s)
        share = sum(upto) / (b * s)
        compared = f", compared up to each row's first route flip ({upto}: {share:.3f} of the positions)"
        check(share >= COMPARED_SHARE, f"only {share:.3f} of the positions "
              f"compared before the first route flips")
        errs = torch.cat([errs[r, :p] for r, p in enumerate(upto)])
    err = float(errs.max())
    print(f"  teacher-forced decode vs forward, B={b} S={s}: max|logits| "
          f"{float(full[..., :cfg.vocab].abs().max()):.3f}, max error {err:.3e} "
          f"(tol {SELF_CHECK_TOL:g}){compared} in {t2 - t0:.3f} s "
          f"({(t2 - t1) / s * 1e3:.3f} ms a step); swa_decode launches "
          f"{counts['swa_decode']} ({s} x {n_attn})")
    check(err <= SELF_CHECK_TOL, f"decode differs from forward by {err}")
    check(counts["swa_decode"] == s * n_attn and counts["ssd_scan"] == 0,
          f"decode: {counts['swa_decode']} swa_decode launches, not {s} x "
          f"{n_attn}, and {counts['ssd_scan']} ssd_scan")
    got["swa_decode"] += counts["swa_decode"]
    del full, cache, logits, fwd_routes, dec_routes
    if cfg.moe:                      # the arch's own capacity factor drops
        _, aux = T.forward(cfg, params, {"tokens": tokens}, remat=False)
        print(f"  forward at the arch's capacity factor "
              f"{cfg.moe.capacity_factor:g} (C = {moe.capacity(b * s, cfg.moe)} "
              f"slots an expert for T = {b * s}): dropped share "
              f"{float(aux[2]) / n_moe:.5f} of the (token, slot) pairs, mean "
              f"over {n_moe} MoE layers")

    gen_len = SERVE_GENS[0]
    reqs = serve_requests(cfg, gen_len)
    server = BatchedServer(cfg, params, 4, cache_len=64 + gen_len, device=dev)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    stats = server.run(reqs)
    steps = stats["decode_steps"]
    step_ms = stats["wall_s"] / steps * 1e3
    print(f"  BatchedServer batch 4, cache_len {64 + gen_len}, 8 requests x "
          f"{gen_len} new tokens: {stats['tokens']} tokens in "
          f"{stats['wall_s']:.3f} s, {stats['tok_per_s']:.1f} tok/s, {steps} "
          f"decode steps, {step_ms:.3f} ms per step; "
          f"swa_decode launches {counts['swa_decode']} ({steps} x {n_attn})")
    print(f"  completions (first 8 tokens): {stats['completions']}")
    check(stats["requests"] == 8 and all(len(r.out) == gen_len for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          f"{cfg.name}: incomplete completions or a token outside the vocabulary")
    check(counts["swa_decode"] == steps * n_attn and counts["ssd_scan"] == 0,
          f"{cfg.name}: {counts['swa_decode']} swa_decode launches, not "
          f"{steps} x {n_attn}")
    got["swa_decode"] += counts["swa_decode"]
    if cfg.moe:       # the dense dispatch reads every expert at every step
        bound = n * 4 / HBM_BYTES_PER_S * 1e3
        print(f"  a decode step reads every weight ({n * 4 / 1e9:.2f} GB: the "
              f"dense dispatch runs all {cfg.moe.n_experts} experts' products "
              f"on their 8 slots): bound {bound:.3f} ms at "
              f"{HBM_BYTES_PER_S / 1e12:g} TB/s; the served step at "
              f"{bound / step_ms:.3f} of it")
    last = max(len(r.prompt) for r in reqs[4:]) + gen_len
    profile_decode(torch, dev, cfg, params, server.cache, last, server.b,
                   "swa_decode" if n_attn else None)
    return got


def run_archs(torch, dev, card_line: str) -> dict:
    """Phase [13]: h2o-danube-3-4b, phi3-medium-14b, gemma2-27b (24 of 46
    layers), zamba2-7b, deepseek-v2-lite-16b and llama4-scout-17b-a16e (4
    of 48 layers) at full width, one after the other, each's weights freed
    before the next's.  Returns the launches of kernels 5 and 6 on their
    main paths."""
    import gc
    from repro_torch.configs import get_arch
    t_phase = time.perf_counter()
    launches = {"swa_decode": 0, "ssd_scan": 0}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {card_line}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated before the phase")
    for name, cut in ARCH_RUNS:
        t0 = time.perf_counter()
        cfg = get_arch(name)
        if cut:
            print(f"  {name}: cut to {cut} of its {cfg.n_layers} layers (its "
                  f"{cfg.n_params() * 4 / 1e9:.2f} GB of float32 weights do "
                  f"not fit the card)")
            cfg = dataclasses.replace(cfg, n_layers=cut)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            got = run_arch(torch, dev, cfg)
        for k in launches:
            launches[k] += got[k]
        peak = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  {name}: peak device memory {peak:.2f} GiB; "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB left allocated")
    print(f"  phase [13] {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------- closed loop

@contextlib.contextmanager
def wrapped(module, name: str, wrapper):
    """``module.name`` replaced by ``wrapper(original)`` inside the block."""
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def captured_operands(record: dict, operands_round):
    """A wrapper for ``quantized_aggregate_pytree`` that keeps the
    operands of its call number ``operands_round`` in ``record``
    ("operands": the stacked gradients, coefficients, widths and the
    noise the wrapper would draw from its generators; "round").  That
    call gets the noise passed in, so the path computes what it does
    alone."""
    from repro_torch.kernels.masked_aggregate import ops as agg_ops

    def quantized(orig):
        calls = [0]

        def run(gstack, coef, bits, *, generator=None, noise=None):
            if calls[0] == operands_round:
                if noise is None:
                    noise = agg_ops.uniform_noise_like(gstack, generator)
                record["operands"] = (gstack, coef, bits, noise)
                record["round"] = operands_round
                generator = None
            calls[0] += 1
            return orig(gstack, coef, bits, generator=generator, noise=noise)
        return run
    return quantized


def closed_loop_grid(torch, dev, cfg, record: dict, operands_round=None):
    """``run_closed_loop_grid`` on ``dev`` with its control trace, the
    quantised sweep's arguments and (at ``operands_round``) one round's
    operands of the quantised eq.-4 sum recorded in ``record``.  The
    recording only keeps references: the path runs as it does alone."""
    from repro_torch.fl import closed_loop as cl
    from repro_torch.fl import scan_engine

    def solve_rounds(orig):
        def run(problem, *a, **kw):
            record["problem"] = problem
            record["trace"] = orig(problem, *a, **kw)
            return record["trace"]
        return run

    def sweep(orig):
        def run(plans, *a, **kw):
            if plans.bits is not None:
                record["qsweep"] = (plans, a, kw)
            return orig(plans, *a, **kw)
        return run

    with wrapped(cl, "solve_rounds", solve_rounds), \
            wrapped(cl, "run_fl_sweep", sweep), \
            wrapped(scan_engine, "quantized_aggregate_pytree",
                    captured_operands(record, operands_round)):
        return cl.run_closed_loop_grid(cfg, device=dev)


def print_grid(out: dict, label: str, tag: str) -> None:
    from repro_torch.fl.closed_loop import format_closed_loop_table
    svc, sec = out["control"]["service"], out["seconds"]
    for line in format_closed_loop_table(out).splitlines():
        print(f"  {line}")
    print(f"  {label}: control plane warm share {svc['warm_fraction']:.4f}, "
          f"inner iters {out['control']['inner_iters']}, outer iters "
          f"{out['control']['outer_iters']}, p50 "
          f"{svc['p50_latency_s'] * 1e3:.3f} ms, p99 "
          f"{svc['p99_latency_s'] * 1e3:.3f} ms {tag}")
    print(f"  {label}: wall {sum(sec.values()):.3f} s = control "
          f"{sec['control']:.3f} + planning {sec['planning']:.3f} + sweep "
          f"{sec['sweep']:.3f} + quantised sweep {sec['quantized_sweep']:.3f} "
          f"s {tag}")


def check_grid(out: dict, label: str, trained: bool = True) -> None:
    """Every strategy reported, every value finite, accuracy in [0, 1];
    with ``trained``, every strategy had participants."""
    import numpy as np
    from repro_torch.fl.closed_loop import CLOSED_LOOP_STRATEGIES
    check(list(out["strategies"]) == list(CLOSED_LOOP_STRATEGIES),
          f"{label}: strategies {list(out['strategies'])}")
    for name, row in out["strategies"].items():
        check(all(np.isfinite(v) for v in row.values())
              and 0.0 <= row["final_acc"] <= 1.0,
              f"{label}: {name} reported {row}")
        check(not trained or row["mean_participants"] > 0,
              f"{label}: {name} trained nobody")


def one_round(plans, cfg):
    """A stacked plan and its config cut to the first round."""
    per_round = ("probs", "tx_time", "round_energy", "batch_idx", "masks",
                 "drops", "bits")
    return (dataclasses.replace(plans, **{
        f: getattr(plans, f)[:, :1] for f in per_round
        if getattr(plans, f) is not None}),
        dataclasses.replace(cfg, n_rounds=1, eval_every=1))


def check_closed_loop_operands(torch, record: dict, tag: str) -> None:
    """The scale kernel and kernel 4 on the faulted joint_bits sweep's own
    operands of one round: the stacked client gradients, the coefficients
    (zero where an upload was attempted and lost) and the width table,
    against their plain versions with the same noise, and timed beside
    the function's bound (one read of every row for its scale, then g
    and noise of the rows with a nonzero coefficient)."""
    from repro_torch.kernels.masked_aggregate import ref as agg_ref
    from repro_torch.tree import tree_leaves
    gstack, coef, bits, noise = record["operands"]
    plans = record["qsweep"][0]
    k = CLOSED_LOOP_OPERANDS_ROUND
    attempted = plans.masks[:, k].to(coef.device)
    lost = attempted & plans.drops[:, k].to(coef.device)
    check(int(lost.sum()) > 0 and bool((coef[lost] == 0).all())
          and bool((coef[attempted & ~lost] > 0).all()),
          "the faulted round's coefficients are not zero exactly where "
          "uploads were lost")
    t, n = coef.shape
    levels = agg_ref.quantizer_levels(bits).contiguous()
    leaves = [(g.reshape(t, n, -1).contiguous(), u.reshape(t, n, -1).contiguous())
              for g, u in zip(tree_leaves(gstack), tree_leaves(noise))]
    widths = {int(b): int((bits == b).sum()) for b in bits.unique().tolist()}
    time_quant_round(
        torch, f"the faulted joint_bits round {k}'s operands (widths {widths}, "
        f"{int(lost.sum())} uploads lost with coefficient 0)", leaves,
        coef.contiguous(), levels, tag)


def run_closed_loop(torch, dev, card_line: str) -> dict:
    """The drift-aware closed loop (``repro_torch.fl.closed_loop``) at
    drifting_metro's registered size, all six strategies, the paper's CNN:
    on the card with every launch count zeroed just before it, against
    the port's own CPU run of the same config, under a fault plan with a
    crash after round 9 and a resume on a fresh service, kernel 4 on the
    faulted sweep's operands, and the four entry points of the slice."""
    import numpy as np
    from repro_torch import (closed_loop_demo, compression_study, fading_rounds,
                             quickstart)
    from repro_torch.fl import closed_loop as cl
    from repro_torch.fl.scan_engine import run_fl_sweep
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve import FaultPlan, FleetControlService
    tag = f"[{card_line}]"
    t_phase = time.perf_counter()
    cfg = cl.ClosedLoopConfig(**CLOSED_LOOP, n_seeds=CLOSED_LOOP_SEEDS)
    print(f"  drifting_metro N={cfg.n_devices} K={cfg.n_rounds} coherence "
          f"{cfg.coherence}, {len(cl.CLOSED_LOOP_STRATEGIES)} strategies x "
          f"{cfg.n_seeds} seeds, {cfg.n_train} training images, the "
          f"199,213-parameter CNN")

    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    card_rec: dict = {}
    card = closed_loop_grid(torch, dev, cfg, card_rec)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print_grid(card, "card", tag)
    print(f"  launches on the closed loop's path: {launches}")
    check_grid(card, "card")
    want = 8 * cfg.n_rounds
    for name in ("row_scale", "quantized_masked_aggregate"):
        check(launches[name] == want,
              f"{name} launched {launches[name]} times, not {want}")

    t0 = time.perf_counter()
    cpu_rec: dict = {}
    cpu = closed_loop_grid(torch, torch.device("cpu"), cfg, cpu_rec)
    t_cpu = time.perf_counter() - t0
    a_err = float((card_rec["trace"].a - cpu_rec["trace"].a).abs().max())
    p_err = float((card_rec["trace"].power - cpu_rec["trace"].power).abs().max())
    counts = [tuple(o["control"][k] for k in ("warm_rounds", "inner_iters",
                                              "outer_iters"))
              for o in (card, cpu)]
    rel = {k: max(abs(card["strategies"][s][k] - cpu["strategies"][s][k])
                  / max(abs(cpu["strategies"][s][k]), 1e-30)
                  for s in cpu["strategies"]) for k in CLOSED_LOOP_GATED}
    sec = cpu["seconds"]
    print(f"  the CPU run: control {sec['control']:.3f} + planning "
          f"{sec['planning']:.3f} + sweep {sec['sweep']:.3f} + quantised sweep "
          f"{sec['quantized_sweep']:.3f} s")
    print(f"  card against the CPU run ({t_cpu:.1f} s on the host): control "
          f"trace max|a| {a_err:.3e}, max|P*| {p_err:.3e}; (warm, inner, "
          f"outer) {counts[0]} vs {counts[1]}; worst relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + "; final_acc " + ", ".join(
              f"{s} {card['strategies'][s]['final_acc']:.4f}/"
              f"{cpu['strategies'][s]['final_acc']:.4f}"
              for s in cpu["strategies"]))
    check(a_err <= CLOSED_LOOP_TOL and p_err <= CLOSED_LOOP_TOL,
          f"the card's control trace differs from the CPU's ({a_err}, {p_err})")
    check(counts[0] == counts[1], f"control counts differ: {counts}")
    for k, v in rel.items():
        check(v <= CLOSED_LOOP_TOL, f"{k} differs from the CPU run by {v}")

    plans, args, kw = card_rec["qsweep"]
    plan1, cfg1 = one_round(plans, args[2])

    def qround(_k):
        run_fl_sweep(plan1, args[0], args[1], cfg1, args[3], **kw)
    qround(0)
    profile_run(torch, f"closed loop: one round of the quantised sweep "
                f"({plans.probs.shape[0]} trajectories, incl. one evaluation)",
                qround, 1, "round", "quantized_masked_aggregate")

    # faults and a crash: the control pass dies after round 9, and the
    # faulted grid resumes it from the checkpoint on a fresh service
    fcfg = dataclasses.replace(cfg, fault_plan=FaultPlan(**CLOSED_LOOP_FAULTS))
    problem = cl._faulted_problem(fcfg)
    whole = cl.solve_rounds(problem, FleetControlService(fcfg.service,
                                                         device=dev))
    with tempfile.TemporaryDirectory() as ckpt:
        svc = FleetControlService(fcfg.service, device=dev)
        orig, calls = svc.run, [0]

        def crashy(reqs=None):
            if calls[0] >= CLOSED_LOOP_CRASH:
                raise RuntimeError("simulated crash")
            calls[0] += 1
            return orig(reqs)
        svc.run = crashy
        try:
            cl.solve_rounds(problem, svc, checkpoint_dir=ckpt)
            fail("the crashing control pass did not crash")
        except RuntimeError as exc:
            check("simulated crash" in str(exc), f"unexpected error {exc}")
        frec: dict = {}
        faulted = closed_loop_grid(
            torch, dev, dataclasses.replace(fcfg, checkpoint_dir=ckpt), frec,
            operands_round=CLOSED_LOOP_OPERANDS_ROUND)
    resumed = frec["trace"]
    same = (torch.equal(resumed.a, whole.a)
            and torch.equal(resumed.power, whole.power))
    counts = [(t.warm_rounds, t.inner_iters, t.outer_iters)
              for t in (resumed, whole)]
    print_grid(faulted, "faulted", tag)
    print(f"  faults {fcfg.fault_plan}: {faulted['faults']['n_unhealthy_devices']} "
          f"devices corrupted, {faulted['control']['service']['unhealthy_devices']} "
          f"sanitised at submit; crash after round {CLOSED_LOOP_CRASH - 1}, "
          f"resumed on a fresh service solving "
          f"{resumed.service.stats.n_solved} rounds: trace equal to the "
          f"uninterrupted card run {same}, (warm, inner, outer) {counts[0]} "
          f"vs {counts[1]}")
    check_grid(faulted, "faulted")
    check(same and counts[0] == counts[1],
          "the resumed control trace differs from the uninterrupted one")
    check(resumed.service.stats.n_solved == fcfg.n_rounds - CLOSED_LOOP_CRASH,
          "the resume solved the wrong number of rounds")
    check(faulted["faults"]["n_unhealthy_devices"] > 0, "no device corrupted")
    check_closed_loop_operands(torch, frec, tag)
    t_grid = time.perf_counter() - t_phase

    def driven(name, run):
        """``run()`` with the launch counts zeroed just before it; its
        result, its seconds and the kernels it launched."""
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        runs[name] = (time.perf_counter() - t0,
                      {k: v for k, v in cuda_lib.LAUNCHES.items() if v})
        return res

    runs: dict = {}
    demo = driven("closed_loop_demo", lambda: closed_loop_demo.main([]))
    check_grid(demo, "closed_loop_demo", trained=False)
    driven("fading_rounds", lambda: fading_rounds.main([]))
    qs = driven("quickstart", lambda: quickstart.main([]))
    check(np.isfinite(qs["history"].eval_acc).all()
          and qs["history"].participants.sum() > 0, "quickstart trained nobody")
    # compression_study at its reference sizes (3 x 150 rounds, about
    # 12 s on the card) while phase [10] stays within its 60 s budget
    budget = 60.0 - (time.perf_counter() - t_phase)
    study_args = [] if budget >= 15.0 else ["--rounds", "30", "--eval-every", "10"]
    with tempfile.TemporaryDirectory() as out_dir:
        study = driven("compression_study", lambda: compression_study.main(
            study_args + ["--out", str(Path(out_dir) / "compression_study.json")]))
    check(sorted(study) == [4, 8, 32] and all(
        math.isfinite(r["final_acc"]) for r in study.values()),
        "compression_study failed")
    # its 32-bit width sums through kernel 3 and its 8 and 4 through kernel
    # 4, one launch a leaf in each round that has a participant
    study_rounds = 150 if not study_args else 30
    got = runs["compression_study"][1]
    n3, n4 = got.get("masked_aggregate", 0), got.get("quantized_masked_aggregate", 0)
    check(0 < n3 <= 8 * study_rounds and n3 % 8 == 0
          and 0 < n4 <= 2 * 8 * study_rounds and n4 % 8 == 0
          and got.get("row_scale", 0) == n4,
          f"compression_study launched {got}: kernel 3, kernel 4 and the "
          f"scale kernel not all on its path, 8 leaves a round")
    print("  entry points, each with the launch counts zeroed just before it: "
          + "; ".join(f"{name} {sec:.1f} s, launches {counts}"
                      for name, (sec, counts) in runs.items())
          + f" (compression_study "
          f"{'at its reference sizes' if not study_args else 'cut to ' + ' '.join(study_args)}) {tag}")
    print(f"  phase [10] {time.perf_counter() - t_phase:.1f} s (grids, "
          f"checks and profile {t_grid:.1f} s)")
    return dict(launches=launches)


# ----------------------------------------------------------------- training

def recorded_steps(record: list):
    """A wrapper for ``make_train_step`` whose steps append their loss and
    grad_norm to ``record``."""
    def wrap(orig):
        def make(*a, **k):
            step, opt = orig(*a, **k)

            def run(params, opt_state, batch):
                out = step(params, opt_state, batch)
                record.append((float(out[2]["loss"]), float(out[2]["grad_norm"])))
                return out
            return run, opt
        return make
    return wrap


def recorded_draws(record: list):
    """A wrapper for ``ProbabilisticScheduler.sample`` that keeps each
    draw's mask and powers as host arrays."""
    def wrap(orig):
        def sample(self, state, generator, k=0):
            draw = orig(self, state, generator, k)
            record.append((draw.mask.cpu().numpy(), draw.power.cpu().numpy()))
            return draw
        return sample
    return wrap


def adam_apart_bound(steps: int, lr: float = TRAIN_LR) -> float:
    """The most one parameter can part between two AdamW runs (betas
    ADAM_BETAS) from the same start after ``steps`` steps, whatever their
    gradients: step t's update is at most lr U_t in size, U_t = (1 - b1)
    / (1 - b1^t) sqrt(sum_{j<t} (b1^2 / b2)^j) sqrt((1 - b2^t) / (1 - b2))
    (Cauchy-Schwarz on the bias-corrected moments; U_1 = 1), so two runs
    part by at most 2 lr sum_t U_t; decoupled weight decay only shrinks
    the gap."""
    b1, b2 = ADAM_BETAS
    total = 0.0
    for t in range(1, steps + 1):
        total += ((1 - b1) / (1 - b1 ** t)
                  * math.sqrt(sum((b1 * b1 / b2) ** j for j in range(t)))
                  * math.sqrt((1 - b2 ** t) / (1 - b2)))
    return 2 * lr * total


def params_apart(torch, got, want, steps: int,
                 limit: float | None = None) -> tuple[float, float]:
    """(largest |difference|, share of the elements beyond
    TRAIN_PARAM_ATOL) of two parameter trees, checked against ``limit``,
    by default the step tolerance after ``steps`` steps."""
    from repro_torch.tree import tree_leaves
    big = apart = total = 0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a.cpu() - b.cpu()).abs()
        big = max(big, float(d.max()))
        apart += int((d > TRAIN_PARAM_ATOL).sum())
        total += d.numel()
    limit = steps * TRAIN_LR if limit is None else limit
    check(big <= limit and apart <= TRAIN_PARAM_SHARE * total,
          f"parameters apart by up to {big:.3e} (limit {limit:.3e}), "
          f"{apart / total:.2e} of them beyond {TRAIN_PARAM_ATOL:g}")
    return big, apart / total


def train_card_against_cpu(torch, dev, tag: str) -> None:
    """(a) The driver at demo-100m's full width on the card against its
    own CPU run: the same seeded parameters, the card's draws handed to
    the CPU run, the loss and grad_norm of every step and the parameters
    at the end held at the CPU tests' tolerances."""
    from repro_torch.configs import get_arch
    from repro_torch.core import schedulers
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = get_arch("demo-100m")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    draws, steps, cpu_steps = [], [], []
    t0 = time.perf_counter()
    with wrapped(schedulers.ProbabilisticScheduler, "sample", recorded_draws(draws)), \
            wrapped(train, "make_train_step", recorded_steps(steps)):
        card = train.run(train.parse_args(TRAIN_CARD_CPU), params=params)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    with wrapped(train, "make_train_step", recorded_steps(cpu_steps)):
        cpu = train.run(train.parse_args(TRAIN_CARD_CPU + ["--device", "cpu"]),
                        draws=draws, params=host)
    t_cpu = time.perf_counter() - t0
    n = len(steps)
    check(n == len(cpu_steps) == 3, f"{n} steps on the card, {len(cpu_steps)} "
          f"on the CPU")
    for k, ((loss, gn), (c_loss, c_gn)) in enumerate(zip(steps, cpu_steps)):
        check(math.isfinite(loss) and abs(loss / c_loss - 1) <= TRAIN_LOSS_RTOL
              and abs(gn / c_gn - 1) <= TRAIN_GNORM_RTOL,
              f"step {k + 1}: loss {loss} / {c_loss}, grad_norm {gn} / {c_gn}")
    for a, b in zip(card["history"], cpu["history"]):
        check(abs(a["sim_time_s"] / b["sim_time_s"] - 1) <= SOLVE_TOL
              and abs(a["sim_energy_j"] / b["sim_energy_j"] - 1) <= SOLVE_TOL,
              f"sim time/energy apart at step {a['step']}: {a} / {b}")
    big, share = params_apart(torch, card["params"], cpu["params"], n)
    print(f"  (a) demo-100m full width, B=2 S=64, 3 steps, card against CPU: "
          f"losses {[round(x[0], 6) for x in steps]} / "
          f"{[round(x[0], 6) for x in cpu_steps]}, largest relative loss gap "
          f"{max(abs(a[0] / b[0] - 1) for a, b in zip(steps, cpu_steps)):.2e} "
          f"(tol {TRAIN_LOSS_RTOL:g}), grad_norm gap "
          f"{max(abs(a[1] / b[1] - 1) for a, b in zip(steps, cpu_steps)):.2e} "
          f"(tol {TRAIN_GNORM_RTOL:g}); parameters apart by up to {big:.3e} "
          f"(tol {n} x lr = {n * TRAIN_LR:g}), {share:.2e} of them beyond "
          f"{TRAIN_PARAM_ATOL:g} (tol {TRAIN_PARAM_SHARE:g}); card {t_card:.1f} s, "
          f"CPU {t_cpu:.1f} s {tag}")


@contextlib.contextmanager
def deterministic(torch):
    """torch's deterministic algorithms (cuBLAS's workspace set for them)
    inside the block."""
    import os
    key = "CUBLAS_WORKSPACE_CONFIG"
    old = os.environ.get(key)
    os.environ[key] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


def train_driver(torch, dev, tag: str) -> dict:
    """(b) ``repro_torch.launch.train`` at its defaults on the card for
    TRAIN_STEPS steps with a checkpoint at TRAIN_CKPT, then resumed from
    that checkpoint in a second run: the restored state equals the saved
    one and the continued run the uninterrupted one, bit for bit (both
    under deterministic algorithms); every logged loss finite; the step
    time, tokens/s and a profile of TRAIN_PROFILED steps."""
    import numpy as np
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.checkpoint.checkpoint import _leaves_with_path
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    base = ["--arch", "demo-100m", "--steps", str(TRAIN_STEPS),
            "--ckpt-every", str(TRAIN_CKPT)]
    print(f"  (b) the driver at its defaults (demo-100m, B=16 S=256, 64 "
          f"clients, tau 2.0), {TRAIN_STEPS} steps: cut from "
          f"{TRAIN_DEFAULT_STEPS} for the phase's time; checkpoint at step "
          f"{TRAIN_CKPT}, then resumed from it")
    with tempfile.TemporaryDirectory() as whole_dir, \
            tempfile.TemporaryDirectory() as part_dir, deterministic(torch):
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        whole = train.run(train.parse_args(base + ["--ckpt-dir", whole_dir]))
        torch.cuda.synchronize()
        t_whole = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        check(not launches, f"the training path launched {launches}")
        for suffix in ("json", "npz"):
            name = f"ckpt_{TRAIN_CKPT:08d}.{suffix}"
            (Path(part_dir) / name).write_bytes((Path(whole_dir) / name).read_bytes())
        step0, params, opt_state, _ = ckpt.restore(
            part_dir, params_template=whole["params"],
            opt_template=whole["opt_state"])
        stem = Path(part_dir) / f"ckpt_{TRAIN_CKPT:08d}"
        saved = np.load(f"{stem}.npz")
        trees = json.loads(Path(f"{stem}.json").read_text())["trees"]
        pairs = [(trees[name][key], t) for name, tree in (("params", params),
                                                          ("opt", opt_state))
                 for key, t in _leaves_with_path(tree)]
        check(step0 == TRAIN_CKPT and len(pairs) == sum(map(len, trees.values()))
              and all(np.array_equal(t.cpu().numpy(), saved[arr])
                      for arr, t in pairs),
              "the restored state differs from the saved one")
        t0 = time.perf_counter()
        resumed = train.run(train.parse_args(base + ["--ckpt-dir", part_dir,
                                                     "--resume"]))
        t_resumed = time.perf_counter() - t0
    tail = [h for h in whole["history"] if h["step"] > TRAIN_CKPT]
    check(resumed["history"] == tail,
          f"the resumed run's history differs: {resumed['history'][:2]} / {tail[:2]}")
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((resumed["params"], resumed["opt_state"])),
        tree_leaves((whole["params"], whole["opt_state"]))))
    check(same, "the resumed run's parameters or moments differ")
    losses = [h["loss"] for h in whole["history"]]
    check(all(math.isfinite(x) for x in losses), f"a non-finite loss: {losses}")
    step_s = whole["step_s"][TRAIN_TIMED_FROM - 1:]
    med = float(np.median(step_s))
    tokens = 16 * 256
    print(f"  uninterrupted: {TRAIN_STEPS} steps in {t_whole:.1f} s, losses "
          f"{[round(x, 4) for x in losses]}; resumed at step {step0}: "
          f"{TRAIN_STEPS - TRAIN_CKPT} steps in {t_resumed:.1f} s, restored "
          f"state and the continued history, parameters and moments equal "
          f"bit for bit; launches on the path: none")
    print(f"  step time (median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS}, "
          f"deterministic algorithms, the round's host work included): "
          f"{med * 1e3:.3f} ms (min {min(step_s) * 1e3:.3f}, max "
          f"{max(step_s) * 1e3:.3f}), {tokens / med:.0f} tokens/s {tag}")
    # the same driver without deterministic algorithms, for their cost
    quick = train.run(train.parse_args(base[:2] + [
        "--steps", str(TRAIN_TIMED_FROM + TRAIN_FREE_STEPS)]))
    free = float(np.median(quick["step_s"][TRAIN_TIMED_FROM - 1:]))
    print(f"  without deterministic algorithms (median of steps "
          f"{TRAIN_TIMED_FROM}-{TRAIN_TIMED_FROM + TRAIN_FREE_STEPS}): "
          f"{free * 1e3:.3f} ms, {tokens / free:.0f} tokens/s {tag}")

    # where a step's time goes: TRAIN_PROFILED steps of make_train_step on
    # the driver's batches, outside deterministic mode
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_train_step
    cfg = get_arch("demo-100m")
    step, _ = make_train_step(cfg, lr=TRAIN_LR, q_chunk=256)
    data = SyntheticLMData(64, cfg.vocab, seed=1)
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(TRAIN_PROFILED):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(rng.integers(0, 64, 16), 256).items()}
        b["loss_weights"] = torch.full((16,), 1 / 16, device=dev)
        batches.append(b)
    state = [whole["params"], whole["opt_state"]]

    def steps_fn(_):
        for b in batches:
            state[0], state[1], _m = step(state[0], state[1], b)
    steps_fn(0)
    profile_run(torch, f"demo-100m train step (B=16 S=256) {tag}", steps_fn,
                TRAIN_PROFILED, "step", None)
    return dict(step_ms=med * 1e3)


def train_gemma3(torch, dev, tag: str) -> None:
    """(c) gemma3-1b at full width: GEMMA3_TRAIN steps, each step's loss
    equal to ``lm_loss`` recomputed without autograd on the same pre-step
    parameters (remat recomputes what the forward computed), finite
    grad_norm, the peak device memory."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.launch.steps import cast_bf16, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models import zoo
    from repro_torch.tree import tree_leaves
    b, s, n_steps = GEMMA3_TRAIN
    cfg = get_arch("gemma3-1b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n = sum(x.numel() for x in tree_leaves(params))
    check(n == zoo.param_count(cfg), f"{n} parameters")
    step, opt = make_train_step(cfg, lr=TRAIN_LR, q_chunk=max(s, 128))
    opt_state = opt.init(params)
    data = SyntheticLMData(64, cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    rows = []
    for k in range(n_steps):
        batch = {key: torch.from_numpy(v).to(dev) for key, v in
                 data.batch(rng.integers(0, 64, b), s).items()}
        batch["loss_weights"] = torch.full((b,), 1 / b, device=dev)
        with torch.no_grad():
            want, _ = zoo.lm_loss(cfg, cast_bf16(params), batch, q_chunk=max(s, 128),
                                  remat=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        rows.append((loss, float(want), gn, time.perf_counter() - t0))
        check(math.isfinite(loss) and math.isfinite(gn),
              f"gemma3-1b step {k + 1}: loss {loss}, grad_norm {gn}")
        check(abs(loss / float(want) - 1) <= TRAIN_LOSS_RTOL,
              f"gemma3-1b step {k + 1}: the step's loss {loss} against "
              f"lm_loss without autograd {float(want)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  (c) gemma3-1b full width ({n:,} parameters), B={b} S={s}, "
          + "; ".join(f"step {k + 1}: loss {a:.6f} (no-grad lm_loss {w:.6f}, "
                      f"rel {abs(a / w - 1):.2e}), grad_norm {g:.4f}, "
                      f"{t * 1e3:.1f} ms" for k, (a, w, g, t) in enumerate(rows))
          + f"; peak device memory {peak:.2f} GiB {tag}")
    del params, opt_state, m


def mixer_launches(cfg, steps: int) -> tuple[int, int]:
    """Kernel 5's (forward, backward) wrapper calls over ``steps`` train
    steps: every Mamba2 mixer runs its backward once a step, and its
    forward once, or twice in a stacked unit (remat "full" runs the
    unit's forward again in the backward)."""
    from repro_torch.models import transformer as T
    plan = T.layer_plan(cfg)

    def mixers(kinds):
        return sum(k[0] in ("mamba", "shared_attn") for k in kinds)
    stacked = plan.reps * mixers(plan.unit)
    alone = mixers(plan.prefix) + mixers(plan.tail)
    return steps * (2 * stacked + alone), steps * (stacked + alone)


def train_swa_guard(torch, dev) -> None:
    """Kernel 6, which has no backward, refuses autograd on the card."""
    from repro_torch.kernels.swa_decode import ops
    q, k, v = decode_operands(torch, dev, 2, 64, 1, 4, 64, seed=0)
    pos = ring_positions(torch, 64, 70, dev)
    try:
        ops.swa_decode(q.clone().requires_grad_(True), k, v, pos, 70, window=None)
    except NotImplementedError as e:
        print(f"  kernel 6 under autograd on the card raises "
              f"NotImplementedError: {e}")
    else:
        fail("swa_decode ran under autograd on the card, without a backward")


def train_ssd_bwd(torch, dev) -> float:
    """(d1) The backward kernel against the plain backward at
    mamba2-780m's widths, its layer-0 operands from the full-width model."""
    cfg, params = init_mamba2(torch, dev)
    err = check_ssd_bwd(torch, dev, cfg, params)
    del params
    return err


def train_against_cpu(torch, dev, cfg, shape, label: str, tag: str) -> dict:
    """``steps`` train steps of ``cfg`` (``shape`` = (B, S, steps)) on the
    card and on the CPU from the same seeded parameters and the driver's
    synthetic batches, with random loss weights summing to 1: each
    step's loss and grad_norm held at the CPU tests' tolerances, the
    parameters at the end within ``adam_apart_bound`` and all but
    TRAIN_PARAM_SHARE of them within TRAIN_PARAM_ATOL, and kernel 5
    launched as ``mixer_launches`` says.  Returns the card's launch
    counts."""
    import numpy as np
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_map
    b, s, steps = shape
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    n = sum(x.numel() for x in tree_leaves(params))
    step, opt = make_train_step(cfg, lr=TRAIN_LR, q_chunk=max(s, 128))
    state, host_state = opt.init(params), opt.init(host)
    data = SyntheticLMData(64, cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    rows, t_card, t_cpu = [], 0.0, 0.0
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    for k in range(steps):
        batch = {key: torch.from_numpy(v) for key, v in
                 data.batch(rng.integers(0, 64, b), s).items()}
        w = rng.random(b)
        batch["loss_weights"] = torch.from_numpy((w / w.sum()).astype(np.float32))
        t0 = time.perf_counter()
        params, state, m = step(params, state,
                                {key: v.to(dev) for key, v in batch.items()})
        card = (float(m["loss"]), float(m["grad_norm"]))
        t_card += time.perf_counter() - t0
        t0 = time.perf_counter()
        host, host_state, hm = step(host, host_state, batch)
        cpu = (float(hm["loss"]), float(hm["grad_norm"]))
        t_cpu += time.perf_counter() - t0
        rows.append((card, cpu))
        check(math.isfinite(card[0]) and abs(card[0] / cpu[0] - 1) <= TRAIN_LOSS_RTOL
              and abs(card[1] / cpu[1] - 1) <= TRAIN_GNORM_RTOL,
              f"{label} step {k + 1}: loss {card[0]} / {cpu[0]}, grad_norm "
              f"{card[1]} / {cpu[1]}")
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    fwd, bwd = mixer_launches(cfg, steps)
    want = {k: v for k, v in (("ssd_scan", fwd), ("ssd_scan_bwd", bwd)) if v}
    check(launches == want,
          f"{label}: launches {launches}, not {fwd} forward and {bwd} backward")
    limit = adam_apart_bound(steps)
    big, share = params_apart(torch, params, host, steps, limit)
    print(f"  {label} ({n:,} parameters), B={b} S={s}, {steps} steps, card "
          f"against CPU: losses {[round(c[0], 6) for c, _ in rows]} / "
          f"{[round(c[0], 6) for _, c in rows]}, largest relative loss gap "
          f"{max(abs(c[0] / u[0] - 1) for c, u in rows):.2e} (tol "
          f"{TRAIN_LOSS_RTOL:g}), grad_norm gap "
          f"{max(abs(c[1] / u[1] - 1) for c, u in rows):.2e} (tol "
          f"{TRAIN_GNORM_RTOL:g}); parameters apart by up to {big:.3e} (tol "
          f"{limit:.4e}, the most two AdamW runs part in {steps} steps: "
          f"{big / limit:.2f} of it), {share:.2e} of them beyond "
          f"{TRAIN_PARAM_ATOL:g} (tol {TRAIN_PARAM_SHARE:g}); kernel 5 "
          f"launches {launches}; card {t_card:.1f} s, CPU {t_cpu:.1f} s {tag}")
    return launches


def train_mamba2(torch, dev, tag: str) -> dict:
    """(d3) ``repro_torch.launch.train`` at mamba2-780m's full width and
    depth (``MAMBA2_TRAIN``) under deterministic algorithms: kernel 5
    launched as ``mixer_launches`` says; the step time, tokens/s and peak
    memory; then MAMBA2_PROFILED profiled steps outside deterministic
    mode: the idle share and kernel 5's forward and backward device time
    a step.  Returns the run's launch counts."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import SyntheticLMData
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    cfg = get_arch("mamba2-780m")
    b, s = 4, 2048
    with deterministic(torch):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        whole = train.run(train.parse_args(MAMBA2_TRAIN))
        torch.cuda.synchronize()
        t_whole = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
    n_steps = len(whole["step_s"])
    fwd, bwd = mixer_launches(cfg, n_steps)
    check(launches == {"ssd_scan": fwd, "ssd_scan_bwd": bwd},
          f"the mamba2 driver launched {launches}, not {fwd} forward and "
          f"{bwd} backward over {n_steps} steps")
    losses = [h["loss"] for h in whole["history"]]
    check(all(math.isfinite(x) for x in losses), f"a non-finite loss: {losses}")
    step_s = whole["step_s"][MAMBA2_TIMED_FROM - 1:]
    med = float(np.median(step_s))
    rounds = int(MAMBA2_TRAIN[MAMBA2_TRAIN.index("--steps") + 1])
    print(f"  (d3) the driver at mamba2-780m's full width and depth (48 layers), "
          f"B={b} S={s}: {rounds} rounds, {n_steps} of them with a participant "
          f"and so a train step, in {t_whole:.1f} s, losses "
          f"{[round(x, 4) for x in losses]}; launches {launches} "
          f"({fwd // n_steps} forward and {bwd // n_steps} backward wrapper "
          f"calls a step)")
    print(f"  step time (median of trained steps {MAMBA2_TIMED_FROM}-{n_steps}, "
          f"deterministic algorithms, the round's host work included): "
          f"{med * 1e3:.3f} ms (min {min(step_s) * 1e3:.3f}, max "
          f"{max(step_s) * 1e3:.3f}), {b * s / med:.0f} tokens/s; peak device "
          f"memory {peak:.2f} GiB {tag}")

    # where a step's time goes, on the driver's batches, outside
    # deterministic mode
    step, _ = make_train_step(cfg, lr=TRAIN_LR, q_chunk=s)
    data = SyntheticLMData(64, cfg.vocab, seed=1)
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(MAMBA2_PROFILED):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(rng.integers(0, 64, b), s).items()}
        batch["loss_weights"] = torch.full((b,), 1 / b, device=dev)
        batches.append(batch)
    state = [whole["params"], whole["opt_state"]]
    del whole

    def steps_fn(_):
        for batch in batches:
            state[0], state[1], _m = step(state[0], state[1], batch)
    steps_fn(0)            # the allocator settles before the timed call
    kern = profile_run(torch, f"mamba2-780m train step (B={b} S={s}) {tag}",
                       steps_fn, MAMBA2_PROFILED, "step", ("ssd_scan", "ssd_bwd"))
    print(f"  kernel 5 a step: forward {kern['ssd_scan']:.3f} ms "
          f"({2 * cfg.n_layers} wrapper calls), backward {kern['ssd_bwd']:.3f} "
          f"ms ({cfg.n_layers} calls) of device time, {med * 1e3:.3f} ms a "
          f"step {tag}")
    return launches


def train_mamba2_resume(torch, dev, layers: int) -> None:
    """(d3) The driver's resume, at mamba2-780m's full width cut to
    ``layers`` layers (``run(cfg=)``) and MAMBA2_TRAIN's batch and rounds,
    under deterministic algorithms: checkpointed at MAMBA2_TRAIN_CKPT,
    then resumed from it in a second run; the continued history,
    parameters and moments equal the uninterrupted run's bit for bit,
    with at least one step trained after the checkpoint and kernel 5
    launched as ``mixer_launches`` says."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_arch("mamba2-780m"), n_layers=layers)
    args = MAMBA2_TRAIN + ["--ckpt-every", str(MAMBA2_TRAIN_CKPT)]
    with tempfile.TemporaryDirectory() as whole_dir, \
            tempfile.TemporaryDirectory() as part_dir, deterministic(torch):
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        whole = train.run(train.parse_args(args + ["--ckpt-dir", whole_dir]),
                          cfg=cfg)
        torch.cuda.synchronize()
        t_whole = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
        n_steps = len(whole["step_s"])
        fwd, bwd = mixer_launches(cfg, n_steps)
        check(launches == {"ssd_scan": fwd, "ssd_scan_bwd": bwd},
              f"the {layers}-layer mamba2 driver launched {launches}, not "
              f"{fwd} forward and {bwd} backward over {n_steps} steps")
        for path in Path(whole_dir).glob("ckpt_*"):
            if path.name.startswith(f"ckpt_{MAMBA2_TRAIN_CKPT:08d}."):
                path.rename(Path(part_dir) / path.name)
        t0 = time.perf_counter()
        resumed = train.run(train.parse_args(args + ["--ckpt-dir", part_dir,
                                                     "--resume"]), cfg=cfg)
        t_resumed = time.perf_counter() - t0
    tail = [h for h in whole["history"] if h["step"] > MAMBA2_TRAIN_CKPT]
    check(bool(tail), f"the {layers}-layer run trained no step after round "
          f"{MAMBA2_TRAIN_CKPT}")
    check(resumed["history"] == tail,
          f"the resumed run's history differs: {resumed['history'][:2]} / {tail[:2]}")
    same = all(torch.equal(u, v) for u, v in zip(
        tree_leaves((resumed["params"], resumed["opt_state"])),
        tree_leaves((whole["params"], whole["opt_state"]))))
    check(same, "the resumed run's parameters or moments differ")
    n = sum(x.numel() for x in tree_leaves(whole["params"]))
    rounds = int(args[args.index("--steps") + 1])
    print(f"  (d3) the driver's resume at mamba2-780m's full width, {layers} of "
          f"its 48 layers ({n:,} parameters), B=4 S=2048: {rounds} rounds, "
          f"{n_steps} trained, in {t_whole:.1f} s (checkpoints included); "
          f"resumed at round {MAMBA2_TRAIN_CKPT}: {len(resumed['step_s'])} "
          f"steps in {t_resumed:.1f} s, the continued history, parameters and "
          f"moments equal bit for bit; launches {launches}")


def run_training(torch, dev, card_line: str) -> dict:
    """Phase [11]: the training slice (``launch.train``, ``make_train_step``)
    on the card: demo-100m and gemma3-1b run no kernel; mamba2 and zamba2
    run kernel 5 and its backward.  Returns (d3)'s launch counts and (d1)'s
    largest error."""
    from repro_torch.configs import get_arch
    tag = f"[{card_line}]"
    t_phase = time.perf_counter()
    train_swa_guard(torch, dev)
    train_card_against_cpu(torch, dev, tag)
    train_driver(torch, dev, tag)
    train_gemma3(torch, dev, tag)
    t_mamba = parts = time.perf_counter()
    spent = []

    def lap(name: str) -> None:
        nonlocal parts
        now = time.perf_counter()
        spent.append(f"{name} {now - parts:.1f} s")
        parts = now
    err = train_ssd_bwd(torch, dev)
    lap("(d1)")
    layers, b, s, steps = MAMBA2_CARD_CPU
    train_against_cpu(torch, dev, dataclasses.replace(get_arch("mamba2-780m"),
                                                      n_layers=layers),
                      (b, s, steps), f"(d2) mamba2-780m full width, {layers} of "
                      f"its 48 layers", tag)
    lap("(d2)")
    launches = train_mamba2(torch, dev, tag)
    lap("(d3)")
    train_mamba2_resume(torch, dev, layers)
    lap("(d3) resume")
    layers, b, s, steps = ZAMBA2_TRAIN
    train_against_cpu(torch, dev, get_arch("zamba2-7b").reduced(n_layers=layers),
                      (b, s, steps), f"(d4) zamba2-7b reduced(n_layers={layers})",
                      tag)
    lap("(d4)")
    print(f"  phase [11] {time.perf_counter() - t_phase:.1f} s, of it (d) mamba2 "
          f"and zamba2 {time.perf_counter() - t_mamba:.1f} s: {', '.join(spent)}")
    return dict(launches=launches, err=err)


def run_analysis(torch, dev, card_line: str) -> None:
    """Phase [12]: the analysis gate on the card.  The rank-contract sweep,
    then each registered hot path, its launch counts zeroed just before
    it, held to its budgets (``hotpaths.check_budget``)."""
    from repro_torch.analysis import hotpaths
    from repro_torch.analysis.rank import sweep_rank_contract
    from repro_torch.kernels import cuda_lib
    tag = f"[{card_line}]"
    t_phase = time.perf_counter()
    findings, stats = sweep_rank_contract(device=dev)
    check(stats["n_combos"] == 486 and not findings,
          f"rank sweep on the card: {stats['n_combos']} combinations, "
          f"findings: {'; '.join(map(str, findings))}")
    print(f"  rank sweep on {stats['device']}: {stats['n_combos']} "
          f"combinations, leaves {stats['leaves']}, no finding "
          f"({time.perf_counter() - t_phase:.1f} s)")
    budgets = hotpaths.load_budgets()
    check(set(budgets) == set(hotpaths.HOT_PATHS),
          f"budgeted {sorted(budgets)}, registered {sorted(hotpaths.HOT_PATHS)}")
    for name in sorted(hotpaths.HOT_PATHS):
        cuda_lib.reset_launch_counts()
        r = hotpaths.measure(name, dev, reps=ANALYSIS_REPS)
        entry = budgets[name]
        print(f"  {name}: builds/loads warm-up {r['warmup_builds']}/"
              f"{r['warmup_loads']}, steady {r['steady_builds']}/"
              f"{r['steady_loads']}; reads (a) {r['steady_reads']} (form "
              f"{hotpaths.form_value(entry['reads'], r['units'], True)}, "
              f"{r['steady_read_kinds'].get('to_host', 0)} to the host); syncs (b) "
              f"{r['steady_syncs']} (form "
              f"{hotpaths.form_value(entry['syncs'], r['units'])}); "
              f"{r['units']} {r['unit']}; steady call {r['steady_ms']:.3f} ms "
              f"wall (median of {ANALYSIS_REPS}); launches "
              f"{r['steady_launches']} {tag}")
        print(f"    read sites {r['steady_read_sites']}; sync sites "
              f"{r['steady_sync_sites']}")
        failures = hotpaths.check_budget(name, r, entry)
        check(not failures, "; ".join(failures))
        if name in ANALYSIS_KERNEL3:
            got = r["steady_launches"].get("masked_aggregate", 0)
            check(got == ANALYSIS_KERNEL3[name],
                  f"{name}: kernel 3 launched {got} times in the steady "
                  f"call, expected {ANALYSIS_KERNEL3[name]}")
    print(f"  phase [12] {time.perf_counter() - t_phase:.1f} s")


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
    dynamic_smem(cuda_lib.CSRC / "ssd_scan_bwd.cu")
    sass = solve_sass(torch, lib)

    print("[2] kernels against their plain versions" + at(), flush=True)
    errs = check_solvers(torch, dev)
    errs["masked_aggregate"] = check_aggregate(torch, dev)
    errs["quantized_masked_aggregate"], errs["row_scale"] = check_quantized(
        torch, dev)
    errs["swa_decode"] = check_decode(torch, dev)
    mamba2 = init_mamba2(torch, dev)
    errs["ssd_scan"] = check_ssd(torch, dev, *mamba2)

    print("[3] times" + at(), flush=True)
    rec = time_kernels(torch, dev, sass)
    rec["swa_decode"] = time_decode(torch, dev)
    time_softcap_decode(torch, dev)
    # kernel 6 at llama4-scout's odd group, beside its record at gemma3's
    rec["swa_decode"]["at_g5"] = time_llama4_decode(torch, dev)
    rec["ssd_scan"], ssd_ms = time_ssd(torch, dev)
    rec["ssd_scan_bwd"] = time_ssd_bwd(torch, dev)
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
    for name in ("row_scale", "quantized_masked_aggregate"):
        out["launches"][name] = qout["launches"][name]
    # the two kernels' record: the sweep's own round, the device time of
    # its 8 launches (kernel, plain and library alike), the function's bound
    qr = qout["round"]
    errs["row_scale"] = max(errs["row_scale"], qr["scale_err"])
    errs["quantized_masked_aggregate"] = max(
        errs["quantized_masked_aggregate"], qr["err"])
    for name, part, plain, lib in (
            ("row_scale", "scale", "scale_plain", "scale_library"),
            ("quantized_masked_aggregate", "sum", "plain", None)):
        b_ms, b_by = qr["bounds"][part]
        rec[name] = dict(ms=qr["dev"][part], plain_ms=qr["dev"][plain],
                         bound_ms=b_ms, bound_by=b_by,
                         library_ms=qr["dev"][lib] if lib else None)

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

    print("[9] the fleet control plane" + at(), flush=True)
    t9 = time.perf_counter()
    run_control_plane(torch, dev, card_line)
    print(f"  phase [9] {time.perf_counter() - t9:.1f} s")

    print("[10] the drift-aware closed loop" + at(), flush=True)
    run_closed_loop(torch, dev, card_line)

    print("[11] training: demo-100m, gemma3-1b and mamba2-780m at full width, "
          "zamba2-7b reduced" + at(), flush=True)
    trained = run_training(torch, dev, card_line)
    out["launches"]["ssd_scan"] += trained["launches"]["ssd_scan"]
    out["launches"]["ssd_scan_bwd"] = trained["launches"]["ssd_scan_bwd"]
    errs["ssd_scan_bwd"] = trained["err"]

    print("[12] the analysis gate: rank contract, hot-path budgets" + at(),
          flush=True)
    run_analysis(torch, dev, card_line)

    print("[13] the remaining archs at full width: h2o-danube-3-4b, "
          "phi3-medium-14b, gemma2-27b (24 layers), zamba2-7b, "
          "deepseek-v2-lite-16b, llama4-scout-17b-a16e (4 layers)" + at(),
          flush=True)
    for name, n in run_archs(torch, dev, card_line).items():
        out["launches"][name] += n

    sources = {"fused_solve": ("src/repro_torch/csrc/selection_solve.cu",
                               "src/repro/kernels/selection_solve/kernel.py:143"),
               "selection_solve": ("src/repro_torch/csrc/selection_solve.cu",
                                   "src/repro/kernels/selection_solve/kernel.py:83"),
               "masked_aggregate": ("src/repro_torch/csrc/masked_aggregate.cu",
                                    "src/repro/kernels/masked_aggregate/kernel.py:91"),
               "row_scale": ("src/repro_torch/csrc/masked_aggregate.cu",
                             "src/repro/kernels/masked_aggregate/ops.py:62"),
               "quantized_masked_aggregate": (
                   "src/repro_torch/csrc/masked_aggregate.cu",
                   "src/repro/kernels/masked_aggregate/kernel.py:58"),
               "swa_decode": ("src/repro_torch/csrc/swa_decode.cu",
                              "src/repro/kernels/swa_decode/kernel.py:75"),
               "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan/kernel.py:82"),
               "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                                "src/repro/models/mamba2.py:83")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=out["launches"][name], max_abs_err=errs[name],
                    **rec[name])
               for name, (src, rep) in sources.items()]
    print(f"[14] done in {time.perf_counter() - t_start:.1f} s; peak device "
          f"memory since phase [13]'s last arch began "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": kernels}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
