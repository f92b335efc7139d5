"""Production training launcher, as ``repro.launch.train``: federated
training of a model-zoo architecture with the paper's joint
selection/power scheduler.

Each optimizer step is one FL communication round over a cohort of N
clients: the scheduler's sampled participation mask enters the loss as
per-example weights (eq. 4), and the wireless simulation accounts
time/energy exactly as the paper does — with the gradient payload S
derived from the architecture's true parameter count.

The reference's flags, defaults and printed lines, plus ``--device``.
The numpy streams (the problem, the cohorts, the data) are the
reference's; the participation draws come from a ``torch.Generator`` on
the device (jax's threefry stream has no torch counterpart), or are
handed in (``draws``).  ``--resume`` continues the run: the rounds before
the checkpoint's step are drawn again, untrained, so the draws, cohorts,
data and the time/energy totals go on as in the uninterrupted run (the
reference restarts them), and the last step's checkpoint is written once
where the reference writes it twice.

    PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m \\
        --steps 300 --batch 16 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch demo-100m \\
        --reduced --steps 8 --batch 4 --seq 64 --n-clients 8 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.core import ProbabilisticScheduler, sample_problem
from repro_torch.data.lm import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.zoo import grad_size_bits


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="demo-100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16,
                    help="cohort size = clients per round")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-clients", type=int, default=64)
    ap.add_argument("--tau", type=float, default=2.0)
    ap.add_argument("--scheduler", choices=["alternating", "optimal"],
                    default="alternating")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None, draws=None, params=None) -> list:
    """Run the launcher; returns the logged history.  ``draws``, when
    given, is indexed by step and gives that round's participation mask
    and powers as arrays (``(mask [N] bool, power [N])``) in place of the
    scheduler's own draw; ``params``, when given, are the initial
    parameters (a tree of tensors on the run's device, e.g. from
    ``convert.params_from_numpy``) in place of the seeded ones."""
    return run(parse_args(argv), draws, params)["history"]


def run(args: argparse.Namespace, draws=None, params=None, cfg=None) -> dict:
    """The launcher's loop: {"history", "params", "opt_state", "step_s"}
    (``step_s``: the wall seconds of each trained round, its host reads
    included).  ``cfg``, when given, is the model's configuration in
    place of ``--arch``'s and ``--reduced``'s (a depth cut, say)."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    print(f"arch {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}")

    # --- the paper's problem, with S = this model's gradient size --------
    s_bits = grad_size_bits(cfg)
    problem = sample_problem(0, args.n_clients, tau_th=args.tau,
                             grad_size_bits=s_bits,
                             total_bandwidth_hz=args.n_clients * 10e6,
                             device=dev)
    sched = ProbabilisticScheduler(solver=args.scheduler)
    state = sched.precompute(problem)
    print(f"S = {s_bits / 8e6:.1f} MB gradient payload; "
          f"E[participants] = {float(state.a.sum()):.2f}/{args.n_clients}")

    # --- model + data ------------------------------------------------------
    if params is None:
        params = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    train_step, opt = make_train_step(cfg, lr=args.lr, q_chunk=max(args.seq, 128))
    opt_state = opt.init(params)
    step0 = 0
    if args.resume and args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        step0, params, opt_state, _ = ckpt.restore(
            args.ckpt_dir, params_template=params, opt_template=opt_state)
        print(f"resumed from step {step0}")
    data = SyntheticLMData(args.n_clients, cfg.vocab, seed=1)
    rng = np.random.default_rng(2)
    gen = torch.Generator(dev).manual_seed(3)

    alpha = state.agg_weights.cpu().numpy()
    ec = problem.compute_energy().cpu().numpy()
    sim_time = sim_energy = 0.0
    history, step_s, saved = [], [], None
    t_wall = time.time()
    for step in range(args.steps):
        t_step = time.perf_counter()
        if draws is None:
            draw = sched.sample(state, gen)
            mask, power = draw.mask.cpu().numpy(), draw.power
        else:
            mask, power = draws[step]
            mask = np.asarray(mask, bool)
            power = torch.from_numpy(np.array(power)).to(dev)
        sel = np.where(mask)[0]
        if len(sel) == 0:
            continue
        # cohort batch: participating clients, data-sized sampling
        cohort = rng.choice(sel, size=args.batch, replace=True)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 data.batch(cohort, args.seq).items()}
        coef = alpha[cohort] * mask[cohort]
        coef = coef / max(coef.sum(), 1e-12)
        batch["loss_weights"] = torch.from_numpy(
            np.asarray(coef, np.float32)).to(dev)

        if step >= step0:
            params, opt_state, metrics = train_step(params, opt_state, batch)

        t_all = problem.tx_time(power).cpu().numpy()
        power = power.cpu().numpy()
        sim_time += float(t_all[sel].max())
        sim_energy += float((power[sel] * t_all[sel] + ec[sel]).sum())
        if step < step0:
            continue
        step_s.append(time.perf_counter() - t_step)
        if (step + 1) % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step + 1:5d} loss={loss:.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"|g|={float(metrics['grad_norm']):.2f} "
                  f"sim_t={sim_time:.0f}s E={sim_energy:.0f}J "
                  f"wall={time.time() - t_wall:.0f}s", flush=True)
            history.append({"step": step + 1, "loss": loss,
                            "sim_time_s": sim_time,
                            "sim_energy_j": sim_energy})
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            saved = step + 1
            ckpt.save(args.ckpt_dir, saved, params, opt_state)

    if args.ckpt_dir and saved != args.steps:
        ckpt.save(args.ckpt_dir, args.steps, params, opt_state)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(history, indent=1))
    print("done")
    return {"history": history, "params": params, "opt_state": opt_state,
            "step_s": step_s}


if __name__ == "__main__":
    main()
