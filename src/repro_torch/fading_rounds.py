"""Beyond-paper: per-round block fading makes a*_ik round-dependent (the
paper's channel is static, so its k index is vestigial).  With Rayleigh
block fading g_ik the same closed forms solve an [N, K] set of
subproblems at once, and participation tracks channel quality round by
round.

The port's counterpart of ``examples/fading_rounds.py``, at its sizes by
default; the flags set the sizes and the device.

    PYTHONPATH=src python -m repro_torch.fading_rounds
    PYTHONPATH=src python -m repro_torch.fading_rounds --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import sample_problem, solve_joint_optimal
from repro_torch.device import resolve_device
from repro_torch.fleet_scale import device_name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=64, help="fleet size")
    ap.add_argument("--rounds", type=int, default=24, help="fading rounds K")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    prob = sample_problem(7, args.devices, n_rounds=args.rounds,
                          with_fading=True, device=dev)
    sol = solve_joint_optimal(prob)
    a = sol.a.cpu().numpy()                     # [N, K]
    g = prob.fading.cpu().numpy()

    print(f"solution shape {a.shape}: selection probabilities per "
          f"(device, round) [{device_name(dev)}]")
    print(f"E[participants] per round: min={a.sum(0).min():.2f} "
          f"mean={a.sum(0).mean():.2f} max={a.sum(0).max():.2f}")
    per_device_std = a.std(1).mean()
    print(f"mean per-device std of a over rounds: {per_device_std:.4f} "
          f"(static channel would give 0)")
    # fading quality should correlate positively with selection probability
    corr = np.corrcoef(g.reshape(-1), a.reshape(-1))[0, 1]
    print(f"corr(channel gain, selection probability) = {corr:.3f}")
    assert corr > 0.1, "selection should favour good channel rounds"
    feas = bool(prob.constraints_satisfied(sol.a, sol.power).all())
    print(f"all (i,k) constraints satisfied: {feas}")
    assert feas, "the optimum must satisfy every (i, k) constraint"
    return dict(a=a, corr=float(corr), feasible=feas)


if __name__ == "__main__":
    main()
