"""Time kernels 1-2 and the batched kernel methods on one GPU.

    python time_solve.py [--reps R] [--label L]

At five shapes of the batched fleet solve: one ``paper_static`` fleet
(E = 100), the ragged mix of five scenarios that ``chip_smoke.py`` [8]
drives (E = 5,000, 3,736 of them padded slots), ``rayleigh_fading`` x 64
(E = 64,000), ``mega_fleet_100k`` x 8 (E = 800,000) and one
``metro_1m_users`` draw (E = 1,000,000), each repetition prints one JSON
object a shape with:

* for ``fused_solve`` and ``selection_solve`` on the batch's flattened
  elements, ``chip_smoke.solve_times``: the kernel's device time
  (``ms``, by ``chip_smoke.queued_ms``: its launches queued behind a spin
  kernel, so they run back to back) and its CUDA-event time, the plain
  version's device time, the steps its function needs (mean, max, the
  mean of each warp's largest), and the bound on those steps and on the
  fixed trip count;
* ``solve_joint_batch`` with ``method="kernel"`` and
  ``method="fused_kernel"``, by CUDA events (the whole method: the element
  prep, the kernel, the objectives and the masking);
* on the mixed batch, ``fused_solve`` on its real slots alone and on its
  padded slots alone.

It imports ``chip_smoke.py`` from its own directory and, of the port, only
functions that the solve kernels' parent commit has: copied with
``chip_smoke.py`` into the root of that checkout, it times it on the same
card, so parent and change can alternate in one call.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--label", default="", help="tag for the printed lines")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_solve: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as C
    from repro_torch.core.batch import solve_joint_batch
    from repro_torch.core.scenarios import make_batch, make_mixed_batch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import cuda_lib

    dev = resolve_device(None)
    cuda_lib.build()
    cuda_lib.library()
    print(f"{C.card()}; torch {torch.__version__}", flush=True)
    batches = [
        ("paper_static x 1", make_batch("paper_static", 1, seed=0, device=dev)),
        ("mixed x 5", make_mixed_batch(C.MIXED_SCENARIOS, seed=0, device=dev)),
        ("rayleigh_fading x 64", make_batch("rayleigh_fading", 64, seed=0,
                                            device=dev)),
        ("mega_fleet_100k x 8", make_batch("mega_fleet_100k", 8, seed=0,
                                           device=dev)),
        ("metro_1m_users x 1", make_batch("metro_1m_users", 1, seed=0,
                                          device=dev))]
    for rep in range(args.reps):
        for label, batch in batches:
            tag = f"[{args.label} {rep}] {label}"
            flat, kw = C.batch_operands(batch)
            row = dict(label=args.label, rep=rep, shape=label,
                       E=flat[0].numel())
            for name in ("fused_solve", "selection_solve"):
                row[name] = C.solve_times(torch, tag, name, flat, kw, 20)
            for method in ("kernel", "fused_kernel"):
                row[f"method_{method}_ms"] = C.cuda_ms(
                    torch, lambda: solve_joint_batch(batch, method=method), 5)
            if not bool(batch.mask.all()):
                mask = batch.mask.reshape(-1)
                for part, keep in (("real", mask), ("padded", ~mask)):
                    row[f"fused_solve_{part}"] = C.solve_times(
                        torch, f"{tag} {part} slots", "fused_solve",
                        [x[keep].contiguous() for x in flat], kw, 20)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
