"""Build and load the port's CUDA kernels, and count their launches.

The sources in ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into
one shared library with a plain C interface, and loaded with ``ctypes``.
The build happens at first use, into ``build/repro_torch/`` at the root
of the checkout, under a name that hashes the sources and flags, so an
edited source is never served a stale library.  Nothing here runs when
the module is imported.

``LAUNCHES`` counts, per kernel, the launches the wrappers in
``kernels/*/ops.py`` made; each wrapper adds one where it launches and
nowhere else.  Kernel 5's backward is a kernel of its own
(``ssd_scan_bwd``, ``csrc/ssd_scan_bwd.cu``); kernel 6 has none, and its
wrapper refuses autograd (``refuse_autograd``).  ``BUILDS`` counts the
builds that ran ``nvcc`` (not those that found the hashed library on
disk) and ``LOADS`` the ``ctypes.CDLL`` loads of the library: a steady
call makes neither (``repro_torch.analysis.recompile.BuildBudget``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: P^min needs expm1f's accuracy as a -> 0; no FMA
# contraction, so the kernels round like their plain PyTorch versions
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC"]

LAUNCHES = {"fused_solve": 0, "selection_solve": 0, "masked_aggregate": 0,
            "row_scale": 0, "quantized_masked_aggregate": 0, "swa_decode": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
BUILDS = 0
LOADS = 0

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "repro_fused_solve": [_P] * 6 + [_LL, _F, _F, _F, _F, _I, _I, _P],
    "repro_selection_solve": [_P] * 6 + [_LL, _F, _F, _F, _P],
    "repro_masked_aggregate": [_P] * 3 + [_I, _I, _LL, _P],
    "repro_row_scale": [_P] * 3 + [_LL, _LL, _P],
    "repro_quantized_masked_aggregate": [_P] * 6 + [_I, _I, _LL, _P],
    "repro_swa_decode": [_P] * 7 + [_I] * 6 + [_LL, _LL, _F, _P],
    "repro_ssd_scan": [_P] * 12 + [_I] * 6 + [_P],
    "repro_ssd_scan_bwd": [_P] * 21 + [_I] * 6 + [_P],
}

_library: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def reset_build_counts() -> None:
    global BUILDS, LOADS
    BUILDS = LOADS = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile and link the kernels; return the library's path.

    The compiler's output (``-Xptxas -v``: registers and spills per
    kernel) is kept beside the library, in ``build_log(lib)``.
    """
    global BUILDS
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"librepro_kernels_{tag}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILDS += 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs = [(src.name, *proc.communicate(), proc.returncode)
            for src, proc in zip(sources, procs)]
    log = "".join(f"== {name} (rc {rc})\n{out}" for name, out, _, rc in logs)
    build_log(lib).write_text(log)
    if any(rc != 0 for *_, rc in logs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = lib.with_suffix(".tmp.so")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    return lib


def build_log(lib: Path) -> Path:
    """The compiler's log of the library at ``lib``."""
    return lib.with_suffix(".log")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library, LOADS
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        LOADS += 1
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def launch(name: str, *args) -> None:
    """Call ``name`` from the library with ``args`` on the current
    stream; raise if the launch failed."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")


def check_operands(*tensors: torch.Tensor, shape=None) -> None:
    """Raise unless every operand is a contiguous float32 tensor on the
    current CUDA device (and of ``shape`` where given)."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {x.device} and {dev}")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"kernel operands on {x.device}, but the "
                             f"kernels launch on the current device "
                             f"cuda:{torch.cuda.current_device()}")
        if x.dtype != torch.float32:
            raise ValueError(f"kernel operands must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"operand shape {tuple(x.shape)} != {tuple(shape)}")


# the slice that brings the backward of each kernel that has none
BACKWARD_SLICE = {"swa_decode": "a slice that trains through decode "
                                "attention (a backward for kernel 6)"}


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise where autograd records and an operand requires its gradient:
    a kernel without a backward would give outputs with no ``grad_fn``,
    and every gradient before it would be dropped without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {kernel} kernel has no backward yet, so it cannot run "
            f"under autograd on the card; that comes with "
            f"{BACKWARD_SLICE[kernel]}")
