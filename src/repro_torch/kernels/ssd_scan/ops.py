"""Wrapper for the ssd_scan kernel: Mamba2-shaped SSD, a drop-in for
``models.mamba2.ssd_chunked``.

``ssd_apply`` takes the model's layout (x [B,S,H,P], dt [B,S,H], B/C
[B,S,N] shared by the heads).  For CPU tensors it runs the plain chunked
version of ``ref.py``; for CUDA tensors it launches the kernels of
``csrc/ssd_scan.cu`` on the current stream (four passes, chunks in
parallel; ``ref.ssd_passes_ref`` mirrors them), or raises.  The kernels
read B/C by batch row and x/dt in place: unlike the reference's wrapper
they neither repeat B/C over the heads nor transpose x.  The wrapper
allocates the passes' scratch: C.B^T once per (batch row, chunk), the
chunk states (overwritten in place by the states entering each chunk)
and the decays' cumulative sums.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_lib import LAUNCHES, check_operands, launch
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

# the kernels' shared-memory tiles hold at most these
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 256


def _check_shapes(x, dt, a, b_mat, c_mat, d_skip, chunk, init_state) -> None:
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    want = {"dt": (bsz, s, h), "a": (h,), "b_mat": (bsz, s, n),
            "c_mat": (bsz, s, n), "d_skip": (h,)}
    got = {"dt": dt, "a": a, "b_mat": b_mat, "c_mat": c_mat, "d_skip": d_skip}
    if init_state is not None:
        want["init_state"] = (bsz, h, p, n)
        got["init_state"] = init_state
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, "
                             f"expected {shape} for x of {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"x of {tuple(x.shape)} is empty")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")


def ssd_apply(x, dt, a, b_mat, c_mat, d_skip, *, chunk: int = 128,
              init_state=None, return_state: bool = False):
    """x [B,S,H,P]; dt [B,S,H] (softplus'd); a [H]; b/c [B,S,N]; d_skip
    [H]; init_state [B,H,P,N] or None (zeros) -> y [B,S,H,P], and the
    final state [B,H,P,N] with ``return_state``.  S % chunk == 0."""
    _check_shapes(x, dt, a, b_mat, c_mat, d_skip, chunk, init_state)
    if x.device.type == "cpu":
        y, state = ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_skip, chunk,
                                   init_state)
        return (y, state) if return_state else y
    operands = [x, dt, a, b_mat, c_mat, d_skip]
    check_operands(*operands, *([] if init_state is None else [init_state]))
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if p > MAX_HEAD_DIM or n > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE} and chunk <= {MAX_CHUNK}, got P={p}, "
                         f"N={n}, chunk={chunk}")
    nc = s // chunk
    y = torch.empty_like(x)
    state = x.new_empty((bsz, h, p, n))
    scores = x.new_empty((bsz, nc, chunk, chunk))
    states = x.new_empty((bsz, nc, h, p, n))
    cum = x.new_empty((bsz, nc, h, chunk))
    launch("repro_ssd_scan", *(t.data_ptr() for t in operands),
           0 if init_state is None else init_state.data_ptr(),
           *(t.data_ptr() for t in (y, state, scores, states, cum)),
           bsz, s, h, p, n, chunk)
    LAUNCHES["ssd_scan"] += 1
    return (y, state) if return_state else y
