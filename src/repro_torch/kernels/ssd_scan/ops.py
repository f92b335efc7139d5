"""Wrapper for the ssd_scan kernels: Mamba2-shaped SSD, a drop-in for
``models.mamba2.ssd_chunked``, with its backward.

``ssd_apply`` takes the model's layout (x [B,S,H,P], dt [B,S,H], B/C
[B,S,N] shared by the heads) and goes through ``SSDScanFn``, an
``autograd.Function``.  For CPU tensors its forward runs the plain
chunked version of ``ref.py`` and its backward the plain backward passes
(``ref.ssd_bwd_passes_ref``); for CUDA tensors the forward launches the
kernels of ``csrc/ssd_scan.cu`` on the current stream (four passes,
chunks in parallel; ``ref.ssd_passes_ref`` mirrors them) and the backward
those of ``csrc/ssd_scan_bwd.cu`` (six passes), or raises.  The kernels
read B/C by batch row and x/dt in place: unlike the reference's wrapper
they neither repeat B/C over the heads nor transpose x.  The forward
allocates its passes' scratch, C.B^T once per (batch row, chunk), the
chunk states (overwritten in place by the states entering each chunk)
and the decays' cumulative sums, and keeps them for the backward where
autograd records; the backward allocates its own.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_lib import LAUNCHES, check_operands, launch
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_passes_ref, ssd_chunked_saved

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


def _check_card(operands, init_state, chunk) -> None:
    check_operands(*operands, *([] if init_state is None else [init_state]))
    p, n = operands[0].shape[-1], operands[3].shape[-1]
    if p > MAX_HEAD_DIM or n > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE} and chunk <= {MAX_CHUNK}, got P={p}, "
                         f"N={n}, chunk={chunk}")


def _forward_card(x, dt, a, b_mat, c_mat, d_skip, chunk, init_state):
    """The forward kernels: (y, final state, cum, entering states, C.B^T)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    y = torch.empty_like(x)
    state = x.new_empty((bsz, h, p, n))
    scores = x.new_empty((bsz, nc, chunk, chunk))
    states = x.new_empty((bsz, nc, h, p, n))
    cum = x.new_empty((bsz, nc, h, chunk))
    launch("repro_ssd_scan",
           *(t.data_ptr() for t in (x, dt, a, b_mat, c_mat, d_skip)),
           0 if init_state is None else init_state.data_ptr(),
           *(t.data_ptr() for t in (y, state, scores, states, cum)),
           bsz, s, h, p, n, chunk)
    LAUNCHES["ssd_scan"] += 1
    return y, state, cum, states, scores


def _backward_card(dy, d_final, x, dt, a, b_mat, c_mat, d_skip, chunk, cum,
                   states, scores):
    """The backward kernels: the gradients of ``ssd_bwd_passes_ref``."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    nc = s // chunk
    check_operands(dy, *([] if d_final is None else [d_final]))
    grads = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(a),
             torch.empty_like(b_mat), torch.empty_like(c_mat),
             torch.empty_like(d_skip), x.new_empty((bsz, h, p, n)))
    dstates = x.new_empty((bsz, nc, h, p, n))
    dg = x.new_empty((bsz, nc, chunk, chunk))
    parts = x.new_empty((2, bsz, nc, h))
    launch("repro_ssd_scan_bwd", dy.data_ptr(),
           0 if d_final is None else d_final.data_ptr(),
           *(t.data_ptr() for t in (x, dt, a, b_mat, c_mat, d_skip, cum, states,
                                    scores)),
           *(t.data_ptr() for t in grads),
           *(t.data_ptr() for t in (dstates, dg, parts)),
           bsz, s, h, p, n, chunk)
    LAUNCHES["ssd_scan_bwd"] += 1
    return grads


class SSDScanFn(torch.autograd.Function):
    """The scan as one autograd node: (y, final state) from (x, dt, a,
    B, C, D, init_state or None); the backward takes the cotangents of
    both (None where the caller dropped one: zeros) and returns each
    operand's gradient where ``ctx.needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, x, dt, a, b_mat, c_mat, d_skip, init_state, chunk):
        operands = (x, dt, a, b_mat, c_mat, d_skip)
        if x.device.type == "cpu":
            y, state, cum, states, scores = ssd_chunked_saved(
                *operands, chunk, init_state)
        else:
            _check_card(operands, init_state, chunk)
            y, state, cum, states, scores = _forward_card(
                *operands, chunk, init_state)
        ctx.chunk = chunk
        ctx.save_for_backward(*operands, cum, states, scores)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_final):
        *operands, cum, states, scores = ctx.saved_tensors
        x = operands[0]
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if d_final is not None:
            d_final = d_final.contiguous()
        if x.device.type == "cpu":
            grads = ssd_bwd_passes_ref(dy, d_final, *operands, ctx.chunk, cum,
                                       states, scores)
        else:
            grads = _backward_card(dy, d_final, *operands, ctx.chunk, cum,
                                   states, scores)
        want = ctx.needs_input_grad
        return (*(g if w else None for g, w in zip(grads, want)), None)


def ssd_apply(x, dt, a, b_mat, c_mat, d_skip, *, chunk: int = 128,
              init_state=None, return_state: bool = False):
    """x [B,S,H,P]; dt [B,S,H] (softplus'd); a [H]; b/c [B,S,N]; d_skip
    [H]; init_state [B,H,P,N] or None (zeros) -> y [B,S,H,P], and the
    final state [B,H,P,N] with ``return_state``.  S % chunk == 0."""
    _check_shapes(x, dt, a, b_mat, c_mat, d_skip, chunk, init_state)
    y, state = SSDScanFn.apply(x, dt, a, b_mat, c_mat, d_skip, init_state,
                               chunk)
    return (y, state) if return_state else y
