"""Wrappers for the swa_decode kernel, shaped to drop into
``layers.attn_decode_step`` (q [B,1,H,dh] + a ring-buffer KV cache).

``swa_decode`` takes the kernel's own layout, q [B, Hkv, G, dh]
pre-scaled by dh^-0.5.  For CPU tensors it runs the plain version of
``ref.py``; for CUDA tensors it launches the kernel of
``csrc/swa_decode.cu`` on the current stream, or raises.
``decode_attention`` views the decode step's query for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_lib import LAUNCHES, check_operands, launch
from repro_torch.kernels.swa_decode.ref import swa_decode_ref

# the kernel keeps G query rows of dh values per lane group in registers
MAX_GROUP = 8
MAX_HEAD_DIM = 256


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos_buf: torch.Tensor, qpos, *,
               window: int | None) -> torch.Tensor:
    """q [B, Hkv, G, dh] (pre-scaled), k/v [B, W, Hkv, dh], pos_buf [W]
    int32, qpos the query's position -> out [B, Hkv, G, dh].  A slot is
    attended when 0 <= pos <= qpos (and pos > qpos - window)."""
    bsz, hkv, g, dh = q.shape
    w = k.shape[1]
    if (tuple(k.shape) != (bsz, w, hkv, dh) or tuple(v.shape) != tuple(k.shape)
            or tuple(pos_buf.shape) != (w,)):
        raise ValueError(f"expected q [B, Hkv, G, dh], k/v [B, W, Hkv, dh] "
                         f"and pos_buf [W], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(pos_buf.shape)}")
    if q.device.type == "cpu":
        return swa_decode_ref(q, k, v, pos_buf, qpos, window=window)
    check_operands(q, k, v)
    if (pos_buf.dtype != torch.int32 or pos_buf.device != q.device
            or not pos_buf.is_contiguous()):
        raise ValueError("pos_buf must be a contiguous int32 tensor on the "
                         "operands' device")
    if g > MAX_GROUP or dh > MAX_HEAD_DIM or w == 0:
        raise ValueError(f"the kernel takes G <= {MAX_GROUP}, dh <= "
                         f"{MAX_HEAD_DIM} and W >= 1, got G={g}, dh={dh}, W={w}")
    out = torch.empty_like(q)
    launch("repro_swa_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           pos_buf.data_ptr(), out.data_ptr(), bsz, w, hkv, g, dh, int(qpos),
           -1 if window is None else int(window))
    LAUNCHES["swa_decode"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos_buf: torch.Tensor, qpos, *, window: int | None,
                     n_heads: int) -> torch.Tensor:
    """q [B,1,H,dh]; k/v [B,W,Hkv,dh]; returns [B,1,H,dh]."""
    bsz, _, h, dh = q.shape
    if h != n_heads:
        raise ValueError(f"q has {h} heads, expected {n_heads}")
    hkv = k.shape[2]
    qg = (q[:, 0] * dh ** -0.5).reshape(bsz, hkv, h // hkv, dh)
    out = swa_decode(qg, k, v, pos_buf, qpos, window=window)
    return out.reshape(bsz, 1, h, dh)
