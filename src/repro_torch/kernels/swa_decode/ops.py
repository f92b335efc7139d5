"""Wrappers for the swa_decode kernel, shaped to drop into
``layers.attn_decode_step`` (q [B,1,H,dh] + a ring-buffer KV cache).

``swa_decode`` takes the kernel's own layout, q [B, Hkv, G, dh]
pre-scaled by dh^-0.5.  For CPU tensors it runs the plain version of
``ref.py``; for CUDA tensors it launches the kernel of
``csrc/swa_decode.cu`` on the current stream, or raises (also under
autograd: the kernel has no backward).  The kernel
splits the ring across blocks (``split_count`` picks how many; the GPU
tests launch it at other counts through ``_launch``, whose plain mirror is
``ref.swa_decode_split_ref``).  ``decode_attention`` views the decode
step's query for it.  Each takes the reference decode's optional logit
softcap (gemma2's 50): ``softcap * tanh(s / softcap)`` on every score.

With more than one split the blocks of a (batch row, KV head) meet at a
counter in device memory: one int32 per (batch row, KV head), kept here
per (device, stream), zeroed once and left at 0 by each launch, so that
launches on different streams never share one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cuda_lib import (LAUNCHES, check_operands, launch,
                                         refuse_autograd)
from repro_torch.kernels.swa_decode.ref import swa_decode_ref

# the kernel keeps G query rows of dh values per lane group in registers
MAX_GROUP = 8
MAX_HEAD_DIM = 256
# the split: slots a step of the kernel's 8 warps (a split holds a multiple
# of it), at most this many splits, and about this many blocks per SM
SPLIT_STEP = 32
MAX_SPLIT = 64
BLOCKS_PER_SM = 2

_sm_counts: dict[int, int] = {}
_counters: dict[tuple[int, int], torch.Tensor] = {}


def split_count(bh: int, w: int, n_sm: int) -> int:
    """Splits of a ring of W slots for B Hkv = ``bh`` (batch row, KV head)
    pairs on ``n_sm`` SMs: about two blocks per SM, each split but the last
    a multiple of 32 slots (one step of the kernel's warps; at least 32),
    so 1 when W <= 32."""
    want = max(1, min(-(-BLOCKS_PER_SM * n_sm // bh), MAX_SPLIT))
    per = SPLIT_STEP * -(-w // (SPLIT_STEP * want))
    return -(-w // per)


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _sm_counts:
        _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev.index]


def _counter(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def _check_shapes(q, k, v, pos_buf) -> None:
    bsz, hkv, g, dh = q.shape
    w = k.shape[1]
    if (tuple(k.shape) != (bsz, w, hkv, dh) or tuple(v.shape) != tuple(k.shape)
            or tuple(pos_buf.shape) != (w,)):
        raise ValueError(f"expected q [B, Hkv, G, dh], k/v [B, W, Hkv, dh] "
                         f"and pos_buf [W], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(pos_buf.shape)}")


def _check_softcap(softcap) -> None:
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos_buf: torch.Tensor, qpos, *, window: int | None,
               softcap: float | None = None) -> torch.Tensor:
    """q [B, Hkv, G, dh] (pre-scaled), k/v [B, W, Hkv, dh], pos_buf [W]
    int32, qpos the query's position -> out [B, Hkv, G, dh].  A slot is
    attended when 0 <= pos <= qpos (and pos > qpos - window); ``softcap``
    (None: none) caps each score s at ``softcap * tanh(s / softcap)``."""
    _check_shapes(q, k, v, pos_buf)
    _check_softcap(softcap)
    if q.device.type == "cpu":
        return swa_decode_ref(q, k, v, pos_buf, qpos, window=window,
                              softcap=softcap)
    nsplit = split_count(q.shape[0] * q.shape[1], k.shape[1], _sm_count(q.device))
    return _launch(q, k, v, pos_buf, qpos, window, nsplit, softcap)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos_buf: torch.Tensor, qpos, window: int | None,
            nsplit: int, softcap: float | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA operands with the ring cut into ``nsplit``
    contiguous ranges of ceil(W / nsplit) slots (the last ones short or
    empty), merged in split order."""
    _check_shapes(q, k, v, pos_buf)
    bsz, hkv, g, dh = q.shape
    w = k.shape[1]
    refuse_autograd("swa_decode", q, k, v)
    check_operands(q, k, v)
    if (pos_buf.dtype != torch.int32 or pos_buf.device != q.device
            or not pos_buf.is_contiguous()):
        raise ValueError("pos_buf must be a contiguous int32 tensor on the "
                         "operands' device")
    if g > MAX_GROUP or dh > MAX_HEAD_DIM or w == 0:
        raise ValueError(f"the kernel takes G <= {MAX_GROUP}, dh <= "
                         f"{MAX_HEAD_DIM} and W >= 1, got G={g}, dh={dh}, W={w}")
    if not 1 <= nsplit <= min(MAX_SPLIT, w):
        raise ValueError(f"nsplit must lie in [1, min({MAX_SPLIT}, W={w})], "
                         f"got {nsplit}")
    _check_softcap(softcap)
    out = torch.empty_like(q)
    # the partials and the counters, held until the launch is queued
    part = counter = None
    if nsplit > 1:
        part = q.new_empty(bsz * hkv * nsplit * g * (dh + 2))
        counter = _counter(q.device, bsz * hkv)
    launch("repro_swa_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           pos_buf.data_ptr(), out.data_ptr(),
           *(0 if t is None else t.data_ptr() for t in (part, counter)),
           bsz, w, hkv, g, dh, nsplit, int(qpos),
           -1 if window is None else int(window),
           0.0 if softcap is None else float(softcap))
    LAUNCHES["swa_decode"] += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos_buf: torch.Tensor, qpos, *, window: int | None,
                     n_heads: int, softcap: float | None = None) -> torch.Tensor:
    """q [B,1,H,dh]; k/v [B,W,Hkv,dh]; returns [B,1,H,dh]."""
    bsz, _, h, dh = q.shape
    if h != n_heads:
        raise ValueError(f"q has {h} heads, expected {n_heads}")
    hkv = k.shape[2]
    qg = (q[:, 0] * dh ** -0.5).reshape(bsz, hkv, h // hkv, dh)
    out = swa_decode(qg, k, v, pos_buf, qpos, window=window, softcap=softcap)
    return out.reshape(bsz, 1, h, dh)
