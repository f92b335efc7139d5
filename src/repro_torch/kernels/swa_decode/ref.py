"""Plain PyTorch version of the swa_decode kernel, as
``repro.kernels.swa_decode.ref``: dense masked softmax attention of one
query token against the full ring-buffer cache."""
from __future__ import annotations

import torch


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos_buf: torch.Tensor, qpos, *,
                   window: int | None) -> torch.Tensor:
    """q [B,Hkv,G,dh] (pre-scaled), k/v [B,W,Hkv,dh], pos_buf [W] ->
    [B,Hkv,G,dh]."""
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32),
                     k.to(torch.float32))
    valid = (pos_buf >= 0) & (pos_buf <= qpos)
    if window is not None:
        valid &= pos_buf > qpos - window
    s = torch.where(valid[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p,
                        v.to(torch.float32)).to(q.dtype)
