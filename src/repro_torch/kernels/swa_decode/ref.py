"""Plain PyTorch versions of the swa_decode kernel.

``swa_decode_ref`` is ``repro.kernels.swa_decode.ref``: dense masked
softmax attention of one query token against the full ring-buffer
cache.  ``swa_decode_split_ref`` writes out the kernel's decomposition
(the ring cut into splits, a partial softmax per split, the merge in
split order) for the tests; nothing on the main path calls it.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _masked_scores(q, k, pos_buf, qpos, window):
    s = torch.einsum("bhgd,bshd->bhgs", q.to(torch.float32),
                     k.to(torch.float32))
    valid = (pos_buf >= 0) & (pos_buf <= qpos)
    if window is not None:
        valid &= pos_buf > qpos - window
    return torch.where(valid[None, None, None, :], s, NEG), valid


def swa_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos_buf: torch.Tensor, qpos, *,
                   window: int | None) -> torch.Tensor:
    """q [B,Hkv,G,dh] (pre-scaled), k/v [B,W,Hkv,dh], pos_buf [W] ->
    [B,Hkv,G,dh]."""
    s, _ = _masked_scores(q, k, pos_buf, qpos, window)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", p,
                        v.to(torch.float32)).to(q.dtype)


def swa_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos_buf: torch.Tensor, qpos, *, window: int | None,
                         nsplit: int) -> torch.Tensor:
    """The arguments and result of ``swa_decode_ref``, computed as the
    kernel splits it: split j covers the slots [j per, (j + 1) per), per =
    ceil(W / nsplit), and keeps the max m_j of its valid scores (-1e30
    without one), l_j = sum exp(s - m_j) and acc_j = sum exp(s - m_j) v
    over them; with M = max_j m_j the output is sum_j acc_j exp(m_j - M) /
    max(sum_j l_j exp(m_j - M), 1e-30), summed in split order."""
    s, valid = _masked_scores(q, k, pos_buf, qpos, window)
    v32 = v.to(torch.float32)
    w = k.shape[1]
    per = -(-w // nsplit)
    parts = []
    for j in range(nsplit):
        lo, hi = min(w, j * per), min(w, (j + 1) * per)
        if hi > lo:
            m = s[..., lo:hi].amax(dim=-1)
        else:
            m = torch.full(s.shape[:-1], NEG, dtype=s.dtype, device=s.device)
        p = torch.where(valid[lo:hi], torch.exp(s[..., lo:hi] - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bhgs,bshd->bhgd", p, v32[:, lo:hi])))
    big_m = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    norm = torch.zeros_like(big_m)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        scale = torch.exp(m - big_m)
        norm = norm + l * scale
        acc = acc + a * scale[..., None]
    return (acc / torch.clamp_min(norm, 1e-30)[..., None]).to(q.dtype)
