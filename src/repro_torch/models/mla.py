"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), as
``repro.models.mla``.

K/V are compressed into a per-token latent c_kv of rank ``kv_lora_rank``
plus a single shared RoPE key of dim ``rope_head_dim``; queries carry
per-head nope+rope parts.  Two execution paths:

* **forward/prefill** (``mla_apply``): the latent is up-projected to
  per-head K_nope/V and attention runs in the [nope+rope] space, one
  query chunk at a time when the sequence is a multiple of ``q_chunk``;
* **decode** (``mla_decode_step``, absorbed): the up-projection is folded
  into the query and the output, so attention runs against the latent
  cache [B, L, kv_lora + rope]: scores = q_lat . c_kv + q_rope . k_rope.

Neither path runs a kernel of the port's: the reference computes both in
plain ``jnp`` (masked with -1e30, softmax in float32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.layers import (Params, _normal, dot, rmsnorm,
                                       rmsnorm_init, rope)

NEG_INF = -1e30


def mla_init(gen, d_model: int, n_heads: int, cfg: MLAConfig,
             device=None) -> Params:
    qk_dim = cfg.nope_head_dim + cfg.rope_head_dim
    s = d_model ** -0.5
    return {
        "wq": _normal(gen, (d_model, n_heads * qk_dim), s, device),
        "w_dkv": _normal(gen, (d_model, cfg.kv_lora_rank + cfg.rope_head_dim),
                         s, device),
        "kv_ln": rmsnorm_init(cfg.kv_lora_rank, device),
        "w_ukv": _normal(gen, (cfg.kv_lora_rank,
                               n_heads * (cfg.nope_head_dim + cfg.v_head_dim)),
                         cfg.kv_lora_rank ** -0.5, device),
        "wo": _normal(gen, (n_heads * cfg.v_head_dim, d_model),
                      (n_heads * cfg.v_head_dim) ** -0.5, device),
    }


def _split_q(q: torch.Tensor, n_heads: int, cfg: MLAConfig):
    b, s = q.shape[:2]
    q = q.reshape(b, s, n_heads, cfg.nope_head_dim + cfg.rope_head_dim)
    return q[..., :cfg.nope_head_dim], q[..., cfg.nope_head_dim:]


def _latent(params: Params, x: torch.Tensor, cfg: MLAConfig, theta: float,
            positions: torch.Tensor):
    ckr = dot(x, params["w_dkv"])
    c_kv = rmsnorm(params["kv_ln"], ckr[..., :cfg.kv_lora_rank])
    k_rope = ckr[..., None, cfg.kv_lora_rank:]               # [B,S,1,rope]
    k_rope = rope(k_rope, positions, theta)[:, :, 0]         # shared across heads
    return c_kv, k_rope


def mla_apply(params: Params, x: torch.Tensor, positions: torch.Tensor,
              n_heads: int, cfg: MLAConfig, theta: float,
              q_chunk: int = 1024) -> torch.Tensor:
    """Forward/prefill path (decompressed attention), x [B,S,d]."""
    b, s, _ = x.shape
    q_nope, q_rope = _split_q(dot(x, params["wq"]), n_heads, cfg)
    q_rope = rope(q_rope, positions, theta)
    c_kv, k_rope = _latent(params, x, cfg, theta, positions)
    kv = dot(c_kv, params["w_ukv"]).reshape(
        b, s, n_heads, cfg.nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv[..., :cfg.nope_head_dim], kv[..., cfg.nope_head_dim:]

    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    # the reference's rule: chunks only when they tile the sequence
    nc = max(1, s // q_chunk) if s % q_chunk == 0 else 1

    def block(qn, qr, qp):
        scores = (torch.einsum("bqhd,bkhd->bhqk", qn, k_nope)
                  + torch.einsum("bqhd,bkd->bhqk", qr, k_rope)) * scale
        mask = qp[:, None] >= positions[None, :]
        probs = torch.softmax(
            torch.where(mask[None, None], scores, NEG_INF).to(torch.float32), -1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)

    cq = s // nc
    out = torch.cat([block(q_nope[:, i:i + cq], q_rope[:, i:i + cq],
                           positions[i:i + cq]) for i in range(0, s, cq)], dim=1)
    return dot(out.reshape(b, s, n_heads * cfg.v_head_dim), params["wo"])


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # [B, L, kv_lora]
    k_rope: torch.Tensor   # [B, L, rope_head_dim]
    pos: torch.Tensor      # [L] int32, -1 empty


def mla_cache_init(batch: int, cache_len: int, cfg: MLAConfig,
                   dtype=torch.float32, device=None) -> MLACache:
    """An empty latent cache (float32 by default, as the port's KV caches;
    the reference defaults to bfloat16)."""
    return MLACache(
        c_kv=torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, cache_len, cfg.rope_head_dim), dtype=dtype,
                           device=device),
        pos=torch.full((cache_len,), -1, dtype=torch.int32, device=device))


def mla_decode_step(params: Params, x: torch.Tensor, pos: int,
                    cache: MLACache, n_heads: int, cfg: MLAConfig,
                    theta: float) -> tuple[torch.Tensor, MLACache]:
    """Absorbed-latent decode of x [B,1,d] at position ``pos`` (an int),
    against the latent cache, which is written in place and returned.

    The token goes to slot ``pos``.  The cache is not a ring: as the
    reference's ``dynamic_update_slice``, a position past the last slot
    writes the last slot (the start index is clamped into range)."""
    pos = int(pos)
    b = x.shape[0]
    pos_vec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _split_q(x @ params["wq"], n_heads, cfg)
    q_rope = rope(q_rope, pos_vec, theta)

    c_new, kr_new = _latent(params, x, cfg, theta, pos_vec)   # [B,1,r], [B,1,rope]
    slot = min(max(pos, 0), cache.c_kv.shape[1] - 1)
    cache.c_kv[:, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, slot] = kr_new[:, 0].to(cache.k_rope.dtype)
    cache.pos[slot] = pos

    # absorb: W_ukv = [W_k_up | W_v_up] per head
    w_ukv = params["w_ukv"].reshape(cfg.kv_lora_rank, n_heads,
                                    cfg.nope_head_dim + cfg.v_head_dim)
    w_k_up = w_ukv[..., :cfg.nope_head_dim]       # [r, H, nope]
    w_v_up = w_ukv[..., cfg.nope_head_dim:]       # [r, H, v]

    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k_up)    # into latent space
    scale = (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat, cache.c_kv)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, cache.k_rope)) * scale
    mask = (cache.pos >= 0) & (cache.pos <= pos)
    probs = torch.softmax(torch.where(mask[None, None, None], scores,
                                      NEG_INF).to(torch.float32), -1)
    out_lat = torch.einsum("bhqk,bkr->bqhr", probs.to(cache.c_kv.dtype),
                           cache.c_kv)
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_v_up)
    y = out.reshape(b, 1, n_heads * cfg.v_head_dim) @ params["wo"]
    return y, cache
