"""Shared neural building blocks for the model zoo, as ``repro.models.layers``.

Functional: ``*_init(generator, ..., device) -> params`` and
``*_apply(params, ...)`` over nested dicts of tensors, with the
reference's names, shapes and float32 arithmetic.  Attention supports:

* GQA (q heads grouped over fewer kv heads; kv repeated to the q-head
  count, or the grouped form under ``GQA_GROUPED``),
* RoPE with per-layer theta (gemma3 dual-base), optional NoPE (llama4
  global layers),
* sliding-window masks (gemma2/3, danube, llama4 chunked-local),
* attention-logit softcapping (gemma2), on the full-sequence path,
* query-chunked computation: sequences longer than ``q_chunk`` are
  processed one query block at a time, so the [Sq, Skv] score matrix
  never materialises for the full sequence,
* ring-buffer KV caches: local layers keep a window-sized cache written at
  slot ``pos % W``; global layers keep the full-context cache.  The
  single-token decode step attends through ``kernels.swa_decode`` (the
  hand-written kernel on the card, its plain version on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels.swa_decode.ops import decode_attention

Params = dict

NEG_INF = -1e30


def _normal(gen, shape, scale, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


# ------------------------------------------------------------------- norms

def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
    return (x32 * rms * params["scale"]).to(dtype)


# -------------------------------------------------------------------- RoPE

def _rope_angles(positions: torch.Tensor, theta: float, dh: int):
    """cos and sin of RoPE's angles, [..., S, dh // 2]."""
    half = dh // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    # a Python base keeps theta off the device (no host-to-device copy)
    freqs = torch.pow(theta, exponent)
    ang = positions[..., None].to(torch.float32) * freqs      # [..., S, half]
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    if x.ndim == 4 and cos.ndim == 2:          # [B,S,H,dh] w/ positions [S]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif x.ndim == 4:                          # positions [B,S]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, dh]; positions [S] or [B, S]."""
    return _apply_rope(x, *_rope_angles(positions, theta, x.shape[-1]))


def sinusoidal_embed(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal absolute position embedding. positions [S] -> [S, d]."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)[None, :]
    ang = positions[:, None].to(torch.float32) / (10_000 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------- MLP

def mlp_init(gen, d_model: int, d_ff: int, device=None) -> Params:
    s_in = d_model ** -0.5
    s_ff = d_ff ** -0.5
    return {
        "w1": _normal(gen, (d_model, d_ff), s_in, device),
        "w3": _normal(gen, (d_model, d_ff), s_in, device),
        "w2": _normal(gen, (d_ff, d_model), s_ff, device),
    }


def mlp_apply(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    gate = x @ params["w1"]
    # jax.nn.gelu's default is the tanh approximation; torch's is exact
    gate = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    return (gate * (x @ params["w3"])) @ params["w2"]


# --------------------------------------------------------------- attention

class AttnLayerSpec(NamedTuple):
    """Static per-layer attention behaviour (derived from AttnConfig +
    whether this layer is 'attn' (local) or 'gattn' (global))."""
    n_heads: int
    n_kv_heads: int
    d_head: int
    theta: float
    window: Optional[int]     # None => full context
    softcap: Optional[float]
    qk_norm: bool
    use_rope: bool
    causal: bool = True


def layer_spec(cfg: AttnConfig, kind: str, causal: bool = True) -> AttnLayerSpec:
    """kind: 'attn' (local if cfg.window set) or 'gattn' (global)."""
    is_global = kind == "gattn"
    theta = cfg.rope_theta_global if (is_global and cfg.rope_theta_global) else cfg.rope_theta
    return AttnLayerSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        theta=theta,
        window=None if is_global else cfg.window,
        softcap=cfg.logit_softcap,
        qk_norm=cfg.qk_norm,
        use_rope=not (is_global and cfg.nope_on_global),
        causal=causal)


def attn_init(gen, d_model: int, spec: AttnLayerSpec, device=None) -> Params:
    h, kvh, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
    s = d_model ** -0.5
    p = {
        "wq": _normal(gen, (d_model, h * dh), s, device),
        "wk": _normal(gen, (d_model, kvh * dh), s, device),
        "wv": _normal(gen, (d_model, kvh * dh), s, device),
        "wo": _normal(gen, (h * dh, d_model), (h * dh) ** -0.5, device),
    }
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, device)
        p["k_norm"] = rmsnorm_init(dh, device)
    return p


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,Hkv,dh] -> [B,S,H,dh] by repetition (H % Hkv == 0)."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


# Compute GQA attention in grouped form — q viewed as [B,Cq,Hkv,G,dh]
# against un-repeated K/V — instead of materialising K/V repeated to the
# full query-head count.  Flag-gated, as in the reference, so measurement
# sweeps stay internally consistent.
GQA_GROUPED = False


def set_gqa_grouped(on: bool):
    global GQA_GROUPED
    GQA_GROUPED = on


def _mask(q_pos, k_pos, spec: AttnLayerSpec) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if spec.causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if spec.window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - spec.window
    mask &= (k_pos >= 0)[None, :]          # ring-buffer empty slots
    return mask


def _attend_block_grouped(q, k, v, q_pos, k_pos, spec: AttnLayerSpec):
    """q [B,Cq,H,dh], k/v [B,Skv,Hkv,dh] (no repetition)."""
    b, cq, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = spec.d_head ** -0.5
    qg = (q * scale).reshape(b, cq, hkv, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    mask = _mask(q_pos, k_pos, spec)
    if spec.softcap is not None:
        scores = spec.softcap * torch.tanh(scores / spec.softcap)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, cq, h, dh)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                    softcap: Optional[float]) -> torch.Tensor:
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask, scores, NEG_INF)
    return torch.softmax(scores.to(torch.float32), dim=-1)


def _attend_block(q, k, v, q_pos, k_pos, spec: AttnLayerSpec):
    """q [B,Cq,H,dh], k/v [B,Skv,H,dh], *_pos int32 [Cq]/[Skv]."""
    scale = spec.d_head ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    probs = _masked_softmax(scores, _mask(q_pos, k_pos, spec)[None, None],
                            spec.softcap)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        spec: AttnLayerSpec, q_chunk: int = 1024) -> torch.Tensor:
    """Full attention; loops over query chunks when Sq > q_chunk."""
    if GQA_GROUPED:
        attend = _attend_block_grouped
    else:
        attend = _attend_block
        k = _repeat_kv(k, spec.n_heads)
        v = _repeat_kv(v, spec.n_heads)
    sq = q.shape[1]
    if sq <= q_chunk or sq % q_chunk != 0:
        return attend(q, k, v, q_pos, k_pos, spec)
    return torch.cat([attend(q[:, i:i + q_chunk], k, v, q_pos[i:i + q_chunk],
                             k_pos, spec)
                      for i in range(0, sq, q_chunk)], dim=1)


def attn_apply(params: Params, x: torch.Tensor, positions: torch.Tensor,
               spec: AttnLayerSpec, q_chunk: int = 1024) -> torch.Tensor:
    """Self-attention over x [B,S,d] (the reference's cross-attention
    arguments come with the encoder-decoder slice)."""
    b, s, _ = x.shape
    h, kvh, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kvh, dh)
    v = (x @ params["wv"]).reshape(b, s, kvh, dh)
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if spec.use_rope:
        q = rope(q, positions, spec.theta)
        k = rope(k, positions, spec.theta)
    out = multihead_attention(q, k, v, positions, positions, spec, q_chunk)
    return out.reshape(b, s, h * dh) @ params["wo"]


# ----------------------------------------------------------- KV cache path

class KVCache(NamedTuple):
    k: torch.Tensor      # [B, W, Hkv, dh]
    v: torch.Tensor      # [B, W, Hkv, dh]
    pos: torch.Tensor    # [W] int32 absolute positions, -1 = empty


def kv_cache_init(batch: int, cache_len: int, spec: AttnLayerSpec,
                  dtype=torch.float32, device=None) -> KVCache:
    """An empty cache.  float32 by default, the type the decode kernel
    takes (the reference defaults to bfloat16; its server asks for
    float32)."""
    w = spec.window if spec.window is not None else cache_len
    w = min(w, cache_len)
    return KVCache(
        k=torch.zeros((batch, w, spec.n_kv_heads, spec.d_head), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, w, spec.n_kv_heads, spec.d_head), dtype=dtype,
                      device=device),
        pos=torch.full((w,), -1, dtype=torch.int32, device=device))


def attn_decode_step(params: Params, x: torch.Tensor, pos: int,
                     cache: KVCache, spec: AttnLayerSpec) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x [B,1,d], pos the token's position (an int).

    Ring-buffer write at slot ``pos % W``, made in place into the cache's
    tensors (which are returned), then attention through
    ``decode_attention``.  The softcapped and the non-causal decode are
    not ported (gemma2's decode comes with its own slice)."""
    if spec.softcap is not None or not spec.causal:
        raise NotImplementedError(
            "the decode kernel computes causal attention without a logit "
            "softcap; gemma2's softcapped decode comes with its own slice")
    pos = int(pos)
    b = x.shape[0]
    h, kvh, dh = spec.n_heads, spec.n_kv_heads, spec.d_head
    q = (x @ params["wq"]).reshape(b, 1, h, dh)
    k_new = (x @ params["wk"]).reshape(b, 1, kvh, dh)
    v_new = (x @ params["wv"]).reshape(b, 1, kvh, dh)
    if spec.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k_new = rmsnorm(params["k_norm"], k_new)
    pos_vec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    if spec.use_rope:           # q and k share the token's angles
        angles = _rope_angles(pos_vec, spec.theta, dh)
        q = _apply_rope(q, *angles)
        k_new = _apply_rope(k_new, *angles)

    slot = pos % cache.k.shape[1]
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[slot] = pos

    out = decode_attention(q, cache.k, cache.v, cache.pos, pos,
                           window=spec.window, n_heads=h)
    y = out.reshape(b, 1, h * dh) @ params["wo"]
    return y, cache


def kv_cache_from_prefill(k: torch.Tensor, v: torch.Tensor, spec: AttnLayerSpec,
                          cache_len: int) -> KVCache:
    """Build a ring-consistent cache from prefill K/V ([B,S,Hkv,dh])."""
    s = k.shape[1]
    w = spec.window if spec.window is not None else cache_len
    w = min(w, cache_len)
    positions = torch.arange(s, dtype=torch.int32, device=k.device)
    if s >= w:
        k_w, v_w, p_w = k[:, s - w:], v[:, s - w:], positions[s - w:]
        shift = s % w
        return KVCache(k=torch.roll(k_w, shift, dims=1),
                       v=torch.roll(v_w, shift, dims=1),
                       pos=torch.roll(p_w, shift, dims=0))
    pad = w - s
    return KVCache(
        k=F.pad(k, (0, 0, 0, 0, 0, pad)),
        v=F.pad(v, (0, 0, 0, 0, 0, pad)),
        pos=torch.cat([positions, torch.full((pad,), -1, dtype=torch.int32,
                                             device=k.device)]))
