"""Mixture-of-Experts layer with GShard-style capacity dispatch, as
``repro.models.moe``.

Token routing uses top-k gating with cumulative-sum position ranking and a
static per-expert capacity C = ceil(T * k / E * capacity_factor) (at least
8, rounded up to 8); tokens beyond capacity are dropped (their gate mass is
not added; the residual stream carries them).  Dispatch and combine are
dense, as the reference's: every token is scattered into an [E, C, d]
buffer, every expert runs its products on its C slots, and the outputs
are gathered back.  So every expert's weights are read on every call,
decode included.

Top-k is a stable descending sort of the router's float32 probabilities:
among equal probabilities the lower expert index comes first, as
``jax.lax.top_k`` orders them (``torch.topk`` promises no order), so ties
rank and route as in the reference.

The scatter (``index_put_`` with ``accumulate=True``) writes each kept
(expert, slot) pair once; a dropped token adds zeros at slot C - 1, as the
reference's ``.at[].add`` with the clamped index does.  The sum is the
same in any order of accumulation.

Shared experts (DeepSeek/llama4) run as a plain dense MLP on every token.
Auxiliary outputs: load-balance loss (Switch-style f*P), router z-loss and
the share of (token, slot) pairs dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, _normal, dot, mlp_apply, mlp_init


class MoEAux(NamedTuple):
    load_balance: torch.Tensor   # scalar
    z_loss: torch.Tensor         # scalar
    dropped_frac: torch.Tensor   # scalar, fraction of (token, slot) pairs dropped


def moe_init(gen, d_model: int, cfg: MoEConfig, device=None) -> Params:
    e, ff = cfg.n_experts, cfg.d_ff_expert
    s_in, s_ff = d_model ** -0.5, ff ** -0.5
    p = {
        "router": _normal(gen, (d_model, e), s_in, device),
        "experts": {
            "w1": _normal(gen, (e, d_model, ff), s_in, device),
            "w3": _normal(gen, (e, d_model, ff), s_in, device),
            "w2": _normal(gen, (e, ff, d_model), s_ff, device),
        },
    }
    if cfg.n_shared:
        p["shared"] = mlp_init(gen, d_model, cfg.d_ff_shared, device)
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)   # round up to 8, as the reference


def route(params: Params, x: torch.Tensor, cfg: MoEConfig):
    """The router's float32 logits and probabilities [T, E], and the top-k
    probabilities and experts [T, k], in descending order (lower index
    first among equals)."""
    logits = dot(x, params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    return logits, probs, top.values[:, :cfg.top_k], top.indices[:, :cfg.top_k]


def moe_apply(params: Params, x: torch.Tensor, cfg: MoEConfig,
              act: str = "silu") -> tuple[torch.Tensor, MoEAux]:
    """x [T, d] (tokens flattened) -> (out [T, d], aux losses).

    The reference loops over the k slots; here the (slot, token) pairs are
    taken at once in slot-major order, which gives the same queue: an
    exclusive cumsum over them counts, for each pair, the earlier pairs of
    its slot and every pair of the slots before at its expert."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg)

    logits, probs, gates, idx = route(params, x, cfg)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # --- position ranking: slot j tokens queue behind slots < j ----------
    expert = idx.t().reshape(-1)                              # [k T], slot-major
    oh = (torch.arange(e, device=x.device)[:, None] == expert).to(torch.int32)
    pos = (torch.cumsum(oh, dim=1, dtype=torch.int32) * oh).sum(0) - 1   # [k T]
    keep = pos < c
    buf = x.new_zeros((e, c, d))
    buf.index_put_((expert, torch.where(keep, pos, c - 1)),
                   torch.where(keep[:, None], x.repeat(k, 1), 0), accumulate=True)

    # --- expert FFNs -------------------------------------------------------
    w = params["experts"]
    gate_act = dot(buf, w["w1"])                              # [E, C, ff]
    # jax.nn.gelu's default is the tanh approximation; torch's is exact
    gate_act = (F.silu(gate_act) if act == "silu"
                else F.gelu(gate_act, approximate="tanh"))
    up = dot(buf, w["w3"])
    expert_out = dot(gate_act * up, w["w2"])                  # [E, C, d]

    # --- combine, slot by slot as the reference adds them -----------------
    y = expert_out[expert, torch.clamp(pos, max=c - 1)]       # [k T, d]
    y = torch.where(keep[:, None], gates.t().reshape(-1, 1).to(x.dtype) * y, 0)
    out = torch.zeros_like(x)
    for part in y.view(k, t, d):
        out = out + part
    dropped = (1.0 - keep.to(torch.float32)).view(k, t).mean(-1).sum()

    if "shared" in params:
        out = out + mlp_apply(params["shared"], x, act)

    # --- aux losses -------------------------------------------------------
    frac = oh.sum(1).to(torch.float32) / (t * k)              # the chosen experts' bincount
    mean_prob = probs.mean(0)
    lb = e * torch.sum(frac * mean_prob)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return out, MoEAux(load_balance=lb, z_loss=z, dropped_frac=dropped / k)
