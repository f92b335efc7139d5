"""Model assembly: ArchConfig -> init / forward / decode_step, as
``repro.models.transformer``, for the dense-attention blocks.

The parameter tree is the reference's: ``"stack"`` holds the repeating
period's layers (``{"l0": ..., "l1": ...}``) with every leaf carrying a
leading ``reps`` axis, and the irregular ``"prefix"``/``"tail"`` layers
(gemma3's 26 = 4*6 + 2) are lists.  A Python loop over ``reps`` takes the
place of the reference's ``lax.scan``; its remat and sharding constraints
have no counterpart in one-device inference.

Embedding tables are padded to a multiple of 256 rows; logits beyond the
true vocab are masked to the dtype's minimum at decode.

Block kinds (configs/base.py): this slice runs ``attn`` and ``gattn`` with
dense MLPs.  ``mla``, ``mamba``, ``shared_attn``, MoE MLPs, the whisper
encoder and the vision prefix raise ``NotImplementedError`` naming the
slice that brings them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

Params = dict
LayerKind = tuple  # (mixer, mlp) e.g. ("attn", "dense")

VOCAB_PAD = 256

_NOT_PORTED = {
    "mamba": "the mamba2-780m slice",
    "shared_attn": "the zamba2-7b slice",
    "mla": "the deepseek-v2-lite-16b slice",
    "moe": "the MoE slice (deepseek-v2-lite-16b, llama4-scout)",
    "encoder": "the whisper-large-v3 slice",
    "vision": "the internvl2-2b slice",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} blocks are not ported yet; they come with "
        f"{_NOT_PORTED[what]}")


def _check_kind(kind: LayerKind) -> None:
    """Raise unless the layer is an attention block with a dense MLP."""
    mixer, mlp = kind
    if mixer not in ("attn", "gattn"):
        raise _not_ported(mixer)
    if mlp != "dense":
        raise _not_ported(mlp)


def _check_supported(cfg: ArchConfig) -> None:
    """Raise for the blocks and frontends this slice does not run."""
    if cfg.enc_layers:
        raise _not_ported("encoder")
    if cfg.frontend is not None:
        raise _not_ported("vision" if cfg.frontend.kind == "vision" else "encoder")
    for kind in layer_plan(cfg).all_layers():
        _check_kind(kind)


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab // VOCAB_PAD) * VOCAB_PAD


# ----------------------------------------------------------------- planning

class LayerPlan(NamedTuple):
    prefix: tuple[LayerKind, ...]
    unit: tuple[LayerKind, ...]
    reps: int
    tail: tuple[LayerKind, ...]

    def all_layers(self) -> list[LayerKind]:
        return list(self.prefix) + list(self.unit) * self.reps + list(self.tail)


def _mlp_kind(cfg: ArchConfig, layer_idx: int, mixer: str) -> str:
    if mixer == "mamba":
        return "none"
    if cfg.moe is not None and layer_idx >= cfg.moe.first_dense:
        return "moe"
    return "dense"


def layer_plan(cfg: ArchConfig) -> LayerPlan:
    mixers = cfg.layer_kinds()
    kinds = [(m, _mlp_kind(cfg, i, m)) for i, m in enumerate(mixers)]
    plen = len(cfg.period)
    n_prefix = cfg.moe.first_dense if cfg.moe else 0
    prefix = tuple(kinds[:n_prefix])
    rest = kinds[n_prefix:]
    # the repeating unit must align with the period pattern of `rest`
    if len(rest) >= plen and n_prefix % plen == 0:
        unit = tuple(rest[:plen])
        reps = 0
        while (reps + 1) * plen <= len(rest) and \
                tuple(rest[reps * plen:(reps + 1) * plen]) == unit:
            reps += 1
        tail = tuple(rest[reps * plen:])
    else:
        unit, reps, tail = (), 0, tuple(rest)
    if reps <= 1:   # nothing gained by stacking
        return LayerPlan(prefix=prefix + tuple(unit) * reps + tail,
                         unit=(), reps=0, tail=())
    return LayerPlan(prefix=prefix, unit=unit, reps=reps, tail=tail)


# ---------------------------------------------------------- per-layer build

def _attn_spec(cfg: ArchConfig, mixer: str) -> L.AttnLayerSpec:
    # whisper's spec (no RoPE, non-causal cross-attention) comes with its slice
    return L.layer_spec(cfg.attn, mixer)


def init_layer(gen, cfg: ArchConfig, kind: LayerKind, device=None) -> Params:
    _check_kind(kind)
    mixer, _ = kind
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attn_init(gen, cfg.d_model, _attn_spec(cfg, mixer), device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, device),
    }


# --------------------------------------------------------------- forward

class FwdCtx(NamedTuple):
    positions: torch.Tensor
    q_chunk: int = 1024


def apply_layer(params: Params, x: torch.Tensor, cfg: ArchConfig,
                kind: LayerKind, ctx: FwdCtx) -> torch.Tensor:
    _check_kind(kind)
    spec = _attn_spec(cfg, kind[0])
    x = x + L.attn_apply(params["attn"], L.rmsnorm(params["ln1"], x),
                         ctx.positions, spec, ctx.q_chunk)
    return x + L.mlp_apply(params["mlp"], L.rmsnorm(params["ln2"], x), cfg.mlp_act)


# ----------------------------------------------------------------- model

def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters at the reference's shapes and scales, drawn from
    ``generator`` (which lives on ``device``; any generator on "meta",
    which allocates nothing)."""
    _check_supported(cfg)
    plan = layer_plan(cfg)
    v_pad = padded_vocab(cfg)
    gen = generator
    p: Params = {
        "embed": L._normal(gen, (v_pad, cfg.d_model), cfg.d_model ** -0.5, device),
        "final_ln": L.rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L._normal(gen, (cfg.d_model, v_pad),
                                 cfg.d_model ** -0.5, device)
    if plan.prefix:
        p["prefix"] = [init_layer(gen, cfg, kind, device) for kind in plan.prefix]
    if plan.reps:
        units = [{f"l{j}": init_layer(gen, cfg, kind, device)
                  for j, kind in enumerate(plan.unit)} for _ in range(plan.reps)]
        p["stack"] = tree_map(lambda *xs: torch.stack(xs), *units)
    if plan.tail:
        p["tail"] = [init_layer(gen, cfg, kind, device) for kind in plan.tail]
    return p


def _embed_inputs(cfg: ArchConfig, params: Params, batch: dict) -> torch.Tensor:
    scale = float(np.sqrt(cfg.d_model).astype(np.float32))
    return params["embed"][batch["tokens"]] * scale


def _unembed(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_ln"], x)
    unembed = params["unembed"] if "unembed" in params else params["embed"].T
    logits = x @ unembed.to(x.dtype)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


def forward(cfg: ArchConfig, params: Params, batch: dict,
            q_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens [B,S].  Returns (logits [B,S,V], aux[3]); aux holds
    the MoE losses, zeros for the dense blocks."""
    _check_supported(cfg)
    plan = layer_plan(cfg)
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    ctx = FwdCtx(positions=positions, q_chunk=q_chunk)
    for lp, kind in zip(params.get("prefix", []), plan.prefix):
        x = apply_layer(lp, x, cfg, kind, ctx)
    for r in range(plan.reps):
        unit_params = tree_map(lambda a: a[r], params["stack"])
        for j, kind in enumerate(plan.unit):
            x = apply_layer(unit_params[f"l{j}"], x, cfg, kind, ctx)
    for lp, kind in zip(params.get("tail", []), plan.tail):
        x = apply_layer(lp, x, cfg, kind, ctx)
    aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    return _unembed(cfg, params, x), aux     # logits over padded_vocab(cfg) columns


# ------------------------------------------------------------------ decode

def init_layer_cache(cfg: ArchConfig, kind: LayerKind, batch: int,
                     cache_len: int, dtype=torch.float32, device=None) -> dict:
    _check_kind(kind)
    spec = _attn_spec(cfg, kind[0])
    return {"kv": L.kv_cache_init(batch, cache_len, spec, dtype, device)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Empty caches for every layer, in the parameter tree's layout
    (float32 by default: the decode kernel's type)."""
    _check_supported(cfg)
    plan = layer_plan(cfg)
    cache: dict = {}
    if plan.prefix:
        cache["prefix"] = [init_layer_cache(cfg, k, batch, cache_len, dtype, device)
                           for k in plan.prefix]
    if plan.reps:
        one = {f"l{j}": init_layer_cache(cfg, kind, batch, cache_len, dtype, device)
               for j, kind in enumerate(plan.unit)}
        cache["stack"] = tree_map(
            lambda x: x[None].expand((plan.reps,) + tuple(x.shape)).clone(), one)
    if plan.tail:
        cache["tail"] = [init_layer_cache(cfg, k, batch, cache_len, dtype, device)
                         for k in plan.tail]
    return cache


def decode_layer(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 kind: LayerKind, entry: dict, pos: int):
    _check_kind(kind)
    spec = _attn_spec(cfg, kind[0])
    y, kv = L.attn_decode_step(params["attn"], L.rmsnorm(params["ln1"], x),
                               pos, entry["kv"], spec)
    x = x + y
    x = x + L.mlp_apply(params["mlp"], L.rmsnorm(params["ln2"], x), cfg.mlp_act)
    return x, {"kv": kv}


def decode_step(cfg: ArchConfig, params: Params, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B,1], pos the next position (an int).

    The caches are written in place (each layer's new slot) and returned;
    the stacked layers' entries are views into the stacked cache."""
    _check_supported(cfg)
    plan = layer_plan(cfg)
    x = _embed_inputs(cfg, params, {"tokens": tokens})
    new_cache: dict = {}
    if plan.prefix:
        new_cache["prefix"] = []
        for lp, kind, entry in zip(params["prefix"], plan.prefix, cache["prefix"]):
            x, e = decode_layer(lp, x, cfg, kind, entry, pos)
            new_cache["prefix"].append(e)
    if plan.reps:
        for r in range(plan.reps):
            unit_params = tree_map(lambda a: a[r], params["stack"])
            unit_cache = tree_map(lambda a: a[r], cache["stack"])
            for j, kind in enumerate(plan.unit):
                x, _ = decode_layer(unit_params[f"l{j}"], x, cfg, kind,
                                    unit_cache[f"l{j}"], pos)
        new_cache["stack"] = cache["stack"]
    if plan.tail:
        new_cache["tail"] = []
        for lp, kind, entry in zip(params["tail"], plan.tail, cache["tail"]):
            x, e = decode_layer(lp, x, cfg, kind, entry, pos)
            new_cache["tail"].append(e)

    logits = _unembed(cfg, params, x)
    if padded_vocab(cfg) != cfg.vocab:    # mask pad columns for sampling
        logits[..., cfg.vocab:] = torch.finfo(logits.dtype).min
    return logits, new_cache
