"""Model assembly: ArchConfig -> init / forward / decode_step, as
``repro.models.transformer``, for the dense-attention blocks.

The parameter tree is the reference's: ``"stack"`` holds the repeating
period's layers (``{"l0": ..., "l1": ...}``) with every leaf carrying a
leading ``reps`` axis, and the irregular ``"prefix"``/``"tail"`` layers
(gemma3's 26 = 4*6 + 2) are lists.  A Python loop over ``reps`` takes the
place of the reference's ``lax.scan``; the reference's remat of its scan
body becomes ``torch.utils.checkpoint`` around each repeated unit (its
sharding constraints have no counterpart on one device).

Embedding tables are padded to a multiple of 256 rows; logits beyond the
true vocab are masked to the dtype's minimum at decode.

Block kinds (configs/base.py): the port runs ``attn`` and ``gattn``
(gemma2's with both logit softcaps), ``mla`` (DeepSeek's latent
attention, ``models/mla.py``), each with a dense or an MoE MLP
(``models/moe.py``), ``mamba`` (Mamba2, no MLP) and ``shared_attn``
(zamba2): an attention+MLP block whose parameters,
``params["shared_attn"]``, are shared across all its occurrences, then
the layer's own Mamba2 mixer.  As in the reference, each ``shared_attn``
layer also carries an ``ln2`` and ``mlp`` of its own (its MLP kind is
"dense") that nothing reads.  The whisper encoder and the vision prefix
raise ``NotImplementedError`` naming the slice that brings them.

Each layer's forward returns ``(x, aux)``: the MoE's (load balance,
z-loss, dropped share), zeros for the other MLPs; ``forward`` sums them
over every layer.  Decode runs the MoE on the step's [B, d] rows (T = B),
whose capacity (at least 8 slots an expert) drops no token for B <= 8.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.tree import tree_leaves, tree_map

Params = dict
LayerKind = tuple  # (mixer, mlp) e.g. ("attn", "dense"), ("mla", "moe")

VOCAB_PAD = 256

_NOT_PORTED = {
    "encoder": "the whisper-large-v3 slice",
    "vision": "the internvl2-2b slice",
}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} blocks are not ported yet; they come with "
        f"{_NOT_PORTED[what]}")


def _check_supported(cfg: ArchConfig) -> None:
    """Raise for the frontends this slice does not run."""
    if cfg.enc_layers:
        raise _not_ported("encoder")
    if cfg.frontend is not None:
        raise _not_ported("vision" if cfg.frontend.kind == "vision" else "encoder")


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
    mixer, mlp = kind
    if mixer in ("mamba", "shared_attn"):
        p = {"ln": L.rmsnorm_init(cfg.d_model, device),
             "mamba": M.mamba_init(gen, cfg.d_model, cfg.ssm, device)}
    elif mixer == "mla":
        p = {"ln1": L.rmsnorm_init(cfg.d_model, device),
             "mla": MLA.mla_init(gen, cfg.d_model, cfg.attn.n_heads, cfg.mla,
                                 device)}
    elif mixer in ("attn", "gattn"):
        p = {"ln1": L.rmsnorm_init(cfg.d_model, device),
             "attn": L.attn_init(gen, cfg.d_model, _attn_spec(cfg, mixer),
                                 device)}
    else:
        raise ValueError(mixer)
    if mlp == "dense":      # a shared_attn layer's own MLP is never read
        p["ln2"] = L.rmsnorm_init(cfg.d_model, device)
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, device)
    elif mlp == "moe":
        p["ln2"] = L.rmsnorm_init(cfg.d_model, device)
        p["moe"] = MOE.moe_init(gen, cfg.d_model, cfg.moe, device)
    return p


def _init_shared_attn(gen, cfg: ArchConfig, device=None) -> Params:
    return {
        "ln1": L.rmsnorm_init(cfg.d_model, device),
        "attn": L.attn_init(gen, cfg.d_model, _attn_spec(cfg, "attn"), device),
        "ln2": L.rmsnorm_init(cfg.d_model, device),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, device),
    }


# --------------------------------------------------------------- forward

class FwdCtx(NamedTuple):
    positions: torch.Tensor
    shared: Optional[Params] = None       # zamba2's shared block
    q_chunk: int = 1024


def apply_layer(params: Params, x: torch.Tensor, cfg: ArchConfig,
                kind: LayerKind, ctx: FwdCtx) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux): aux the MoE's (load balance, z-loss, dropped
    share), zeros for the other MLPs."""
    mixer, mlp = kind
    aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    if mixer == "shared_attn":
        sp = ctx.shared
        x = x + L.attn_apply(sp["attn"], L.rmsnorm(sp["ln1"], x),
                             ctx.positions, _attn_spec(cfg, "attn"), ctx.q_chunk)
        x = x + L.mlp_apply(sp["mlp"], L.rmsnorm(sp["ln2"], x), cfg.mlp_act)
        return x + M.mamba_apply(params["mamba"], L.rmsnorm(params["ln"], x),
                                 cfg.ssm), aux
    if mixer == "mamba":
        return x + M.mamba_apply(params["mamba"], L.rmsnorm(params["ln"], x),
                                 cfg.ssm), aux
    if mixer == "mla":
        x = x + MLA.mla_apply(params["mla"], L.rmsnorm(params["ln1"], x),
                              ctx.positions, cfg.attn.n_heads, cfg.mla,
                              cfg.attn.rope_theta, ctx.q_chunk)
    else:
        x = x + L.attn_apply(params["attn"], L.rmsnorm(params["ln1"], x),
                             ctx.positions, _attn_spec(cfg, mixer), ctx.q_chunk)
    if mlp == "dense":
        x = x + L.mlp_apply(params["mlp"], L.rmsnorm(params["ln2"], x), cfg.mlp_act)
    elif mlp == "moe":
        b, s, d = x.shape
        y, moe_aux = MOE.moe_apply(params["moe"],
                                   L.rmsnorm(params["ln2"], x).reshape(b * s, d),
                                   cfg.moe, cfg.mlp_act)
        x = x + y.reshape(b, s, d)
        aux = torch.stack([moe_aux.load_balance, moe_aux.z_loss,
                           moe_aux.dropped_frac])
    return x, aux


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
    if any(k[0] == "shared_attn" for k in plan.all_layers()):
        p["shared_attn"] = _init_shared_attn(gen, cfg, device)
    if plan.prefix:
        p["prefix"] = [init_layer(gen, cfg, kind, device) for kind in plan.prefix]
    if plan.reps:
        p["stack"] = _init_stack(gen, cfg, plan, device)
    if plan.tail:
        p["tail"] = [init_layer(gen, cfg, kind, device) for kind in plan.tail]
    return p


def _init_stack(gen, cfg: ArchConfig, plan: LayerPlan, device) -> Params:
    """The repeated units' parameters, each leaf with a leading ``reps``
    axis: unit r drawn after unit r - 1 and written into its slot, so
    that the stack and one unit are held at once, not two stacks."""
    stack = None
    for r in range(plan.reps):
        one = {f"l{j}": init_layer(gen, cfg, kind, device)
               for j, kind in enumerate(plan.unit)}
        if stack is None:
            stack = tree_map(lambda x: x.new_empty((plan.reps, *x.shape)), one)
        tree_map(lambda dst, src: dst[r].copy_(src), stack, one)
    return stack


def _embed_inputs(cfg: ArchConfig, params: Params, batch: dict) -> torch.Tensor:
    # the reference scales by a numpy float32, which jax does not treat as
    # weakly typed: bfloat16 rows times it are float32
    rows = params["embed"][batch["tokens"]]
    scale = float(np.sqrt(cfg.d_model).astype(np.float32))
    return rows.to(torch.promote_types(rows.dtype, torch.float32)) * scale


def _unembed(cfg: ArchConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params["final_ln"], x)
    unembed = params["unembed"] if "unembed" in params else params["embed"].T
    logits = x @ unembed.to(x.dtype)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


# "dots" remat saves the outputs of the weight products (2-D ``mm``; the
# reference's ``dots_with_no_batch_dims_saveable``) and recomputes the rest
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat):
    """``fn`` under the reference's remat option: True / "full" saves
    nothing of its inside for the backward, "dots" saves the weight
    products' outputs, False is ``fn`` itself."""
    if not remat:
        return fn
    if remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _save_dots))
    if remat is True or remat == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat must be True, 'full', 'dots' or False, got {remat!r}")


def _units(stack: Params, reps: int) -> list[Params]:
    """The stacked layers' parameters, one tree per repetition (views:
    one ``unbind`` a leaf, so the backward gathers each leaf's gradient
    once)."""
    parts = {id(a): a.unbind(0) for a in tree_leaves(stack)}
    return [tree_map(lambda a: parts[id(a)][r], stack) for r in range(reps)]


def forward(cfg: ArchConfig, params: Params, batch: dict,
            q_chunk: int = 1024, remat=True) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: tokens [B,S].  Returns (logits [B,S,V], aux[3]); aux holds
    the MoE losses, zeros for the dense blocks.

    ``remat`` (True / "full", "dots" or False, as the reference's) applies
    to each repeated unit of ``params["stack"]`` while autograd records;
    it changes no number."""
    _check_supported(cfg)
    plan = layer_plan(cfg)
    x = _embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    ctx = FwdCtx(positions=positions, shared=params.get("shared_attn"),
                 q_chunk=q_chunk)
    aux_total = torch.zeros((3,), dtype=torch.float32, device=x.device)
    for lp, kind in zip(params.get("prefix", []), plan.prefix):
        x, aux = apply_layer(lp, x, cfg, kind, ctx)
        aux_total = aux_total + aux

    def unit(x, unit_params):
        aux_u = torch.zeros((3,), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(plan.unit):
            x, aux = apply_layer(unit_params[f"l{j}"], x, cfg, kind, ctx)
            aux_u = aux_u + aux
        return x, aux_u

    if plan.reps:
        body = _remat(unit, remat) if torch.is_grad_enabled() else unit
        for unit_params in _units(params["stack"], plan.reps):
            x, aux = body(x, unit_params)
            aux_total = aux_total + aux
    for lp, kind in zip(params.get("tail", []), plan.tail):
        x, aux = apply_layer(lp, x, cfg, kind, ctx)
        aux_total = aux_total + aux
    return _unembed(cfg, params, x), aux_total   # logits over padded_vocab(cfg) columns


# ------------------------------------------------------------------ decode

def init_layer_cache(cfg: ArchConfig, kind: LayerKind, batch: int,
                     cache_len: int, dtype=torch.float32, device=None) -> dict:
    if kind[0] == "shared_attn":     # one ring per occurrence of the block
        return {"mamba": M.mamba_cache_init(batch, cfg.d_model, cfg.ssm, dtype,
                                            device),
                "shared_kv": L.kv_cache_init(batch, cache_len,
                                             _attn_spec(cfg, "attn"), dtype,
                                             device)}
    if kind[0] == "mamba":
        return {"mamba": M.mamba_cache_init(batch, cfg.d_model, cfg.ssm, dtype,
                                            device)}
    if kind[0] == "mla":
        return {"mla": MLA.mla_cache_init(batch, cache_len, cfg.mla, dtype,
                                          device)}
    spec = _attn_spec(cfg, kind[0])
    return {"kv": L.kv_cache_init(batch, cache_len, spec, dtype, device)}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Empty caches for every layer, in the parameter tree's layout
    (float32 by default: the decode kernel's type; Mamba layers keep their
    conv window and state, whatever ``cache_len``)."""
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
                 kind: LayerKind, entry: dict, pos: int,
                 shared: Optional[Params] = None):
    mixer, mlp = kind
    if mixer == "shared_attn":
        y, kv = L.attn_decode_step(shared["attn"], L.rmsnorm(shared["ln1"], x),
                                   pos, entry["shared_kv"],
                                   _attn_spec(cfg, "attn"))
        x = x + y
        x = x + L.mlp_apply(shared["mlp"], L.rmsnorm(shared["ln2"], x),
                            cfg.mlp_act)
        y, mc = M.mamba_decode_step(params["mamba"], L.rmsnorm(params["ln"], x),
                                    entry["mamba"], cfg.ssm)
        return x + y, {"mamba": mc, "shared_kv": kv}
    if mixer == "mamba":
        y, mc = M.mamba_decode_step(params["mamba"], L.rmsnorm(params["ln"], x),
                                    entry["mamba"], cfg.ssm)
        return x + y, {"mamba": mc}
    if mixer == "mla":
        y, c = MLA.mla_decode_step(params["mla"], L.rmsnorm(params["ln1"], x),
                                   pos, entry["mla"], cfg.attn.n_heads,
                                   cfg.mla, cfg.attn.rope_theta)
        new_entry = {"mla": c}
    else:
        y, kv = L.attn_decode_step(params["attn"], L.rmsnorm(params["ln1"], x),
                                   pos, entry["kv"], _attn_spec(cfg, mixer))
        new_entry = {"kv": kv}
    x = x + y
    if mlp == "dense":
        x = x + L.mlp_apply(params["mlp"], L.rmsnorm(params["ln2"], x),
                            cfg.mlp_act)
    elif mlp == "moe":      # T = B rows: at B <= 8 no token is dropped
        b = x.shape[0]
        y, _ = MOE.moe_apply(params["moe"],
                             L.rmsnorm(params["ln2"], x).reshape(b, -1),
                             cfg.moe, cfg.mlp_act)
        x = x + y.reshape(b, 1, -1)
    return x, new_entry


def decode_step(cfg: ArchConfig, params: Params, cache: dict,
                tokens: torch.Tensor, pos: int) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B,1], pos the next position (an int).

    The caches are written in place (each attention layer's new slot, each
    Mamba layer's conv window and state) and returned; the stacked layers'
    entries are views into the stacked cache."""
    _check_supported(cfg)
    plan = layer_plan(cfg)
    x = _embed_inputs(cfg, params, {"tokens": tokens})
    shared = params.get("shared_attn")
    new_cache: dict = {}
    if plan.prefix:
        new_cache["prefix"] = []
        for lp, kind, entry in zip(params["prefix"], plan.prefix, cache["prefix"]):
            x, e = decode_layer(lp, x, cfg, kind, entry, pos, shared)
            new_cache["prefix"].append(e)
    if plan.reps:
        for r in range(plan.reps):
            unit_params = tree_map(lambda a: a[r], params["stack"])
            unit_cache = tree_map(lambda a: a[r], cache["stack"])
            for j, kind in enumerate(plan.unit):
                x, _ = decode_layer(unit_params[f"l{j}"], x, cfg, kind,
                                    unit_cache[f"l{j}"], pos, shared)
        new_cache["stack"] = cache["stack"]
    if plan.tail:
        new_cache["tail"] = []
        for lp, kind, entry in zip(params["tail"], plan.tail, cache["tail"]):
            x, e = decode_layer(lp, x, cfg, kind, entry, pos, shared)
            new_cache["tail"].append(e)

    logits = _unembed(cfg, params, x)
    if padded_vocab(cfg) != cfg.vocab:    # mask pad columns for sampling
        logits[..., cfg.vocab:] = torch.finfo(logits.dtype).min
    return logits, new_cache
