"""Model-zoo API, as ``repro.models.zoo``: parameter counting (all or
active), the loss and batch construction for the blocks the port runs.

The FL integration: ``lm_loss`` takes per-example ``loss_weights`` that
encode alpha_i * m_i of the paper's eq. (4), so the gradient of the
weighted loss is the FedSGD server sum."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves_with_path


def param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameter count from the parameter tree's shapes, built on the
    "meta" device (no allocation).

    active_only: the routed experts' leaves (under an ``"experts"`` key)
    counted at top_k / n_experts, leaf by leaf (the standard "activated
    params" figure; shared experts count whole)."""
    shapes = T.init_params(cfg, torch.Generator(), device="meta")
    total = 0
    for path, leaf in tree_leaves_with_path(shapes):
        n = int(np.prod(leaf.shape))
        if active_only and cfg.moe is not None and "experts" in path:
            n = int(n * cfg.moe.top_k / cfg.moe.n_experts)
        total += n
    return total


def grad_size_bits(cfg: ArchConfig, bits_per_param: int = 32) -> float:
    """Uplink payload S for the paper's problem (7): the gradient of the
    trainable parameters."""
    return float(param_count(cfg)) * bits_per_param


def lm_loss(cfg: ArchConfig, params, batch: dict,
            q_chunk: int = 1024, remat=True,
            aux_coef: tuple[float, float] = (1e-2, 1e-3)):
    """Next-token CE with optional per-example FL weights, as the
    reference's: the float32 log-softmax over all ``padded_vocab``
    columns, -100 labels masked, each example's mean over its valid
    tokens, then ``sum(per_example * loss_weights)`` (else the mean), plus
    the MoE's aux terms (summed over its layers; zeros without one).

    batch: tokens [B,S], labels [B,S] (-100 = masked), optional
    loss_weights [B].  Returns (loss, {"ce", "load_balance", "z_loss",
    "moe_dropped"})."""
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        raise NotImplementedError("the vision prefix's label padding comes "
                                  "with the internvl2-2b slice")
    logits, aux = T.forward(cfg, params, batch, q_chunk=q_chunk, remat=remat)
    labels = batch["labels"]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).to(torch.int64)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    per_example = nll.sum(-1) / torch.clamp(valid.sum(-1), min=1)     # [B]
    w = batch.get("loss_weights")
    loss = per_example.mean() if w is None else torch.sum(per_example * w)
    lb, z, dropped = aux[0], aux[1], aux[2]
    total = loss + aux_coef[0] * lb + aux_coef[1] * z
    return total, {"ce": loss, "load_balance": lb, "z_loss": z,
                   "moe_dropped": dropped}


def make_batch(cfg: ArchConfig, shape: InputShape, rng: np.random.Generator,
               with_weights: bool = True, device=None) -> dict:
    """Concrete random batch of text tokens, as the reference draws it
    from ``rng``, on ``device`` (the modality frontends are not
    ported)."""
    if cfg.frontend is not None:
        raise NotImplementedError("batches for the modality frontends come "
                                  "with their slices")
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if with_weights:
        w = rng.uniform(0, 1, (b,)).astype(np.float32)
        batch["loss_weights"] = w / w.sum()
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
