"""Model-zoo API, as ``repro.models.zoo``: parameter counting and batch
construction for the blocks the port runs.  The loss (``lm_loss``) comes
with the training slice."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves


def param_count(cfg: ArchConfig) -> int:
    """Parameter count from the parameter tree's shapes, built on the
    "meta" device (no allocation)."""
    shapes = T.init_params(cfg, torch.Generator(), device="meta")
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(shapes))


def grad_size_bits(cfg: ArchConfig, bits_per_param: int = 32) -> float:
    """Uplink payload S for the paper's problem (7): the gradient of the
    trainable parameters."""
    return float(param_count(cfg)) * bits_per_param


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
