"""prefill_step / serve_step builders, as ``repro.launch.steps``.

``serve_step`` is one decode step against a KV cache; ``prefill_step`` is
one full forward pass.  ``train_step`` comes with the training slice.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig, q_chunk: int = 1024) -> Callable:
    def prefill_step(params, batch):
        logits, _ = T.forward(cfg, params, batch, q_chunk=q_chunk)
        return logits

    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, batch):
        return T.decode_step(cfg, params, cache, batch["tokens"], batch["pos"])

    return serve_step
