"""The paper's ML model: a 3-layer CNN with 199,213 parameters.

conv(8) -> pool -> conv(16) -> pool -> fc(249) -> fc(10) on 28x28x1
images, as ``repro.models.cnn``.  Parameters are a nested dict with the
reference's names and layouts: conv weights HWIO ``[3, 3, Cin, Cout]``,
dense weights ``[in, out]``, images NHWC.  The functions are plain
tensor code, so ``torch.func`` can take per-client gradients of them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves

HIDDEN = 249


def init(generator: torch.Generator, device=None) -> dict:
    """He-normal weights drawn from ``generator`` (a CPU generator), zero
    biases; the tensors are placed on ``device``."""
    dev = resolve_device(device)

    def he(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * math.sqrt(2.0 / fan_in)).to(dev)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    return {
        "conv1": {"w": he((3, 3, 1, 8), 9), "b": zeros(8)},
        "conv2": {"w": he((3, 3, 8, 16), 72), "b": zeros(16)},
        "fc1": {"w": he((7 * 7 * 16, HIDDEN), 7 * 7 * 16), "b": zeros(HIDDEN)},
        "fc2": {"w": he((HIDDEN, 10), HIDDEN), "b": zeros(10)},
    }


def _conv(x, w, b):
    """3x3 SAME conv as an im2col matmul, the reference's formulation."""
    kh, kw, cin, cout = w.shape
    h, wd = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = torch.stack([xp[:, i:i + h, j:j + wd, :]
                           for i in range(kh) for j in range(kw)], dim=3)
    flat = patches.reshape(x.shape[0], h, wd, kh * kw * cin)
    return flat @ w.reshape(kh * kw * cin, cout) + b


def _pool(x):
    """2x2/stride-2 max pool via reshape (dims are even: 28 -> 14 -> 7)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def apply(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images [B, 28, 28, 1] -> logits [B, 10]."""
    x = torch.relu(_conv(images, params["conv1"]["w"], params["conv1"]["b"]))
    x = _pool(x)                                    # 14x14x8
    x = torch.relu(_conv(x, params["conv2"]["w"], params["conv2"]["b"]))
    x = _pool(x)                                    # 7x7x16
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def n_params(params: dict) -> int:
    return sum(int(np.prod(p.shape)) for p in tree_leaves(params))


def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor,
            sample_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-entropy; per-sample weights implement eq. (4)'s alpha_i m_i."""
    logp = F.log_softmax(apply(params, images), dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    if sample_weights is None:
        return torch.mean(nll)
    return torch.sum(nll * sample_weights)


def accuracy(params: dict, images: torch.Tensor, labels: torch.Tensor,
             batch: int = 512) -> float:
    correct = 0
    for i in range(0, images.shape[0], batch):
        logits = apply(params, images[i:i + batch])
        correct += int(torch.sum(torch.argmax(logits, -1) == labels[i:i + batch]))
    return correct / images.shape[0]
