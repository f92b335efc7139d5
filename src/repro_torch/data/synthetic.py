"""Synthetic MNIST stand-in: procedural 28x28 digit renderings.

The port's copy of ``repro.data.synthetic`` (numpy only, kept here so the
port imports nothing of ``repro``): each digit 0-9 is rendered from a 5x7
seed glyph, upsampled to 28x28 with random translation, scale jitter,
stroke thickness variation and pixel noise.  The same seed gives
byte-equal arrays in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# 5x7 seed glyphs for digits 0-9 ('#' = ink).
_GLYPHS = [
    [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],  # 0
    ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],  # 1
    [" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"],  # 2
    [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],  # 3
    ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],  # 4
    ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],  # 5
    [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],  # 6
    ["#####", "    #", "   # ", "  #  ", "  #  ", " #   ", " #   "],  # 7
    [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],  # 8
    [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],  # 9
]

_GLYPH_ARRAYS = np.stack([
    np.array([[1.0 if c == "#" else 0.0 for c in row] for row in glyph])
    for glyph in _GLYPHS
])  # [10, 7, 5]


class Dataset(NamedTuple):
    images: np.ndarray   # [n, 28, 28, 1] float32 in [0, 1]
    labels: np.ndarray   # [n] int32


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    glyph = _GLYPH_ARRAYS[digit]
    # scale jitter: glyph occupies 14..22 pixels of height
    h = rng.integers(14, 23)
    w = max(8, int(h * 5 / 7 * rng.uniform(0.85, 1.15)))
    ys = np.clip((np.arange(h) * 7 / h).astype(int), 0, 6)
    xs = np.clip((np.arange(w) * 5 / w).astype(int), 0, 4)
    up = glyph[np.ix_(ys, xs)]
    # stroke thickness: occasional dilation
    if rng.random() < 0.5:
        pad = np.pad(up, 1)
        up = np.maximum(up, np.maximum.reduce([
            pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]])) * rng.uniform(0.75, 1.0)
    img = np.zeros((28, 28))
    oy = rng.integers(0, 28 - h + 1)
    ox = rng.integers(0, 28 - w + 1)
    img[oy:oy + h, ox:ox + w] = up
    # intensity jitter + additive noise
    img = img * rng.uniform(0.7, 1.0) + rng.normal(0, 0.08, (28, 28))
    return np.clip(img, 0.0, 1.0)


def make_dataset(n: int, seed: int = 0) -> Dataset:
    """n samples with uniform labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.stack([_render(int(lab), rng)
                       for lab in labels]).astype(np.float32)
    return Dataset(images=images[..., None], labels=labels)


def make_mnist_like(n_train: int = 12_000, n_test: int = 2_000,
                    seed: int = 0) -> tuple[Dataset, Dataset]:
    return make_dataset(n_train, seed), make_dataset(n_test, seed + 1)
