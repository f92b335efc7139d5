"""Synthetic language-modeling corpus for the big-architecture FL driver,
as ``repro.data.lm`` (numpy only, kept here so the port imports nothing of
``repro``; the same seed and calls give byte-equal arrays in both).

Sequences are generated by per-client affine recurrences over the vocab
(token_{t+1} = (a_c * token_t + b_c) mod V with occasional resets and
noise), giving (i) genuinely learnable structure (a transformer quickly
drops below the uniform-entropy loss) and (ii) *client-specific* patterns
(a_c, b_c differ per client) so partial participation has the same
non-iid flavour as the paper's label-skewed MNIST.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMData:
    def __init__(self, n_clients: int, vocab: int, seed: int = 0,
                 noise: float = 0.05):
        rng = np.random.default_rng(seed)
        self.n_clients = n_clients
        self.vocab = vocab
        self.noise = noise
        # client-specific recurrence params (odd multiplier => full cycle)
        self.mult = rng.integers(1, vocab // 2, n_clients) * 2 + 1
        self.add = rng.integers(0, vocab, n_clients)
        self._rng = rng

    def sample(self, client_ids: np.ndarray, seq_len: int) -> np.ndarray:
        """tokens [len(client_ids), seq_len + 1] (inputs + next-token labels)."""
        b = len(client_ids)
        out = np.empty((b, seq_len + 1), np.int64)
        out[:, 0] = self._rng.integers(0, self.vocab, b)
        mult = self.mult[client_ids]
        add = self.add[client_ids]
        for t in range(seq_len):
            nxt = (mult * out[:, t] + add) % self.vocab
            flip = self._rng.random(b) < self.noise
            nxt[flip] = self._rng.integers(0, self.vocab, flip.sum())
            out[:, t + 1] = nxt
        return out

    def batch(self, client_ids: np.ndarray, seq_len: int) -> dict:
        toks = self.sample(client_ids, seq_len)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
