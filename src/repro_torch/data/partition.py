"""Non-IID data partitioning across FL clients (numpy only; the port's
copy of ``repro.data.partition``, byte-equal for the same seed).

Implements the Dirichlet label-skew recipe of Li et al. [16] used by the
paper: for every class c, draw p_c ~ Dir_N(beta) and split class-c samples
across the N clients proportionally.  beta=0.1 reproduces the paper's
"highly biased" scenario (most clients miss several labels), beta=0.3 the
"mildly biased" one.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.data.synthetic import Dataset


def dirichlet_partition(dataset: Dataset, n_clients: int, beta: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    """Returns per-client index arrays. Retries until every client has
    at least ``min_size`` samples (standard practice for small beta)."""
    rng = np.random.default_rng(seed)
    labels = dataset.labels
    n_classes = int(labels.max()) + 1
    for _ in range(100):
        idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, beta))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for client, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[client].extend(part.tolist())
        sizes = np.array([len(ix) for ix in idx_per_client])
        if sizes.min() >= min_size:
            return [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_per_client]
    raise RuntimeError("could not produce a partition with min_size per client")


def label_distribution(dataset: Dataset, parts: Sequence[np.ndarray]) -> np.ndarray:
    """[n_clients, n_classes] label histogram — used in tests/plots."""
    n_classes = int(dataset.labels.max()) + 1
    out = np.zeros((len(parts), n_classes))
    for i, ix in enumerate(parts):
        binc = np.bincount(dataset.labels[ix], minlength=n_classes)
        out[i] = binc
    return out


def heterogeneity_index(dist: np.ndarray) -> float:
    """Mean total-variation distance of client label dists from global —
    0 = iid, ->1 = one-class clients. Used to verify beta ordering."""
    global_p = dist.sum(0) / max(dist.sum(), 1)
    client_p = dist / np.maximum(dist.sum(1, keepdims=True), 1)
    return float(np.mean(np.abs(client_p - global_p).sum(1) / 2))
