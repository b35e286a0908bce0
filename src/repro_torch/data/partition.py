"""Client partitioning utilities."""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    """Partition example indices into ``num_clients`` non-IID shards via the
    standard Dirichlet label-skew protocol.  Returns index arrays per client.
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    while True:
        idx_per_client: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for k, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[k].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            return [np.asarray(sorted(ix)) for ix in idx_per_client]


def heterogeneous_sizes(num_clients: int, total: int, seed: int = 0,
                        spread: float = 2.0) -> np.ndarray:
    """Random heterogeneous |D_k| summing ~to ``total`` (log-uniform spread)."""
    rng = np.random.default_rng(seed)
    w = np.exp(rng.uniform(0.0, spread, size=num_clients))
    sizes = np.maximum((w / w.sum() * total).astype(int), 8)
    return sizes
