"""Non-IID data partitioning for FL (paper Sec. VII-A) — a numpy copy of
``repro.data.partition``: the same seed gives the same partition.

* ``dirichlet_partition`` — CIFAR-10 style: split indices across N devices by
  a Dirichlet(concentration) draw per class (Hsu et al. [40]); the paper uses
  concentration 0.5 over 120 devices.
"""

from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_devices: int,
                        concentration: float = 0.5, seed: int = 0,
                        min_per_device: int = 8) -> List[np.ndarray]:
    """Return per-device index arrays with Dirichlet label skew."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    for _ in range(256):
        buckets: List[List[int]] = [[] for _ in range(num_devices)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            probs = rng.dirichlet(np.full(num_devices, concentration))
            cuts = (np.cumsum(probs) * len(idx)).astype(int)[:-1]
            for dev, part in enumerate(np.split(idx, cuts)):
                buckets[dev].extend(part.tolist())
        sizes = np.asarray([len(b) for b in buckets])
        if sizes.min() >= min_per_device:
            break
    out = []
    for b in buckets:
        arr = np.asarray(b, np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out

