"""Non-IID data partitioning for FL (paper Sec. VII-A) — a numpy copy of
``repro.data.partition``: the same seed gives the same partition.

* ``dirichlet_partition`` — CIFAR-10 style: split indices across N devices by
  a Dirichlet(concentration) draw per class (Hsu et al. [40]); the paper uses
  concentration 0.5 over 120 devices.
* ``writer_partition``    — FEMNIST style: each device is a "writer" with its
  own label-usage profile and >= min_samples examples.
* ``partition_stats``     — sizes and label-skew summaries of a partition.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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



def writer_partition(labels: np.ndarray, num_devices: int,
                     samples_per_writer: Tuple[int, int] = (50, 400),
                     label_profile_size: int = 12, seed: int = 0
                     ) -> List[np.ndarray]:
    """FEMNIST-like: each device draws from its own small label subset.

    Mirrors the LEAF preprocessing the paper uses: writers with < 50 samples
    are filtered out (we draw sizes >= 50 directly) and each writer's data is
    concentrated on a personal subset of classes (handwriting style proxy).
    """
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    by_class = {c: np.flatnonzero(labels == c) for c in classes}
    out = []
    for _ in range(num_devices):
        profile = rng.choice(classes, size=min(label_profile_size,
                                               len(classes)), replace=False)
        size = int(rng.integers(samples_per_writer[0],
                                samples_per_writer[1] + 1))
        weights = rng.dirichlet(np.full(len(profile), 0.8))
        counts = rng.multinomial(size, weights)
        idx: List[int] = []
        for c, k in zip(profile, counts):
            pool = by_class[c]
            take = rng.choice(pool, size=min(k, len(pool)), replace=False)
            idx.extend(take.tolist())
        arr = np.asarray(idx, np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def partition_stats(parts: Sequence[np.ndarray], labels: np.ndarray) -> dict:
    """Summary statistics used by tests and benchmark logs."""
    sizes = np.asarray([len(p) for p in parts])
    classes = np.unique(labels)
    label_dists = np.stack([
        np.bincount(labels[p], minlength=classes.max() + 1) / max(len(p), 1)
        for p in parts])
    global_dist = np.bincount(labels, minlength=classes.max() + 1) / len(labels)
    tv = 0.5 * np.abs(label_dists - global_dist[None, :]).sum(axis=1)
    return dict(sizes=sizes, mean_tv_distance=float(tv.mean()),
                max_tv_distance=float(tv.max()))
