"""Host half of the ClientBank data plane — a numpy copy of the parts of
``repro.data.pipeline`` the port uses (the port imports nothing of the JAX
package): bucketing, cyclic tiling into ``[N, B, ...]`` stacks, tier
assignment, input validation, the int8 codes of a bank's rows, the
k-means routing of hierarchical aggregation, client shards, the
train/test split and the shuffled batch iterators of the training
drivers (:func:`batch_iterator`, :func:`lm_batches`).  Same inputs, same
arrays.

Bucket invariants (see ``repro_torch.fl.client``):

* A client of ``n`` examples is bucketed to
  ``client_bucket_examples(n, bs) = next_pow2(ceil(n / bs)) * bs`` rows,
  so the bucket always holds ``>= n`` rows and the cyclic tiling
  (:func:`pad_client_data`) contains every example; the *applied*
  per-epoch step count stays ``max(n // bs, 1)``.
* :func:`bucket_examples` is the single GLOBAL bucket of a
  ``ClientBank``; :func:`assign_tiers` is the ladder of a
  ``TieredClientBank`` (one bucket per tier).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def bucket_num_batches(steps: int) -> int:
    """Round a per-epoch step count up to the next power of two."""
    return 1 << max(steps - 1, 0).bit_length()


def pad_client_data(x: np.ndarray, y: np.ndarray,
                    num_examples: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cyclically tile a client's (x, y) to exactly ``num_examples`` rows."""
    n = x.shape[0]
    if n == num_examples:
        return x, y
    idx = np.arange(num_examples) % n
    return x[idx], y[idx]


def client_bucket_examples(num_examples: int, batch_size: int) -> int:
    """One client's own power-of-two bucket: ``next_pow2(ceil(n/bs)) * bs``.

    Sized from the *ceil* step count so the bucket holds ``>= n`` rows and
    the cyclic tiling contains every example; the applied per-epoch step
    count stays the floor-based ``max(n // bs, 1)``.
    """
    steps = max(-(-int(num_examples) // batch_size), 1)
    return bucket_num_batches(steps) * batch_size


def bucket_examples(sizes: Sequence[int], batch_size: int) -> int:
    """Common bucketed example count B for a set of client dataset sizes.

    The max of the per-client buckets (:func:`client_bucket_examples`), so
    ``B >= max_i n_i`` — the cyclic tiling then contains every client's
    every example.  The *applied* per-epoch step count stays the
    floor-based ``max(n_i // bs, 1)`` (see :func:`stack_client_arrays`).
    """
    return max(client_bucket_examples(s, batch_size) for s in sizes)


def assign_tiers(sizes: Sequence[int], batch_size: int,
                 max_tiers: int = 4) -> Tuple[np.ndarray, List[int]]:
    """Group clients into a ladder of power-of-two bucket tiers.

    Each client starts in the tier of its own bucket
    (:func:`client_bucket_examples`); if that yields more than
    ``max_tiers`` distinct rungs, the ladder is merged greedily: the rung
    whose promotion into the next-larger rung adds the least total padding
    (``count * (B_next - B)``) is folded upward until at most ``max_tiers``
    rungs remain.  Merging only ever moves clients to a LARGER bucket, so
    every tier bucket still holds ``>= n_i`` rows for its members and the
    whole bucketing contract (cyclic tiling, floor-based applied steps,
    ``num_examples`` epoch masking) applies per tier unchanged.

    Returns ``(tier_of, tier_buckets)``: ``tier_of[i]`` is client i's tier
    index into the ascending ``tier_buckets`` list.  Deterministic; a
    uniform ladder (all clients sharing one bucket) collapses to a single
    tier, which consumers treat exactly like the single global bucket.
    """
    if max_tiers < 1:
        raise ValueError(f"max_tiers must be >= 1, got {max_tiers}")
    per = np.asarray([client_bucket_examples(s, batch_size) for s in sizes],
                     np.int64)
    buckets = sorted(set(int(b) for b in per))
    while len(buckets) > max_tiers:
        counts = [int(np.sum(per == b)) for b in buckets]
        costs = [counts[j] * (buckets[j + 1] - buckets[j])
                 for j in range(len(buckets) - 1)]
        j = int(np.argmin(costs))           # ties -> lowest rung (stable)
        per[per == buckets[j]] = buckets[j + 1]
        del buckets[j]
    tier_of = np.searchsorted(np.asarray(buckets), per).astype(np.int32)
    return tier_of, buckets


def validate_client_data(client_data: Sequence[Tuple[np.ndarray, np.ndarray]]
                         ) -> None:
    """Reject malformed client datasets with an error naming the client.

    Checked at bank construction, so a bad array fails with the client's
    index instead of deep inside :func:`stack_client_arrays`:

    * every client's ``x`` has a floating dtype (labels may be integral),
    * every client's ``x`` and ``y`` agree on the leading example count
      and hold at least one example,
    * dtypes and per-example feature shapes are identical across clients
      (the stacked ``[N, B, ...]`` form requires one shape/dtype).
    """
    if not len(client_data):
        raise ValueError("client_data is empty — a bank needs at least "
                         "one client")
    ref_x = ref_y = None
    for i, pair in enumerate(client_data):
        if len(pair) != 2:
            raise ValueError(f"client {i}: expected an (x, y) pair, got "
                             f"{len(pair)} elements")
        x, y = np.asarray(pair[0]), np.asarray(pair[1])
        if not np.issubdtype(x.dtype, np.floating):
            raise ValueError(
                f"client {i}: x dtype {x.dtype} is not a float dtype — "
                f"cast features to float32 before bank construction")
        if x.ndim < 1 or x.shape[0] < 1:
            raise ValueError(f"client {i}: needs at least one example, "
                             f"got x shape {x.shape}")
        if y.shape[:1] != x.shape[:1]:
            raise ValueError(
                f"client {i}: x has {x.shape[0]} examples but y has "
                f"shape {y.shape}")
        sig_x = (x.dtype, x.shape[1:])
        sig_y = (y.dtype, y.shape[1:])
        if ref_x is None:
            ref_x, ref_y = sig_x, sig_y
        elif sig_x != ref_x or sig_y != ref_y:
            raise ValueError(
                f"client {i}: dtype/feature-shape "
                f"(x {x.dtype} {x.shape[1:]}, y {y.dtype} {y.shape[1:]}) "
                f"does not match client 0's "
                f"(x {ref_x[0]} {ref_x[1]}, y {ref_y[0]} {ref_y[1]}) — "
                f"all clients must stack to one [N, B, ...] shape")


def quantize_stack(stack: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-client affine int8 quantization of a ``[N, B, ...]`` stack.

    Each client row (leading-axis slice) gets its own affine code over
    its value range: ``scale_i = (max_i - min_i) / 255`` (1.0 for a
    constant row) and a float zero offset, with codes stored int8.  The
    dequantization is ``x_hat = q.astype(f32) * scale + zero`` — exactly
    the elementwise graph the round engine's fused gather replays on
    device — and the QUANTIZATION ERROR CONTRACT is
    ``|x_hat - x| <= 0.5 * scale_i`` per element (half a code step; the
    f32 round-trip adds at most a few ulps on top).

    Returns ``(q int8 [N, B, ...], scale f32 [N], zero f32 [N])``.
    Deterministic — re-quantizing identical rows reproduces identical
    codes, which is what makes pool evict/re-admit round-trips exact.
    """
    stack = np.asarray(stack)
    n = stack.shape[0]
    flat = stack.reshape(n, -1).astype(np.float32)
    mn = flat.min(axis=1)
    mx = flat.max(axis=1)
    scale = (mx - mn) / np.float32(255.0)
    scale = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint((flat - mn[:, None]) / scale[:, None]),
                0, 255).astype(np.int16) - 128
    zero = (mn + np.float32(128.0) * scale).astype(np.float32)
    return (q.astype(np.int8).reshape(stack.shape), scale, zero)


def dequantize_stack(q: np.ndarray, scale: np.ndarray,
                     zero: np.ndarray) -> np.ndarray:
    """Host mirror of the in-gather dequantization: ``q * scale + zero``
    broadcast over each client row (f32)."""
    q = np.asarray(q)
    shape = (q.shape[0],) + (1,) * (q.ndim - 1)
    return (q.astype(np.float32) * scale.reshape(shape).astype(np.float32)
            + zero.reshape(shape).astype(np.float32))


def client_cluster_features(
        client_data: Sequence[Tuple[np.ndarray, np.ndarray]]
        ) -> np.ndarray:
    """Per-client summary features for hierarchical-aggregation k-means:
    mean and std of the flattened example features plus ``log1p(n_i)`` —
    host-side, O(sum_i n_i), computed once at bank construction (and per
    admit for the streaming pool)."""
    rows = []
    for x, _ in client_data:
        flat = np.asarray(x, np.float32).reshape(np.asarray(x).shape[0], -1)
        rows.append(np.concatenate([
            flat.mean(axis=0), flat.std(axis=0),
            [np.log1p(np.float32(flat.shape[0]))]]))
    return np.stack(rows).astype(np.float32)


def kmeans_clusters(features: np.ndarray, num_clusters: int,
                    iters: int = 25, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Plain deterministic Lloyd k-means on ``[N, D]`` features.

    Host-side numpy only (the cluster routing is control-plane data, like
    tier assignment).  Returns ``(labels int32 [N], centroids f32
    [num_clusters, D])``.  ``num_clusters`` is clamped to N; an emptied
    cluster is re-seeded to the point farthest from its centroid, so
    every cluster id stays populated.
    """
    feats = np.asarray(features, np.float32)
    n = feats.shape[0]
    k = max(1, min(int(num_clusters), n))
    rng = np.random.default_rng(seed)
    centroids = feats[rng.choice(n, size=k, replace=False)].copy()
    labels = np.zeros(n, np.int32)
    for _ in range(max(int(iters), 1)):
        d2 = ((feats[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=2)
        new_labels = d2.argmin(axis=1).astype(np.int32)
        for c in range(k):
            members = feats[new_labels == c]
            if members.size:
                centroids[c] = members.mean(axis=0)
            else:                    # re-seed an emptied cluster
                far = int(d2.min(axis=1).argmax())
                centroids[c] = feats[far]
                new_labels[far] = c
        if np.array_equal(new_labels, labels):
            labels = new_labels
            break
        labels = new_labels
    return labels, centroids


def assign_clusters(features: np.ndarray,
                    centroids: np.ndarray) -> np.ndarray:
    """Nearest-centroid assignment (the pool's admit-time routing —
    centroids are fitted once on the initial population and stay fixed,
    so an admitted client's cluster never depends on admission order)."""
    feats = np.atleast_2d(np.asarray(features, np.float32))
    d2 = ((feats[:, None, :] - centroids[None, :, :]) ** 2).sum(axis=2)
    return d2.argmin(axis=1).astype(np.int32)


def stack_client_arrays(client_data: Sequence[Tuple[np.ndarray, np.ndarray]],
                        batch_size: int
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Tile every client to ONE common bucket -> ``[N, B, ...]`` stacks.

    The host half of the ``ClientBank`` data plane
    (``repro_torch.fl.client_bank``): every client's (x, y) is cyclically
    tiled to the same bucket of ``B`` examples and stacked along a leading
    client axis.  Returns
    ``(xs, ys, num_steps, num_examples)`` where ``num_steps[i]`` is client
    i's true per-epoch optimizer step count ``max(n_i // bs, 1)`` and
    ``num_examples[i]`` its true dataset size (the masks that keep padded
    clients from over-training or sampling their duplicated rows).
    """
    sizes = [int(x.shape[0]) for x, _ in client_data]
    b = bucket_examples(sizes, batch_size)
    xs, ys = [], []
    for x, y in client_data:
        px, py = pad_client_data(np.asarray(x), np.asarray(y), b)
        xs.append(px)
        ys.append(py)
    num_steps = np.asarray([max(n // batch_size, 1) for n in sizes],
                           np.int32)
    return (np.stack(xs), np.stack(ys), num_steps,
            np.asarray(sizes, np.int32))


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int,
                   seed: int = 0, drop_remainder: bool = True
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled epochs of {x, y} batches."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        perm = rng.permutation(n)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for s in range(0, max(end, batch_size), batch_size):
            idx = perm[s:s + batch_size]
            if drop_remainder and len(idx) < batch_size:
                break
            yield {"x": x[idx], "y": y[idx]}


def make_client_datasets(x: np.ndarray, y: np.ndarray,
                         partitions: Sequence[np.ndarray]
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Materialise per-client (x, y) shards from partition index lists."""
    return [(x[idx], y[idx]) for idx in partitions]


def train_test_split(x: np.ndarray, y: np.ndarray, test_fraction: float = 0.1,
                     seed: int = 0):
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    perm = rng.permutation(n)
    cut = int(n * (1.0 - test_fraction))
    tr, te = perm[:cut], perm[cut:]
    return (x[tr], y[tr]), (x[te], y[te])


def lm_batches(tokens: np.ndarray, batch_size: int, seed: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Next-token-prediction batches: inputs = toks[:-1], labels = toks[1:]."""
    rng = np.random.default_rng(seed)
    n = tokens.shape[0]
    while True:
        perm = rng.permutation(n)
        for s in range(0, (n // batch_size) * batch_size, batch_size):
            idx = perm[s:s + batch_size]
            seq = tokens[idx]
            yield {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
