"""Counter-based draws of the rollout, written anew in numpy uint64.

The arena keys every random choice of a round by integers alone
(splitmix64 chains), so the reference can draw the very numbers the
rollout drew from the lane's rollout key:

    fold(key, x)   = splitmix64(key ^ splitmix64(x))
    round key      = fold(fold(rollout_key, t), stream)   stream 0: select
                                                          stream 1: client
    slot draw      = fold(select_key, slot)               -> uniform float64
    epoch key      = fold(fold(fold(client_key, slot), epoch), row)
                                                          -> uniform float32

The rollout key of a lane is the first ``randint(0, 2**62)`` of
``torch.Generator().manual_seed(seed)`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

SELECT_STREAM, CLIENT_STREAM = 0, 1

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_MUL2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x) -> np.ndarray:
    """The splitmix64 finaliser on uint64 arrays (wrapping arithmetic)."""
    z = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = z + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * _MUL1
        z = (z ^ (z >> np.uint64(27))) * _MUL2
    return z ^ (z >> np.uint64(31))


def fold(key, x) -> np.ndarray:
    """A new key from ``key`` and the integer(s) ``x`` (broadcast)."""
    x = np.asarray(x).astype(np.int64).astype(np.uint64)
    return splitmix64(np.asarray(key, dtype=np.uint64) ^ splitmix64(x))


def rollout_key(seed: int) -> np.uint64:
    """The lane's rollout key: the generator's first draw, as uint64."""
    key = int(torch.randint(0, 2 ** 62, (),
                            generator=torch.Generator().manual_seed(
                                int(seed))))
    return np.uint64(key)


def round_key(key, t: int, stream: int) -> np.ndarray:
    return fold(fold(key, t), stream)


def uniform_f64(bits) -> np.ndarray:
    """Uniform float64 in [0, 1) from the top 53 bits."""
    return (np.asarray(bits, np.uint64) >> np.uint64(11)).astype(
        np.float64) * 2.0 ** -53


def uniform_f32(bits) -> np.ndarray:
    """Uniform float32 in [0, 1) from the top 24 bits."""
    return ((np.asarray(bits, np.uint64) >> np.uint64(40)).astype(
        np.float32) * np.float32(2.0 ** -24)).astype(np.float32)


def slot_uniforms(key, t: int, slots: int) -> np.ndarray:
    """``[slots]`` float64 uniforms of round ``t``'s selection draws."""
    return uniform_f64(fold(round_key(key, t, SELECT_STREAM),
                            np.arange(slots)))


def epoch_order_keys(key, t: int, slot: int, epochs: int, rows: int
                     ) -> np.ndarray:
    """``[epochs, rows]`` float32 order keys of one slot in round ``t``."""
    per_slot = fold(round_key(key, t, CLIENT_STREAM), slot)
    e = np.arange(epochs)[:, None]
    b = np.arange(rows)[None, :]
    return uniform_f32(fold(fold(per_slot, e), b))
