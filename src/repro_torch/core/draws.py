"""Counter-based random draws: splitmix64 in int64 tensor arithmetic.

``RoundEngine.run_scan`` draws two things per round: each slot's client
(an inverse-CDF draw from q, ``policy.sampled_selection``) and each
slot's ``[E, B]`` epoch-order keys.  The JAX package draws both from
threefry keys split per round and folded per slot; torch cannot
reproduce those streams, and ``torch.rand`` on a ``[K_max, ...]`` shape
gives other numbers on the CPU than on the card and other numbers for
slot i when K_max changes.  So every draw here is a pure function of
integers: a value is ``splitmix64`` of its key chain

    round key   = fold(fold(rollout_key, t), stream)
    slot draw   = fold(round_key, slot)
    epoch key   = fold(fold(fold(round_key, slot), epoch), row)

with ``fold(key, x) = splitmix64(key ^ splitmix64(x))``.  The chain is
computed with int64 tensor ops (wrapping multiplication, masked logical
shifts), which give the same bits on the CPU and on the card, and slot
i's values depend on (rollout key, t, i) only: prefix-stable in the slot
index by construction.  :func:`splitmix64_reference` is the same
function on Python integers, for the tests.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _signed(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = 0x9E3779B97F4A7C15
_MUL1 = 0xBF58476D1CE4E5B9
_MUL2 = 0x94D049BB133111EB
_S_GOLDEN, _S_MUL1, _S_MUL2 = map(_signed, (_GOLDEN, _MUL1, _MUL2))

#: streams of a round key (the JAX package splits its round key in
#: ``k_sel`` and ``k_cli``)
SELECT_STREAM, CLIENT_STREAM = 0, 1


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is
    arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finaliser on int64 tensors (bits as unsigned)."""
    z = x + _S_GOLDEN
    z = (z ^ _shr(z, 30)) * _S_MUL1
    z = (z ^ _shr(z, 27)) * _S_MUL2
    return z ^ _shr(z, 31)


def fold(key: torch.Tensor, x) -> torch.Tensor:
    """A new key from ``key`` and the integer(s) ``x`` (broadcast)."""
    x = torch.as_tensor(x, dtype=torch.int64, device=key.device)
    return splitmix64(key ^ splitmix64(x))


def round_key(rollout_key: torch.Tensor, t: int, stream: int
              ) -> torch.Tensor:
    """The key of round ``t``'s ``stream`` (:data:`SELECT_STREAM` or
    :data:`CLIENT_STREAM`)."""
    return fold(fold(rollout_key, t), stream)


def uniform_f64(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float64 in [0, 1) from the top 53 bits."""
    return _shr(bits, 11).to(torch.float64) * 2.0 ** -53


def uniform_f32(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from the top 24 bits."""
    return _shr(bits, 40).to(torch.float32) * 2.0 ** -24


def epoch_keys(key: torch.Tensor, slots: torch.Tensor, epochs: int,
               rows: int) -> torch.Tensor:
    """``[K, E, B]`` uniform epoch-order keys, slot i's from
    ``fold(key, i)`` only."""
    dev = key.device
    e = torch.arange(epochs, dtype=torch.int64, device=dev)
    b = torch.arange(rows, dtype=torch.int64, device=dev)
    per_slot = fold(key, slots.to(torch.int64))[:, None, None]
    return uniform_f32(fold(fold(per_slot, e[None, :, None]),
                            b[None, None, :]))


def splitmix64_reference(x: int) -> int:
    """:func:`splitmix64` on Python integers (unsigned 64-bit)."""
    z = (x + _GOLDEN) & _MASK64
    z = ((z ^ (z >> 30)) * _MUL1) & _MASK64
    z = ((z ^ (z >> 27)) * _MUL2) & _MASK64
    return z ^ (z >> 31)
