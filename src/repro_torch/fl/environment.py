"""FL edge environment: the seeded host channel process — the port of
``repro.fl.environment.ChannelProcess`` (numpy, so the same seed gives
bitwise the same gains as the JAX package).

* ``mode='iid'`` — the paper's stationary draw (Sec. VII-A): exponential
  gains with mean 0.1, restricted to [0.01, 0.5] by redrawing (a
  truncated exponential, no atoms at the boundaries).
* ``mode='markov'`` — a per-client two-state Gilbert-Elliott chain
  (good/bad) whose state picks the truncated exponential's mean; the
  host process keeps its state vector across :meth:`sample` calls.
* per-client dropout — :meth:`ChannelProcess.dropout_sequence`, a
  Bernoulli ``[T, N]`` alive mask from the same numpy stream, which
  ``RoundEngine.run_scan(drop_seq=)`` consumes.

The JAX package's device-side samplers (``sample_gains``,
``sample_gains_markov``, ``sample_dropout_mask``) are later work
(ROADMAP A5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Redraw budget for the truncated exponential: ~10% of raw draws fall
# outside [0.01, 0.5] at the paper's defaults, so P(no valid draw in 64)
# is negligible (~1e-64); the final clip only ever touches that case.
_REDRAWS = 64

CHANNEL_MODES = ("iid", "markov")


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    mean_gain: float = 0.1
    min_gain: float = 0.01
    max_gain: float = 0.5
    seed: int = 0
    #: 'iid' (the paper's stationary draw) or 'markov' (Gilbert-Elliott).
    mode: str = "iid"
    #: Bad-state mean gain (markov mode only).
    bad_gain: float = 0.02
    #: P(good -> bad) per round.
    p_gb: float = 0.0
    #: P(bad -> good) per round.
    p_bg: float = 0.0
    #: Per-client per-round dropout probability.
    dropout: float = 0.0

    def __post_init__(self):
        if self.mode not in CHANNEL_MODES:
            raise ValueError(f"unknown channel mode {self.mode!r} "
                             f"(known: {CHANNEL_MODES})")
        if not (0.0 <= self.p_gb <= 1.0 and 0.0 <= self.p_bg <= 1.0):
            raise ValueError("transition probabilities must lie in [0, 1]")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout rate must lie in [0, 1)")


def markov_stationary(p_gb: float, p_bg: float) -> float:
    """Stationary bad-state probability ``p_gb / (p_gb + p_bg)``; a chain
    that never moves (both zero) is defined all-good."""
    denom = np.float32(p_gb) + np.float32(p_bg)
    if denom > 0.0:
        return float(np.float32(p_gb) / max(denom, np.float32(1e-12)))
    return 0.0


class ChannelProcess:
    """Channel gains from a seeded host process (numpy).

    Redraws are vectorised: a ``[64, ...]`` block of candidates is drawn
    at once and each device takes its first in-range value.
    """

    def __init__(self, num_devices: int, cfg: ChannelConfig = ChannelConfig()):
        self.num_devices = num_devices
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._state: Optional[np.ndarray] = None  # markov state [N]

    def _first_in_range(self, draws: np.ndarray) -> np.ndarray:
        """[R, ...] candidate block -> first in-range value along axis 0."""
        cfg = self.cfg
        ok = (draws >= cfg.min_gain) & (draws <= cfg.max_gain)
        first = np.argmax(ok, axis=0)
        h = np.take_along_axis(draws, first[None], axis=0)[0]
        # argmax == 0 with ok[0] False means no draw landed in range: the
        # clip puts only those (measure ~exp(-64)) on the boundary
        return np.clip(h, cfg.min_gain, cfg.max_gain).astype(np.float32)

    # -- markov chain ------------------------------------------------------

    def _init_state(self) -> np.ndarray:
        pi_bad = markov_stationary(self.cfg.p_gb, self.cfg.p_bg)
        return (self._rng.uniform(size=self.num_devices) < pi_bad
                ).astype(np.int32)

    def _advance_state(self, s: np.ndarray) -> np.ndarray:
        u = self._rng.uniform(size=self.num_devices)
        return np.where(s == 0, (u < self.cfg.p_gb).astype(np.int32),
                        1 - (u < self.cfg.p_bg).astype(np.int32))

    def markov_state_sequence(self, num_rounds: int) -> np.ndarray:
        """[T, N] int32 state sequence, advancing the persistent chain."""
        if self._state is None:
            self._state = self._init_state()
        states = np.empty((num_rounds, self.num_devices), np.int32)
        for t in range(num_rounds):
            states[t] = self._state
            self._state = self._advance_state(self._state)
        return states

    # -- sampling ----------------------------------------------------------

    def sample(self) -> np.ndarray:
        if self.cfg.mode == "markov":
            return self.sample_sequence(1)[0]
        return self._first_in_range(self._rng.exponential(
            self.cfg.mean_gain, (_REDRAWS, self.num_devices)))

    def sample_sequence(self, num_rounds: int, max_block: int = 256
                        ) -> np.ndarray:
        """[T, N] gains for a whole rollout, vectorised (chunked at
        ``max_block`` rounds to bound the [64, T, N] candidate block)."""
        out = []
        for t0 in range(0, num_rounds, max_block):
            t = min(max_block, num_rounds - t0)
            if self.cfg.mode == "markov":
                states = self.markov_state_sequence(t)
                mean = np.where(states == 1, self.cfg.bad_gain,
                                self.cfg.mean_gain).astype(np.float32)
                draws = self._rng.exponential(
                    1.0, (_REDRAWS, t, self.num_devices)) * mean
            else:
                draws = self._rng.exponential(
                    self.cfg.mean_gain, (_REDRAWS, t, self.num_devices))
            out.append(self._first_in_range(draws))
        return np.concatenate(out) if out else np.zeros(
            (0, self.num_devices), np.float32)

    def dropout_sequence(self, num_rounds: int) -> np.ndarray:
        """[T, N] alive mask (1.0 = alive), each client dropping with
        probability ``cfg.dropout`` per round; draws from the process's
        numpy stream, so it advances the gains' stream too."""
        u = self._rng.uniform(size=(num_rounds, self.num_devices))
        return (u >= self.cfg.dropout).astype(np.float32)
