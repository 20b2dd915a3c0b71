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
* system heterogeneity — :func:`heterogeneous_params`, log-uniform
  per-device multipliers on ``f_max``/``f_min``, the cycles per sample
  and the energy budget (:class:`HeterogeneityConfig`), drawn from the
  same numpy stream as the JAX package's and applied in f32 on the
  ``SystemParams``' own device: bitwise the reference's fields.

Device samplers (the scenario arena's channels): :func:`sample_gains`,
:func:`sample_markov_states`, :func:`sample_gains_markov`,
:func:`sample_channel_sequence` and :func:`sample_dropout_mask` draw
every lane of a grid at once from ``[S]`` parameter columns and ``[S]``
int64 channel keys.  Their bits are ``core.draws``' counter-based
splitmix64 streams, and the exponential's logarithm is computed from
IEEE additions, multiplications and one division in float64
(:func:`_log_unit`), so the same keys give the same gains and masks on
the CPU and on the card.  The JAX package's threefry streams cannot be
reproduced: these samplers are held to it statistically.  Layout of the
streams of channel key ``c``:

* stationary gains — ``fold(c, 0)``, one value per (round, redraw,
  client): counter ``(t * _REDRAWS + r) * N + n``, so a lane's first
  rounds do not depend on T;
* Gilbert-Elliott chain — ``fold(c, 1)`` (the markov fold): states from
  ``fold(fold(c, 1), 0)`` (the initial state's uniforms under counter
  ``n``, the transitions' under ``fold(., 1)`` and ``t * N + n``), gains
  from ``fold(fold(c, 1), 1)`` with the stationary counter;
* dropout — ``fold(c, 2)``, counter ``t * N + n``.

So a lane's gains never depend on its dropout rate or on the other
lanes, and the dropout axis draws from a stream of its own.

:meth:`ChannelProcess.sample_device` and :meth:`ChannelProcess.
dropout_device` (the JAX package's ``sample_jax`` / ``dropout_jax``)
draw a process's gains and alive mask on the device from one channel
key through these samplers, bitwise the arena's pregenerated lane for
the same key and statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import draws
from repro_torch.core import system_model as sm

# Redraw budget for the truncated exponential: ~10% of raw draws fall
# outside [0.01, 0.5] at the paper's defaults, so P(no valid draw in 64)
# is negligible (~1e-64); the final clip only ever touches that case.
_REDRAWS = 64

CHANNEL_MODES = ("iid", "markov")
CHANNEL_MODE_IDS = {name: i for i, name in enumerate(CHANNEL_MODES)}

# streams of a channel key (see the module docstring); the stationary
# gains' is 0, the others fold the JAX package's constants
_GAIN_FOLD = 0
_MARKOV_FOLD = 1
_DROPOUT_FOLD = 2
# rounds drawn per block: bounds the [S, _REDRAWS, rounds, N] candidate
# block (the counters are global, so blocking does not change a value)
_ROUND_BLOCK = 256
_LN2 = math.log(2.0)
# terms of the atanh series of the logarithm: |s| <= 0.172 on the
# reduced mantissa, so 12 terms leave under 1e-18 relative
_LOG_TERMS = 12


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


def markov_stationary(p_gb, p_bg):
    """Stationary bad-state probability ``p_gb / (p_gb + p_bg)`` in
    float32; a chain that never moves (both zero) is defined all-good.
    Numbers give a float, tensors (the arena's ``[S]`` columns) a
    tensor."""
    if isinstance(p_gb, torch.Tensor) or isinstance(p_bg, torch.Tensor):
        gb = torch.as_tensor(p_gb, dtype=torch.float32)
        bg = torch.as_tensor(p_bg, dtype=torch.float32, device=gb.device)
        denom = gb + bg
        return torch.where(denom > 0.0, gb / torch.clamp(denom, min=1e-12),
                           0.0)
    denom = np.float32(p_gb) + np.float32(p_bg)
    if denom > 0.0:
        return float(np.float32(p_gb) / max(denom, np.float32(1e-12)))
    return 0.0


# -- device samplers (lane-batched) ------------------------------------------

def _log_unit(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` for float64 ``x`` in (0, 1], from IEEE operations only
    (``frexp``, add, multiply, one divide; each rounded once), so the CPU
    and the card give the same bits: ``x = m 2^e`` with m moved into
    [sqrt(1/2), sqrt(2)), then ``log m = 2 atanh(s)``, ``s = (m - 1) /
    (m + 1)``, as an odd series in Horner form."""
    m, e = torch.frexp(x)
    low = m < math.sqrt(0.5)
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(torch.float64)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    poly = torch.full_like(s, 1.0 / (2 * _LOG_TERMS + 1))
    for j in range(_LOG_TERMS - 1, -1, -1):
        poly = poly * s2 + 1.0 / (2 * j + 1)
    return e * _LN2 + (s * 2.0) * poly


def _unit_exponential(bits: torch.Tensor) -> torch.Tensor:
    """Exponential(1) float32 draws from int64 bits: ``-log(u)`` with u
    the top 53 bits as a float64 in (0, 1]."""
    u = (draws._shr(bits, 11) + 1).to(torch.float64) * 2.0 ** -53
    return (-_log_unit(u)).to(torch.float32)


def _col(v, keys: torch.Tensor) -> torch.Tensor:
    """A per-lane parameter as a float32 ``[S, 1, 1]`` column on the
    keys' device (numbers broadcast to every lane)."""
    return torch.as_tensor(v, dtype=torch.float32, device=keys.device
                           ).expand(keys.shape[0]).reshape(-1, 1, 1)


def _first_in_range(keys: torch.Tensor, num_rounds: int, num_devices: int,
                    mean: torch.Tensor, min_gain, max_gain) -> torch.Tensor:
    """The truncated-exponential redraw scheme, ``[S, T, N]`` float32:
    for every (round, client) a block of ``_REDRAWS`` candidates
    ``Exp(1) * mean`` (``mean`` ``[S, 1, 1]`` or ``[S, T, N]``), the first
    in ``[min_gain, max_gain]`` taken (an integer minimum over the redraw
    index), and only the no-valid-draw case (measure ~exp(-64)) clipped to
    the boundary from candidate 0, as the reference's argmax does."""
    dev = keys.device
    lo, hi = _col(min_gain, keys)[..., None], _col(max_gain, keys)[..., None]
    n = torch.arange(num_devices, dtype=torch.int64, device=dev)
    r = torch.arange(_REDRAWS, dtype=torch.int64, device=dev)
    out = []
    for t0 in range(0, num_rounds, _ROUND_BLOCK):
        t = torch.arange(t0, min(t0 + _ROUND_BLOCK, num_rounds),
                         dtype=torch.int64, device=dev)
        counter = ((t[None, :, None] * _REDRAWS + r[:, None, None])
                   * num_devices + n[None, None, :])        # [R, Tb, N]
        bits = draws.fold(keys[:, None, None, None], counter[None])
        m = mean if mean.shape[1] == 1 else mean[:, t0:t0 + t.shape[0]]
        cand = _unit_exponential(bits) * m[:, None]       # [S, R, Tb, N]
        ok = (cand >= lo) & (cand <= hi)
        first = torch.where(ok, r[None, :, None, None], _REDRAWS).amin(1)
        first = torch.where(first == _REDRAWS, 0, first)
        h = torch.gather(cand, 1, first[:, None])[:, 0]
        out.append(torch.minimum(torch.maximum(h, lo[:, 0]), hi[:, 0]))
    if not out:
        return torch.zeros((keys.shape[0], 0, num_devices),
                           dtype=torch.float32, device=dev)
    return torch.cat(out, dim=1)


def sample_gains(keys: torch.Tensor, num_rounds: int, num_devices: int,
                 mean_gain, min_gain, max_gain) -> torch.Tensor:
    """Stationary truncated-exponential gains ``[S, T, N]`` float32, lane
    s from channel key ``keys[s]`` (int64 ``[S]``) with its own
    (``mean_gain``, ``min_gain``, ``max_gain``) (``[S]`` tensors or
    numbers)."""
    return _first_in_range(draws.fold(keys, _GAIN_FOLD), num_rounds,
                           num_devices, _col(mean_gain, keys), min_gain,
                           max_gain)


def sample_markov_states(keys: torch.Tensor, num_rounds: int,
                         num_devices: int, p_gb, p_bg) -> torch.Tensor:
    """Per-client Gilbert-Elliott states ``[S, T, N]`` int32 (0 good, 1
    bad) from state keys ``keys`` ``[S]``: the initial state drawn from
    the stationary distribution, then per round ``good -> bad`` with
    ``p_gb`` and ``bad -> good`` with ``p_bg``."""
    dev = keys.device
    gb, bg = _col(p_gb, keys)[:, :, 0], _col(p_bg, keys)[:, :, 0]
    n = torch.arange(num_devices, dtype=torch.int64, device=dev)
    t = torch.arange(num_rounds, dtype=torch.int64, device=dev)
    u0 = draws.uniform_f32(draws.fold(draws.fold(keys, 0)[:, None], n))
    u = draws.uniform_f32(draws.fold(
        draws.fold(keys, 1)[:, None, None],
        t[None, :, None] * num_devices + n[None, None, :]))
    s = (u0 < markov_stationary(gb, bg)).to(torch.int32)
    states = []
    for step in range(num_rounds):
        states.append(s)
        u_t = u[:, step]
        s = torch.where(s == 0, (u_t < gb).to(torch.int32),
                        1 - (u_t < bg).to(torch.int32))
    if not states:
        return torch.zeros((keys.shape[0], 0, num_devices),
                           dtype=torch.int32, device=dev)
    return torch.stack(states, dim=1)


def sample_gains_markov(keys: torch.Tensor, num_rounds: int,
                        num_devices: int, mean_gain, bad_gain, min_gain,
                        max_gain, p_gb, p_bg) -> torch.Tensor:
    """Gilbert-Elliott gains ``[S, T, N]``: each lane's state chain picks
    the truncated exponential's mean (``mean_gain`` good, ``bad_gain``
    bad), drawn from the markov fold of the channel keys."""
    k = draws.fold(keys, _MARKOV_FOLD)
    states = sample_markov_states(draws.fold(k, 0), num_rounds,
                                  num_devices, p_gb, p_bg)
    mean = torch.where(states == 1, _col(bad_gain, keys),
                       _col(mean_gain, keys))
    return _first_in_range(draws.fold(k, 1), num_rounds, num_devices, mean,
                           min_gain, max_gain)


def sample_channel_sequence(keys: torch.Tensor, num_rounds: int,
                            num_devices: int, mode, mean_gain, bad_gain,
                            min_gain, max_gain, p_gb, p_bg) -> torch.Tensor:
    """Gains ``[S, T, N]`` of lanes of either mode (``mode`` ``[S]`` ids of
    :data:`CHANNEL_MODES`): both are drawn and an exact ``where`` keeps
    each lane's, so an ``'iid'`` lane is bitwise :func:`sample_gains`."""
    stat = sample_gains(keys, num_rounds, num_devices, mean_gain, min_gain,
                        max_gain)
    mark = sample_gains_markov(keys, num_rounds, num_devices, mean_gain,
                               bad_gain, min_gain, max_gain, p_gb, p_bg)
    mode = torch.as_tensor(mode, dtype=torch.int32, device=keys.device
                           ).expand(keys.shape[0]).reshape(-1, 1, 1)
    return torch.where(mode == CHANNEL_MODE_IDS["markov"], mark, stat)


def sample_dropout_mask(keys: torch.Tensor, num_rounds: int,
                        num_devices: int, rate) -> torch.Tensor:
    """Per-client alive masks ``[S, T, N]`` float32 (1.0 = alive):
    Bernoulli(1 - rate) per (round, client) from the dropout fold of the
    channel keys, so a lane's gains never see it."""
    dev = keys.device
    n = torch.arange(num_devices, dtype=torch.int64, device=dev)
    t = torch.arange(num_rounds, dtype=torch.int64, device=dev)
    u = draws.uniform_f32(draws.fold(
        draws.fold(keys, _DROPOUT_FOLD)[:, None, None],
        t[None, :, None] * num_devices + n[None, None, :]))
    return (u >= _col(rate, keys)).to(torch.float32)


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

    def sample_device(self, key: torch.Tensor,
                      num_rounds: Optional[int] = None) -> torch.Tensor:
        """Gains drawn on ``key``'s device — ``[T, N]`` float32 (``[N]``
        when ``num_rounds`` is None) — keyed by ``key`` (an int64 channel
        key), not the process's numpy seed.  Delegates to the lane
        samplers at one lane: the stationary mode draws the key's gain
        stream, the Markov mode the key's Gilbert-Elliott fold, exactly
        as ``sim.Arena.sample_channels`` draws a lane with this key and
        these statistics (bitwise)."""
        keys = torch.as_tensor(key, dtype=torch.int64).reshape(1)
        t = 1 if num_rounds is None else int(num_rounds)
        cfg = self.cfg
        if cfg.mode == "markov":
            h = sample_gains_markov(keys, t, self.num_devices, cfg.mean_gain,
                                    cfg.bad_gain, cfg.min_gain, cfg.max_gain,
                                    cfg.p_gb, cfg.p_bg)[0]
        else:
            h = sample_gains(keys, t, self.num_devices, cfg.mean_gain,
                             cfg.min_gain, cfg.max_gain)[0]
        return h[0] if num_rounds is None else h

    def dropout_device(self, key: torch.Tensor, num_rounds: int
                       ) -> torch.Tensor:
        """``[T, N]`` float32 alive mask drawn on ``key``'s device from
        the dropout stream of the SAME key the gains consume (bitwise
        ``sim.Arena.sample_dropout``'s lane for this key and rate)."""
        keys = torch.as_tensor(key, dtype=torch.int64).reshape(1)
        return sample_dropout_mask(keys, int(num_rounds), self.num_devices,
                                   self.cfg.dropout)[0]

    def dropout_sequence(self, num_rounds: int) -> np.ndarray:
        """[T, N] alive mask (1.0 = alive), each client dropping with
        probability ``cfg.dropout`` per round; draws from the process's
        numpy stream, so it advances the gains' stream too."""
        u = self._rng.uniform(size=(num_rounds, self.num_devices))
        return (u >= self.cfg.dropout).astype(np.float32)

    def stream(self) -> Iterator[np.ndarray]:
        while True:
            yield self.sample()


@dataclasses.dataclass(frozen=True)
class HeterogeneityConfig:
    """System heterogeneity: per-device multipliers, log-uniform spread."""
    cpu_speed_spread: float = 1.0    # f_max multiplier range [1/s, s]
    cycles_spread: float = 1.0       # c_n multiplier range
    budget_spread: float = 1.0       # Ebar multiplier range
    seed: int = 0


def heterogeneous_params(base: sm.SystemParams,
                         het: HeterogeneityConfig) -> sm.SystemParams:
    """Apply log-uniform heterogeneity multipliers to a parameter set.

    The multipliers are the JAX package's numpy draws, in its order (f,
    cycles, budget); each product of two f32 values is correctly rounded
    on any device, so every field is bitwise the reference's.  The result
    lives on ``base.device``."""
    rng = np.random.default_rng(het.seed)
    n = base.num_devices

    def mult(spread: float) -> torch.Tensor:
        if spread <= 1.0:
            m = np.ones((n,), np.float32)
        else:
            lo, hi = -np.log(spread), np.log(spread)
            m = np.exp(rng.uniform(lo, hi, n)).astype(np.float32)
        return torch.as_tensor(m, device=base.device)

    f_mult = mult(het.cpu_speed_spread)
    f_max = base.f_max * f_mult
    return dataclasses.replace(
        base, f_max=f_max,
        f_min=torch.minimum(base.f_min * f_mult, f_max),
        cycles_per_sample=base.cycles_per_sample * mult(het.cycles_spread),
        energy_budget=base.energy_budget * mult(het.budget_spread))
