"""The port's lane-batched device channel samplers
(``repro_torch.fl.environment``) against the JAX package's
(``repro.fl.environment``).  The threefry streams cannot be reproduced,
so each statistic of both samplers is held to its exact value within a
stated sampling tolerance (5 standard errors, or 4 for the transition
rates): the truncated exponential's mean and clip bounds, the
Gilbert-Elliott chain's stationary bad share and transition rates, the
dropout rate.  Then the port's own stream contracts: lanes independent,
the dropout stream apart from the gains, rounds prefix-stable, the first
in-range candidate taken, the same bits on every call."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl.environment as jenv  # noqa: E402
import repro_torch.fl.environment as tenv  # noqa: E402

T, N = 200, 100
KEYS = torch.tensor([3, 11, 42], dtype=torch.int64)
LO, HI = 0.01, 0.5


def _trunc_exp_moments(mean, lo, hi):
    """Exact mean and standard deviation of Exp(mean) truncated to
    [lo, hi]."""
    from scipy import integrate

    z = math.exp(-lo / mean) - math.exp(-hi / mean)

    def pdf(x):
        return math.exp(-x / mean) / mean / z

    m1 = integrate.quad(lambda x: x * pdf(x), lo, hi)[0]
    m2 = integrate.quad(lambda x: x * x * pdf(x), lo, hi)[0]
    return m1, math.sqrt(m2 - m1 * m1)


@pytest.mark.parametrize("mean", [0.1, 0.05, 0.2])
def test_truncated_exponential_mean_and_clip_bounds(mean):
    pytest.importorskip("scipy")
    want, sd = _trunc_exp_moments(mean, LO, HI)
    tol = 5 * sd / math.sqrt(T * N)
    port = tenv.sample_gains(KEYS, T, N, mean, LO, HI)
    assert port.shape == (3, T, N) and port.dtype == torch.float32
    ref = np.asarray(jenv.sample_gains(jax.random.PRNGKey(0), T, N, mean,
                                       LO, HI))
    for s in range(3):
        assert abs(float(port[s].double().mean()) - want) < tol, s
    assert abs(float(ref.mean()) - want) < tol
    for h in (port.numpy(), ref):
        assert h.min() >= np.float32(LO) and h.max() <= np.float32(HI)


def test_no_in_range_draw_clips_candidate_zero_as_the_reference():
    """Bounds no candidate reaches: every gain is the clipped first
    candidate, in both packages."""
    port = tenv.sample_gains(KEYS, 4, 8, 1e-3, 0.49, 0.5)
    ref = np.asarray(jenv.sample_gains(jax.random.PRNGKey(1), 4, 8, 1e-3,
                                       0.49, 0.5))
    assert np.all(port.numpy() == np.float32(0.49))
    assert np.all(ref == np.float32(0.49))


def test_first_in_range_candidate_is_taken():
    """The kept gain is the first candidate inside the bounds: rebuild
    the candidate block from the stream and check it."""
    keys = KEYS[:1]
    h = tenv.sample_gains(keys, 2, 5, 0.1, LO, HI)[0]
    from repro_torch.core import draws

    stream = draws.fold(keys, 0)[0]
    for t in range(2):
        for n in range(5):
            r = torch.arange(tenv._REDRAWS)
            cand = tenv._unit_exponential(draws.fold(
                stream, (t * tenv._REDRAWS + r) * 5 + n)) * np.float32(0.1)
            ok = (cand >= LO) & (cand <= HI)
            assert bool(ok.any())
            assert float(cand[int(torch.nonzero(ok)[0])]) == float(h[t, n])


P_GB = torch.tensor([0.05, 0.2, 0.4])
P_BG = torch.tensor([0.3, 0.2, 0.1])


def _transition_rates(states):
    """(stationary bad share, P(good->bad), P(bad->good)) of [T, N]."""
    prev, nxt = states[:-1], states[1:]
    good, bad = prev == 0, prev == 1
    return (states.mean(), (nxt[good] == 1).mean(), (nxt[bad] == 0).mean(),
            good.sum(), bad.sum())


def test_markov_stationary_share_and_transition_rates():
    port = tenv.sample_markov_states(KEYS, T, N, P_GB, P_BG)
    assert port.shape == (3, T, N) and port.dtype == torch.int32
    for s in range(3):
        gb, bg = float(P_GB[s]), float(P_BG[s])
        ref = np.asarray(jenv.sample_markov_states(
            jax.random.PRNGKey(s), T, N, gb, bg))
        pi = gb / (gb + bg)
        # the share's standard error under the chain's correlation time
        corr = (2.0 - gb - bg) / (gb + bg)
        share_tol = 5 * math.sqrt(pi * (1 - pi) * corr / (T * N))
        for states in (port[s].numpy(), ref):
            share, r_gb, r_bg, n_good, n_bad = _transition_rates(states)
            assert abs(share - pi) < share_tol, (s, share, pi)
            assert abs(r_gb - gb) < 4 * math.sqrt(gb * (1 - gb) / n_good)
            assert abs(r_bg - bg) < 4 * math.sqrt(bg * (1 - bg) / n_bad)
    np.testing.assert_allclose(
        tenv.markov_stationary(P_GB, P_BG).numpy(),
        np.asarray(jenv.markov_stationary(jnp.asarray(P_GB.numpy()),
                                          jnp.asarray(P_BG.numpy()))),
        rtol=0, atol=0)
    assert tenv.markov_stationary(0.0, 0.0) == 0.0
    assert float(tenv.markov_stationary(torch.tensor(0.0),
                                        torch.tensor(0.0))) == 0.0


def test_markov_gains_follow_the_state_means():
    """A chain stuck bad (p_bg = 0, starting from its stationary all-bad
    state) draws from the bad mean; a good one from the good mean."""
    pytest.importorskip("scipy")
    h = tenv.sample_gains_markov(KEYS[:2], T, N, 0.1, 0.02, LO, HI,
                                 torch.tensor([0.0, 1.0]),
                                 torch.tensor([0.0, 0.0]))
    for s, mean in ((0, 0.1), (1, 0.02)):
        want, sd = _trunc_exp_moments(mean, LO, HI)
        assert abs(float(h[s].double().mean()) - want) < \
            5 * sd / math.sqrt(T * N), s
    ref = np.asarray(jenv.sample_gains_markov(
        jax.random.PRNGKey(0), T, N, 0.1, 0.02, LO, HI, 1.0, 0.0))
    want, sd = _trunc_exp_moments(0.02, LO, HI)
    assert abs(float(ref.mean()) - want) < 5 * sd / math.sqrt(T * N)


@pytest.mark.parametrize("rate", [0.0, 0.2, 0.5])
def test_dropout_rate(rate):
    port = tenv.sample_dropout_mask(KEYS, T, N, rate)
    ref = np.asarray(jenv.sample_dropout_mask(jax.random.PRNGKey(0), T, N,
                                              rate))
    tol = 5 * math.sqrt(max(rate * (1 - rate), 1e-12) / (T * N))
    for alive in list(port.numpy()) + [ref]:
        assert set(np.unique(alive)) <= {0.0, 1.0}
        assert abs((1.0 - alive.mean()) - rate) <= tol
    if rate == 0.0:
        assert np.all(port.numpy() == 1.0)


def test_lanes_are_independent_and_streams_separate():
    """A lane's draws depend on its key and parameters only: the same
    with or without other lanes beside it; its gains do not move when a
    dropout rate or a markov lane is added; its rounds are prefix-stable;
    the same key gives the same bits on every call."""
    mode = torch.tensor([0, 1, 0], dtype=torch.int32)
    cols = dict(mean_gain=torch.tensor([0.1, 0.1, 0.05]), bad_gain=0.02,
                min_gain=LO, max_gain=HI, p_gb=torch.tensor([0.0, 0.2, 0.0]),
                p_bg=torch.tensor([0.0, 0.3, 0.0]))
    h = tenv.sample_channel_sequence(KEYS, 12, 9, mode, **cols)
    for s in range(3):
        alone = tenv.sample_channel_sequence(
            KEYS[s:s + 1], 12, 9, mode[s:s + 1],
            **{k: v[s:s + 1] if isinstance(v, torch.Tensor) else v
               for k, v in cols.items()})
        assert torch.equal(alone[0], h[s]), s
    # iid lanes are bitwise sample_gains, whatever the other lanes' mode
    iid = tenv.sample_gains(KEYS, 12, 9, cols["mean_gain"], LO, HI)
    assert torch.equal(h[0], iid[0]) and torch.equal(h[2], iid[2])
    assert not torch.equal(h[1], iid[1])
    # prefix-stable in the rounds, repeatable
    assert torch.equal(tenv.sample_gains(KEYS, 5, 9, cols["mean_gain"], LO,
                                         HI), iid[:, :5])
    assert torch.equal(tenv.sample_gains(KEYS, 12, 9, cols["mean_gain"],
                                         LO, HI), iid)
    # the dropout stream is its own: masks move with the rate, gains not
    drop = tenv.sample_dropout_mask(KEYS, 12, 9,
                                    torch.tensor([0.0, 0.5, 0.3]))
    assert torch.all(drop[0] == 1.0)
    assert torch.equal(tenv.sample_gains(KEYS, 12, 9, cols["mean_gain"],
                                         LO, HI), iid)


def test_log_matches_numpy_log():
    """The samplers' own float64 logarithm (IEEE operations only, so the
    CPU and the card agree bit for bit) against ``numpy.log``, within 2
    ulp."""
    x = torch.cat([torch.rand(20000, dtype=torch.float64,
                              generator=torch.Generator().manual_seed(0)),
                   torch.tensor([1.0, 0.5, 2.0 ** -53, 0.7071067811865476],
                                dtype=torch.float64)])
    x = x.clamp(min=2.0 ** -53)
    got, want = tenv._log_unit(x).numpy(), np.log(x.numpy())
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)) \
        < 4.5e-16
    assert float(tenv._log_unit(torch.tensor([1.0], dtype=torch.float64))
                 ) == 0.0
