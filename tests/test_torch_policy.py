"""The port's controller zoo against the JAX package on the same numpy
inputs: the seven decide rules (``k=None`` and K as data), Uni-S's
energy-balance frequency, the three selection modes, the id dispatch,
the K-as-data system model, solver objectives, queue diagnostics and the
convergence bound, at N = 16 (``conftest.make_params``), rtol 1e-5.  Also
the port's own counter-based draws (``core.draws``): bitwise its Python
reference, prefix-stable in the slot index, and distributed as q."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
from repro.core import convergence as jconv  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from conftest import make_params  # noqa: E402
from repro_torch.convert import system_params_from_numpy  # noqa: E402
from repro_torch.core import convergence as tconv  # noqa: E402
from repro_torch.core import draws  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402

RTOL = 1e-5
N = 16


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(
        np.asarray(got.cpu() if hasattr(got, "cpu") else got),
        np.asarray(want), rtol=rtol, atol=atol)


def _inputs(seed):
    """SystemParams (both packages), gains, positive queues, V, lam."""
    sp = make_params(N, seed=seed)
    tp = system_params_from_numpy(sp, device="cpu")
    rng = np.random.default_rng(seed + 100)
    h = np.clip(rng.exponential(0.1, N), 0.01, 0.5).astype(np.float32)
    queues = rng.uniform(0.0, 300.0, N).astype(np.float32)
    queues[::7] = 0.0            # no energy pressure on some devices
    hp = jc.estimate_hyperparams(sp, 0.1, loss_scale=1.5)
    return sp, tp, h, queues, hp.V, hp.lam


def _k_args(k_as_data, k):
    """(jax k, torch k): None, or K as an [N] float32 vector."""
    if not k_as_data:
        return None, None
    kv = np.full(N, float(k), np.float32)
    return jnp.asarray(kv), torch.as_tensor(kv)


@pytest.mark.parametrize("k_as_data", [False, True])
@pytest.mark.parametrize("policy", jpol.POLICIES)
def test_decide_rule_matches_reference(policy, k_as_data):
    sp, tp, h, queues, V, lam = _inputs(seed=jpol.POLICY_IDS[policy])
    # K as data differs from sp.sample_count, so the data is what is read
    jk, tk = _k_args(k_as_data, sp.sample_count + 3)
    fn_j = jpol.DECIDE_FNS[jpol.POLICY_IDS[policy]]
    fn_t = tpol.DECIDE_FNS[tpol.POLICY_IDS[policy]]
    want = fn_j(sp, jnp.asarray(h), jnp.asarray(queues), V, lam, k=jk)
    got = fn_t(tp, torch.as_tensor(h), torch.as_tensor(queues), V, lam,
               k=tk)
    for name, g, w in zip(("f", "p", "q"), got, want):
        assert g.shape == (N,), name
        _close(g, w)
    assert abs(float(got.q.sum()) - 1.0) <= 1e-5
    if policy == "channel_aware":
        k_eff = sp.sample_count + 3 if k_as_data else sp.sample_count
        assert int((got.q > 0).sum()) == k_eff and float(got.q.min()) == 0.0


def test_policy_tables_match_reference():
    assert tpol.POLICIES == jpol.POLICIES
    assert tpol.POLICY_IDS == jpol.POLICY_IDS
    assert tpol.SELECTION_MODES == jpol.SELECTION_MODES
    assert [f.__name__ for f in tpol.DECIDE_FNS] == \
        [f.__name__ for f in jpol.DECIDE_FNS]
    assert [f.__name__ for f in tpol.SELECT_FNS] == \
        [f.__name__ for f in jpol.SELECT_FNS]


@pytest.mark.parametrize("k_as_data", [False, True])
def test_static_frequency_matches_reference(k_as_data):
    sp, tp, h, _, _, _ = _inputs(seed=4)
    jk, tk = _k_args(k_as_data, 5)
    rng = np.random.default_rng(3)
    for p in (np.full(N, 0.0505, np.float32),
              rng.uniform(1e-3, 0.1, N).astype(np.float32)):
        want = jpol.static_frequency(sp, jnp.asarray(h), jnp.asarray(p),
                                     k=jk)
        got = tpol.static_frequency(tp, torch.as_tensor(h),
                                    torch.as_tensor(p), k=tk)
        _close(got, want)
    # a budget the balance cannot meet in the box clips to f_min / f_max
    for budget in (1e-3, 1e4):
        spb = dataclasses.replace(sp, energy_budget=np.full(
            N, budget, np.float32))
        tpb = system_params_from_numpy(spb, device="cpu")
        p = np.full(N, 0.0505, np.float32)
        _close(tpol.static_frequency(tpb, torch.as_tensor(h),
                                     torch.as_tensor(p)),
               jpol.static_frequency(spb, jnp.asarray(h), jnp.asarray(p)))


def test_round_robin_selection_matches_reference():
    sp, tp, h, queues, _, _ = _inputs(seed=5)
    q = np.full(N, 1.0 / N, np.float32)
    for k in (1, 3, 5, 16, 20):
        kv = np.full(N, float(k), np.float32)
        for t in (0, 1, 7, 1000):
            want = jpol.round_robin_selection(
                sp, jnp.int32(t), jnp.asarray(h), jnp.asarray(queues),
                jnp.asarray(q), None, jnp.arange(k), jnp.asarray(kv))
            got = tpol.round_robin_selection(
                tp, t, torch.as_tensor(h), torch.as_tensor(queues),
                torch.as_tensor(q), None, torch.arange(k),
                torch.as_tensor(kv))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_facility_location_matches_reference_and_host_greedy(seed):
    """On the reference's own feature gram, the device greedy, the JAX
    greedy and the host greedy pick the same clients; the port's gram
    is bitwise the reference's.  (With one reduction kernel
    for the gains, torch's sum order differed from XLA's and numpy's:
    at seed 2, step 10 of 16, two gains 7.5e-9 apart in float64 tie in
    float32, and torch picked client 15 where the others pick 0.  The
    gains are now summed in numpy's order.)"""
    sp, tp, h, _, _, _ = _inputs(seed=seed)
    sim_j = np.asarray(jpol.divfl_similarity(jpol.divfl_features(
        sp, jnp.asarray(h))))
    sim_t = tpol.divfl_similarity(tpol.divfl_features(tp,
                                                      torch.as_tensor(h)))
    np.testing.assert_array_equal(sim_t.numpy(), sim_j)
    for k in (1, 4, N, N + 2):
        want = np.asarray(jpol.facility_location_select(jnp.asarray(sim_j),
                                                        k))
        got = tpol.facility_location_select(torch.tensor(sim_j), k)
        np.testing.assert_array_equal(got.numpy(), want)
        if k <= N:
            np.testing.assert_array_equal(
                tc.facility_location_greedy(sim_j, k), want)
            np.testing.assert_array_equal(
                tc.facility_location_greedy(sim_t.numpy(), k),
                tpol.facility_location_select(sim_t, k).numpy())
    # a gradient-sketch gram, as the host controller's update path builds
    g = np.random.default_rng(seed).normal(size=(N, 5)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    gram = g @ g.T
    np.testing.assert_array_equal(
        tpol.facility_location_select(torch.as_tensor(gram), 6).numpy(),
        np.asarray(jpol.facility_location_select(jnp.asarray(gram), 6)))


def test_selections_are_prefix_stable_in_the_slot_index():
    """Slot i's pick never reads K_max: the greedy, the sampled draw and
    the epoch keys of a padded slot count start with the unpadded
    ones."""
    _, tp, h, queues, V, lam = _inputs(seed=6)
    th, tq = torch.as_tensor(h), torch.as_tensor(queues)
    sim = tpol.divfl_similarity(tpol.divfl_features(tp, th))
    q = tpol.decide_lroa(tp, th, tq, V, lam).q
    key = draws.round_key(torch.tensor(12345), 3, draws.SELECT_STREAM)
    kv = torch.full((N,), 4.0)
    for k in (1, 4, 7):
        np.testing.assert_array_equal(
            tpol.facility_location_select(sim, k + 3)[:k].numpy(),
            tpol.facility_location_select(sim, k).numpy())
        for mode in tpol.SELECT_FNS:
            small = mode(tp, 3, th, tq, q, key, torch.arange(k), kv)
            big = mode(tp, 3, th, tq, q, key, torch.arange(k + 3), kv)
            np.testing.assert_array_equal(big[:k].numpy(), small.numpy())
        np.testing.assert_array_equal(
            draws.epoch_keys(key, torch.arange(k + 3), 2, 9)[:k].numpy(),
            draws.epoch_keys(key, torch.arange(k), 2, 9).numpy())


def test_counter_draws_are_bitwise_their_python_reference():
    xs = [0, 1, 2, 3, 12345, 2 ** 31, 2 ** 40 + 7, 2 ** 62 - 1,
          (1 << 63) - 1]
    got = draws.splitmix64(torch.tensor(xs, dtype=torch.int64))
    want = [draws.splitmix64_reference(x) for x in xs]
    assert [int(v) & ((1 << 64) - 1) for v in got] == want
    key = torch.tensor(987654321, dtype=torch.int64)
    k_sel = draws.round_key(key, 5, draws.SELECT_STREAM)
    k_cli = draws.round_key(key, 5, draws.CLIENT_STREAM)
    assert int(k_sel) != int(k_cli)
    u = draws.uniform_f64(draws.fold(k_sel, torch.arange(1000)))
    assert u.dtype == torch.float64 and 0.0 <= float(u.min()) < 0.01
    assert 0.99 < float(u.max()) < 1.0
    keys = draws.epoch_keys(k_cli, torch.arange(4), 2, 300)
    assert keys.shape == (4, 2, 300) and keys.dtype == torch.float32
    assert 0.0 <= float(keys.min()) and float(keys.max()) < 1.0
    # the slot draw is the Python chain fold(key, i) = sm(key ^ sm(i))
    mask = (1 << 64) - 1
    k = int(k_sel) & mask
    for i in (0, 1, 999):
        bits = draws.splitmix64_reference(
            k ^ draws.splitmix64_reference(i))
        assert float(u[i]) == (bits >> 11) * 2.0 ** -53


def test_sampled_selection_draws_from_q():
    """20,000 slots from a q with zeros: no zero-q client, frequencies
    within 5 standard deviations of q."""
    q = np.random.default_rng(0).dirichlet(np.ones(N)).astype(np.float32)
    q[[0, 5, N - 1]] = 0.0
    q /= q.sum()
    tp = make_params(N)
    tp = system_params_from_numpy(tp, device="cpu")
    slots = 20_000
    sel = tpol.sampled_selection(
        tp, 0, None, None, torch.as_tensor(q),
        draws.round_key(torch.tensor(7), 0, draws.SELECT_STREAM),
        torch.arange(slots), None).numpy()
    freq = np.bincount(sel, minlength=N) / slots
    assert np.all(freq[q == 0] == 0.0)
    sd = np.sqrt(q * (1 - q) / slots)
    assert np.all(np.abs(freq - q) <= 5 * sd + 1e-12)


def test_dispatch_by_id_equals_the_direct_calls():
    sp, tp, h, queues, V, lam = _inputs(seed=8)
    th, tq = torch.as_tensor(h), torch.as_tensor(queues)
    kv = torch.full((N,), 3.0)
    key = draws.round_key(torch.tensor(3), 1, draws.SELECT_STREAM)
    slots = torch.arange(3)
    for cid, name in enumerate(tpol.POLICIES):
        got = tc.decide_by_id(cid, tp, th, tq, V, lam, k=kv)
        want = tpol.DECIDE_FNS[cid](tp, th, tq, V, lam, k=kv)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        sel = tc.select_by_id(cid, tp, 2, th, tq, want.q, key, slots, kv)
        mode = tpol.SELECT_FNS[tpol.SELECTION_MODES[name]]
        assert torch.equal(sel, mode(tp, 2, th, tq, want.q, key, slots, kv))
    # out-of-range ids clamp, as lax.switch does
    for cid, last in ((-3, 0), (99, len(tpol.POLICIES) - 1)):
        got = tc.decide_by_id(cid, tp, th, tq, V, lam)
        want = tpol.DECIDE_FNS[last](tp, th, tq, V, lam)
        assert torch.equal(got.q, want.q) and torch.equal(got.f, want.f)


@pytest.mark.parametrize("fn", ["uplink_rate", "upload_time", "round_time",
                                "comm_energy", "round_energy",
                                "expected_energy", "energy_increment"])
def test_k_as_data_system_model_matches_reference(fn):
    sp, tp, h, _, _, _ = _inputs(seed=9)
    rng = np.random.default_rng(10)
    f = rng.uniform(1e9, 2e9, N).astype(np.float32)
    p = rng.uniform(1e-3, 0.1, N).astype(np.float32)
    q = rng.dirichlet(np.ones(N)).astype(np.float32)
    for k in (None, 5.0, np.arange(1, N + 1, dtype=np.float32)):
        jk = None if k is None else jnp.asarray(k, jnp.float32)
        tk = None if k is None else torch.as_tensor(np.float32(k))
        jargs = {"uplink_rate": (h, p), "upload_time": (h, p),
                 "round_time": (h, p, f), "comm_energy": (h, p),
                 "round_energy": (h, p, f), "expected_energy": (h, p, f, q),
                 "energy_increment": (h, p, f, q)}[fn]
        want = getattr(jc, fn)(sp, *map(jnp.asarray, jargs), k=jk)
        got = getattr(tc, fn)(tp, *map(torch.as_tensor, jargs), k=tk)
        _close(got, want)
    assert tc.effective_k(tp, None) == tp.sample_count
    assert tc.effective_k(tp, 7) == 7


@pytest.mark.parametrize("k_as_data", [False, True])
def test_solver_k_and_objectives_match_reference(k_as_data):
    sp, tp, h, queues, V, lam = _inputs(seed=11)
    jk, tk = _k_args(k_as_data, 4)
    q = np.random.default_rng(12).dirichlet(np.ones(N)).astype(np.float32)
    jh, jq, jqu = map(jnp.asarray, (h, q, queues))
    th, tq, tqu = map(torch.as_tensor, (h, q, queues))
    f_w = jc.solve_f(sp, jq, jqu, V, k=jk)
    _close(tc.solve_f(tp, tq, tqu, V, k=tk), f_w)
    p_w = jc.solve_p(sp, jq, jqu, jh, V, k=jk)
    _close(tc.solve_p(tp, tq, tqu, th, V, k=tk), p_w)
    t = np.array(jc.round_time(sp, jh, p_w, f_w, k=jk))
    e = np.array(jc.round_energy(sp, jh, p_w, f_w, k=jk))
    _close(tc.solve_q(tp, torch.as_tensor(t), torch.as_tensor(e), tqu, V,
                      lam, tq, k=tk),
           jc.solve_q(sp, jnp.asarray(t), jnp.asarray(e), jqu, V, lam, jq,
                      k=jk))
    _close(tc.p22_objective(tp, tq, torch.as_tensor(t), torch.as_tensor(e),
                            tqu, V, lam, k=tk),
           jc.p22_objective(sp, jq, jnp.asarray(t), jnp.asarray(e), jqu, V,
                            lam, k=jk))
    dec_j = jc.solve_p2(sp, jh, jqu, V, lam, k=jk)
    dec_t = tc.solve_p2(tp, th, tqu, V, lam, k=tk)
    for g, w in zip(dec_t, dec_j):
        _close(g, w)
    _close(tc.p2_objective(tp, th, dec_t, tqu, V, lam, k=tk),
           jc.p2_objective(sp, jh, dec_j, jqu, V, lam, k=jk))


def test_queue_diagnostics_match_reference():
    sp, tp, _, queues, _, _ = _inputs(seed=13)
    nxt = queues * 1.1 + 3.0
    _close(tc.lyapunov(torch.as_tensor(queues)),
           jc.lyapunov(jnp.asarray(queues)))
    _close(tc.drift(torch.as_tensor(nxt), torch.as_tensor(queues)),
           jc.drift(jnp.asarray(nxt), jnp.asarray(queues)))
    tbar = np.random.default_rng(14).uniform(1.0, 30.0, N).astype(
        np.float32)
    _close(tc.lemma1_constant(tp, torch.as_tensor(tbar)),
           jc.lemma1_constant(sp, jnp.asarray(tbar)))


def test_convergence_bound_matches_reference():
    kw = dict(beta=2.0, G=3.0, gamma=1.5, kappa=0.7, f0_minus_fstar=2.3)
    cj, ct = jconv.BoundConstants(**kw), tconv.BoundConstants(**kw)
    for e in (1, 2, 5):
        np.testing.assert_allclose(tconv.max_learning_rate(ct, e),
                                   float(jconv.max_learning_rate(cj, e)),
                                   rtol=RTOL)
    rng = np.random.default_rng(15)
    w = rng.dirichlet(np.ones(N)).astype(np.float32)
    qs = rng.dirichlet(np.ones(N), size=6).astype(np.float32)
    _close(tconv.sampling_error_term(torch.as_tensor(w),
                                     torch.as_tensor(qs[0])),
           jconv.sampling_error_term(jnp.asarray(w), jnp.asarray(qs[0])))
    _close(tc.convergence_bound(ct, 0.01, 2, 4, 6, torch.as_tensor(w),
                                torch.as_tensor(qs)),
           jc.convergence_bound(cj, 0.01, 2, 4, 6, jnp.asarray(w),
                                jnp.asarray(qs)))
