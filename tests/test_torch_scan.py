"""The port's multi-round rollout (``RoundEngine.run_scan``) against the
JAX package's, for every controller of the zoo (N = 6, K = 3, E = 2,
T = 3, an ``MLPTask`` on a bank with unequal clients): the same initial
params and channels, the reference's epoch keys replayed, and for the
sampled policies its selections replayed too (the threefry streams do
not carry over); round-robin and DivFL select the same clients with no
replay.  Params, queues and every metric within 1e-4.  Also dropout, the
padded-K contract (bitwise on the CPU), the port's own draws, and the
inputs that must raise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)

N, K, E, BS, T = 6, 3, 2, 8, 3
SIZES = [40, 24, 33, 17, 48, 30]
TOL = 1e-4
METRICS = ("loss", "wall_time", "energy_mean", "queue_mean", "queue_norm",
           "q_min", "q_max")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bed():
    """Both packages' engines, banks, system params and initial params,
    the channels, the learning rates and the reference's V, lam."""
    x, y = synthetic_image_classification(sum(SIZES), (8, 8, 1), 4,
                                          noise=0.3, seed=3)
    offs = np.cumsum([0] + SIZES)
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(N)]
    sp = jc.paper_default_params(num_devices=N, sample_count=K,
                                 local_epochs=E,
                                 data_sizes=np.asarray(SIZES, np.float32))
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    ttask = tm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    jeng = jfl.RoundEngine(jtask, jfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS))
    teng = tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS),
                           device="cpu")
    p0 = jtask.init(jax.random.PRNGKey(0))
    hp = jc.estimate_hyperparams(sp, 0.1, 1.5)
    bed = dict(
        clients=clients, sp=sp, tp=system_params_from_numpy(sp, "cpu"),
        jeng=jeng, teng=teng, jbank=jeng.make_bank(clients, "single"),
        tbank=teng.make_bank(clients, "single"), jp0=p0,
        tp0=params_from_jax({n: np.asarray(v) for n, v in p0.items()},
                            ttask, device="cpu"),
        h=np.random.default_rng(5).uniform(0.05, 0.4, (T, N)).astype(
            np.float32),
        lr=np.asarray([0.1, 0.1, 0.05], np.float32), V=hp.V, lam=hp.lam)
    assert bed["tbank"].bucket_examples == bed["jbank"].bucket_examples
    assert not bed["tbank"].uniform
    return bed


def _jax_epoch_keys(rng, rows):
    """The reference scan's ``[T, K, E, B]`` epoch keys: per round
    ``rng, k_sel, k_cli = split(rng, 3)``, per slot ``fold_in(k_cli,
    i)``, then ``split(., E)`` and ``uniform``."""
    out = np.zeros((T, K, E, rows), np.float32)
    for t in range(T):
        rng, _, k_cli = jax.random.split(rng, 3)
        for i in range(K):
            for e, ek in enumerate(jax.random.split(
                    jax.random.fold_in(k_cli, i), E)):
                out[t, i, e] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def _check_against_reference(bed, policy, drop_seq=None):
    rng = jax.random.PRNGKey(2)
    jp, jq, jmet = bed["jeng"].run_scan(
        bed["jp0"], bed["sp"], bed["jbank"], bed["h"], bed["lr"], rng,
        policy=policy, V=bed["V"], lam=bed["lam"], drop_seq=drop_seq)
    deterministic = policy in ("round_robin", "divfl")
    tp_, tq, tmet = bed["teng"].run_scan(
        bed["tp0"], bed["tp"], bed["tbank"], bed["h"], bed["lr"],
        torch.Generator().manual_seed(0), policy=policy, V=bed["V"],
        lam=bed["lam"], drop_seq=drop_seq,
        replay_selected=None if deterministic else jmet["selected"],
        replay_sort_keys=_jax_epoch_keys(rng, bed["jbank"].bucket_examples))
    np.testing.assert_array_equal(tmet["selected"], jmet["selected"])
    assert tmet["selected"].shape == (T, K)
    for name in METRICS:
        assert tmet[name].shape == (T,), name
        np.testing.assert_allclose(tmet[name], jmet[name], rtol=TOL,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=TOL,
                               atol=TOL)
    want = params_from_jax({n: np.asarray(v) for n, v in jp.items()},
                           bed["teng"].task, device="cpu")
    for name, v in want.items():
        np.testing.assert_allclose(tp_[name].numpy(), v.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)
    return tmet


@pytest.mark.parametrize("policy", tc.POLICIES)
def test_run_scan_matches_reference(bed, policy):
    met = _check_against_reference(bed, policy)
    assert np.all(np.isfinite(met["loss"]))
    np.testing.assert_allclose(met["q_sum"], 1.0, rtol=0.0, atol=1e-5)
    if policy == "channel_aware":
        assert np.all(met["q_min"] == 0.0)
    if policy == "round_robin":
        assert met["selected"].tolist() == [[0, 1, 2], [3, 4, 5], [0, 1, 2]]


def test_run_scan_with_dropout_matches_reference(bed):
    """The same alive mask through both rollouts: a dropped slot is
    masked like an inert one, a round in which every slot dropped has
    wall time 0, and the queues drift on expectations."""
    tproc = tfl.ChannelProcess(N, tfl.ChannelConfig(seed=4, dropout=0.3))
    jproc = jfl.ChannelProcess(N, jfl.ChannelConfig(seed=4, dropout=0.3))
    drop = tproc.dropout_sequence(T)
    np.testing.assert_array_equal(drop, jproc.dropout_sequence(T))
    assert 0.0 < drop.mean() < 1.0
    drop[2] = 0.0                        # every client drops in round 2
    met = _check_against_reference(bed, "lroa", drop_seq=drop)
    assert met["wall_time"][2] == 0.0 and met["energy_mean"][2] == 0.0
    # the queues do not see dropout
    _, q_clean, _ = bed["teng"].run_scan(
        bed["tp0"], bed["tp"], bed["tbank"], bed["h"], bed["lr"],
        torch.Generator().manual_seed(0), V=bed["V"], lam=bed["lam"])
    _, q_drop, _ = bed["teng"].run_scan(
        bed["tp0"], bed["tp"], bed["tbank"], bed["h"], bed["lr"],
        torch.Generator().manual_seed(0), V=bed["V"], lam=bed["lam"],
        drop_seq=drop)
    assert torch.equal(q_clean, q_drop)


@pytest.mark.parametrize("policy", tc.POLICIES)
def test_padded_k_is_bitwise_the_unpadded_rollout(bed, policy):
    """K_max = K + 2: the first K slots select as before, the extra ones
    report -1, and params, queues and metrics are bitwise equal (on one
    CPU thread, as the module's fixture runs: with several, PyTorch's
    CPU reductions split the client axis by thread count)."""
    h = bed["h"].copy()
    # client 0 (where padded slots land) gets the weakest channel, so
    # channel_aware gives it q = 0 and w / (K q) is inf in those slots
    h[:, 0] = 0.01
    runs = [bed["teng"].run_scan(
        bed["tp0"], bed["tp"], bed["tbank"], h, bed["lr"],
        torch.Generator().manual_seed(11), policy=policy, V=bed["V"],
        lam=bed["lam"], k_max=k_max) for k_max in (None, K + 2)]
    (p1, q1, m1), (p2, q2, m2) = runs
    np.testing.assert_array_equal(m2["selected"][:, :K], m1["selected"])
    assert np.all(m2["selected"][:, K:] == -1)
    for name in METRICS + ("q_sum",):
        np.testing.assert_array_equal(m2[name], m1[name], err_msg=name)
    assert torch.equal(q1, q2)
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
        assert bool(torch.isfinite(p2[name]).all()), name


def test_own_draws_are_reproducible_and_keyed_by_the_generator(bed):
    def run(seed, policy="lroa"):
        return bed["teng"].run_scan(
            bed["tp0"], bed["tp"], bed["tbank"], bed["h"], bed["lr"],
            torch.Generator().manual_seed(seed), policy=policy, V=bed["V"],
            lam=bed["lam"])

    (pa, qa, ma), (pb, qb, mb) = run(1), run(1)
    np.testing.assert_array_equal(ma["selected"], mb["selected"])
    assert torch.equal(qa, qb)
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert not np.array_equal(run(2)[2]["selected"], ma["selected"])
    changed = max(float((pa[n] - bed["tp0"][n]).abs().max()) for n in pa)
    assert changed > 0.0 and np.all(np.isfinite(ma["loss"]))
    # starting queues carry over: a second segment from the first's queues
    _, q2, m2 = bed["teng"].run_scan(
        pa, bed["tp"], bed["tbank"], bed["h"], bed["lr"],
        torch.Generator().manual_seed(3), queues=qa, V=bed["V"],
        lam=bed["lam"])
    assert float(m2["queue_mean"][0]) != float(ma["queue_mean"][0])


def test_run_scan_rejects_what_it_cannot_run(bed):
    eng, args = bed["teng"], (bed["tp0"], bed["tp"], bed["tbank"],
                              bed["h"], bed["lr"])
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="scan-traceable"):
        eng.run_scan(*args, gen, policy="bogus")
    tiered = eng.make_bank(bed["clients"], tiered="tiered")
    with pytest.raises(ValueError, match="replay_sort_keys"):
        eng.run_scan(bed["tp0"], bed["tp"], tiered, bed["h"], bed["lr"],
                     gen, replay_sort_keys=np.zeros(
                         (T, K, E, tiered.tier_buckets[0])))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tfl.RoundEngine(eng.task, eng.cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="k_max"):
        eng.run_scan(*args, gen, k_max=K - 1)
    with pytest.raises(ValueError, match="replay_selected"):
        eng.run_scan(*args, gen, replay_selected=np.zeros((T, K + 1)))
    with pytest.raises(ValueError, match="replay_sort_keys"):
        eng.run_scan(*args, gen, replay_sort_keys=np.zeros((T, K, E, 3)))
    with pytest.raises(ValueError, match="drop_seq"):
        eng.run_scan(*args, gen, drop_seq=np.ones((T, N + 1)))
    with pytest.raises(ValueError, match="lr_seq"):
        eng.run_scan(bed["tp0"], bed["tp"], bed["tbank"], bed["h"],
                     bed["lr"][:2], gen)
    with pytest.raises(ValueError, match="dropout"):
        tfl.ChannelConfig(dropout=1.0)
    with pytest.raises(ValueError, match="dropout"):
        jfl.ChannelConfig(dropout=1.0)
