"""The port's tier ladder (``TieredClientBank``, ``RoundEngine`` on a
multi-tier bank) against the JAX package's, case by case with
``tests/test_tiered_bank.py``: the ladder's maps, layout and memory
bound, ``make_bank``'s modes, a one-tier ladder and a one-tier selection
bitwise their single-bucket rounds, multi-tier rounds (a width-4 CNN)
against the reference's tier loop within 1e-4 with one eq.-(4) call per
round and one SGD call per hit tier, ``run_scan`` under all seven
controllers (and dropout, padded K) and the scenario arena in 'pad' and
'group' against the reference on the same ladder, the trainer's 'auto'
ladder against the JAX trainer, and a warmup that changes nothing.

The reference draws slot k's epoch keys as ``uniform(ek, (B_t,))`` with
``B_t`` its tier's bucket; threefry draws are not prefix-stable, so the
tests draw them at ``B_t`` per slot and pad them to the widest bucket,
whose first ``B_t`` columns the port reads."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.data.pipeline as jpipe  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.optim as jopt  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.data as td  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)
from repro_torch.fl import round_engine as tre  # noqa: E402
from repro_torch.fl import server as tserver  # noqa: E402

E, BS, T, K = 2, 16, 3, 4
TOL = 1e-4
SKEWED = [64, 10, 33, 64, 100, 17, 48, 12]      # 4 tiers: 16, 32, 64, 128
METRICS = ("loss", "wall_time", "energy_mean", "queue_mean", "queue_norm",
           "q_min", "q_max")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _client_data(sizes, seed=3):
    x, y = synthetic_image_classification(sum(sizes), (8, 8, 1), 4,
                                          noise=0.3, seed=seed)
    offs = np.cumsum([0] + list(sizes))
    return [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
            for i in range(len(sizes))]


def _tasks(kind):
    if kind == "cnn":
        return (jm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4),
                tm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4))
    return (jm.MLPTask(input_dim=64, num_classes=4, hidden=8),
            tm.MLPTask(input_dim=64, num_classes=4, hidden=8))


def _engines(kind="cnn"):
    jtask, ttask = _tasks(kind)
    return (jfl.RoundEngine(jtask, jfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS)),
            tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS),
                            device="cpu"))


def _port_params(jparams, task):
    return params_from_jax({n: np.asarray(v) for n, v in jparams.items()},
                           task, device="cpu")


def _slot_keys(rngs, rows_of_slot, width):
    """``[K, E, width]``: slot k's reference keys ``uniform(split(rngs[k],
    E)[e], (rows_of_slot[k],))``, zero-padded to ``width``."""
    out = np.zeros((len(rows_of_slot), E, width), np.float32)
    for k, rows in enumerate(rows_of_slot):
        for e, ek in enumerate(jax.random.split(rngs[k], E)):
            out[k, e, :rows] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def _rows_of(bank, clients):
    """The bucket each client's tier trains at (tier 0 for -1 slots)."""
    clients = np.where(np.asarray(clients) < 0, 0, clients)
    return [bank.tier_buckets[bank.tier_of[c]] for c in clients]


def _assert_params_close(got, jparams, task, tol=TOL):
    want = _port_params(jparams, task)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


def _assert_bitwise(a, b):
    for name in a:
        assert torch.equal(a[name], b[name]), name


# -- tier assignment and the ladder's structure -----------------------------


@pytest.mark.parametrize("sizes,max_tiers", [
    ([64] * 9, 4), ([1, 5, 15, 16, 64], 4), (SKEWED, 4),
    ([10, 20, 40, 70, 140, 300, 600], 3),
    ([10, 20, 40, 70, 140, 300, 600], 1)],
    ids=["equal", "tiny", "ladder", "merge3", "merge1"])
def test_assign_tiers_matches_reference(sizes, max_tiers):
    got = td.assign_tiers(sizes, BS, max_tiers)
    want = jpipe.assign_tiers(sizes, BS, max_tiers)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_tiered_bank_maps_views_and_memory_bound():
    cd = _client_data(SKEWED)
    jeng, teng = _engines()
    bank = teng.make_bank(cd, tiered="tiered")
    ref = jeng.make_bank(cd, tiered="tiered")
    assert isinstance(bank, tfl.TieredClientBank) and bank.num_tiers == 4
    np.testing.assert_array_equal(bank.tier_of, ref.tier_of)
    np.testing.assert_array_equal(bank.pos_in_tier, ref.pos_in_tier)
    assert bank.tier_buckets == ref.tier_buckets
    assert bank.bucket_examples == max(ref.tier_buckets)
    np.testing.assert_array_equal(bank.tier_of_device.numpy(), bank.tier_of)
    np.testing.assert_array_equal(bank.pos_device.numpy(), bank.pos_in_tier)
    np.testing.assert_array_equal(bank.sizes, SKEWED)
    for tier, rtier in zip(bank.tiers, ref.tiers):
        xs, ys, ns, ne = tier.device_args()
        rx, ry, rns, rne = rtier.device_args()
        np.testing.assert_array_equal(xs.numpy(),
                                      np.moveaxis(np.asarray(rx), -1, -3))
        np.testing.assert_array_equal(ys.numpy(), np.asarray(ry))
        assert tier.steps_per_epoch == rtier.steps_per_epoch
        assert tier.uniform == rtier.uniform
    for i in range(len(SKEWED)):
        t, r = bank.tier_of[i], bank.pos_in_tier[i]
        assert bank.tier_members[t][r] == i
        vx, vy = bank.client_view(i)
        np.testing.assert_array_equal(vx, cd[i][0])
        np.testing.assert_array_equal(vy, cd[i][1])
    single = teng.make_bank(cd, tiered="single")
    assert bank.true_examples == single.true_examples == sum(SKEWED)
    assert bank.padded_examples == ref.padded_examples
    assert bank.padded_examples < single.padded_examples
    assert bank.padded_examples <= sum(
        td.client_bucket_examples(n, BS) for n in SKEWED)
    assert bank.nbytes == sum(
        tfl.estimate_bank_nbytes([SKEWED[i] for i in m], BS, (8, 8, 1))
        for m in bank.tier_members) < single.nbytes
    assert bank.bytes_per_client == bank.nbytes / len(SKEWED)


def test_make_bank_modes():
    _, eng = _engines()
    cd = _client_data([64] * 4)
    assert isinstance(eng.make_bank(cd), tfl.ClientBank)            # auto
    ladder = eng.make_bank(cd, tiered="tiered")
    assert isinstance(ladder, tfl.TieredClientBank)
    assert ladder.num_tiers == 1
    skewed = _client_data([64, 10, 100, 64])
    assert isinstance(eng.make_bank(skewed), tfl.TieredClientBank)  # auto
    assert isinstance(eng.make_bank(skewed, tiered="single"),
                      tfl.ClientBank)
    assert eng.make_bank(_client_data(SKEWED), max_tiers=2).num_tiers == 2
    assert isinstance(eng.make_bank(_client_data(SKEWED), max_tiers=1),
                      tfl.ClientBank)
    assert eng.make_bank(skewed, storage="int8").tiers[0].storage == "int8"
    with pytest.raises(ValueError):
        eng.make_bank(cd, tiered="bogus")
    with pytest.raises(ValueError, match="single-bucket"):
        eng.make_bank(skewed, tiered="tiered", clusters=2)


# -- one tier: bitwise the single bucket -------------------------------------


def test_one_tier_ladder_round_and_scan_bitwise_equal_single_bucket():
    cd = _client_data([64] * 6)
    _, eng = _engines("mlp")
    single = eng.make_bank(cd, tiered="single")
    ladder = eng.make_bank(cd, tiered="tiered")
    assert ladder.num_tiers == 1
    params = eng.task.init(torch.Generator().manual_seed(0))
    sel = np.asarray([0, 2, 5, 1])
    coeffs = np.asarray([.2, .3, .1, .4], np.float32)
    keys = torch.rand((4, E, 64), generator=torch.Generator().manual_seed(5))
    p_s, l_s = eng.round_step(params, single, sel, coeffs, .1, keys)
    p_t, l_t = eng.round_step(params, ladder, sel, coeffs, .1, keys)
    _assert_bitwise(p_s, p_t)
    assert torch.equal(l_s, l_t)
    sp = tc.paper_default_params(num_devices=6, sample_count=4,
                                 data_sizes=np.full(6, 64, np.float32),
                                 device="cpu")
    h = np.random.default_rng(0).uniform(0.05, 0.4, (4, 6)).astype(
        np.float32)
    lr = np.full(4, .1, np.float32)
    runs = [eng.run_scan(params, sp, bank, h, lr,
                         torch.Generator().manual_seed(2), policy="uni_d")
            for bank in (single, ladder)]
    _assert_bitwise(runs[0][0], runs[1][0])
    for name in runs[0][2]:
        np.testing.assert_array_equal(runs[0][2][name], runs[1][2][name])


@pytest.fixture(scope="module")
def ladder():
    """Both packages' CNN engines and ladders over SKEWED, the initial
    params, and a round's coefficients and reference keys."""
    cd = _client_data(SKEWED)
    jeng, teng = _engines()
    p0 = jeng.task.init(jax.random.PRNGKey(0))
    return dict(clients=cd, jeng=jeng, teng=teng,
                jbank=jeng.make_bank(cd, tiered="tiered"),
                tbank=teng.make_bank(cd, tiered="tiered"), jp0=p0,
                tp0=_port_params(p0, teng.task),
                coeffs=np.asarray([.2, .3, .1, .4], np.float32),
                rngs=jax.random.split(jax.random.PRNGKey(5), K))


def _round_pair(lad, sel, monkeypatch):
    """The reference's tiered round and the port's on the same inputs;
    the port's eq.-(4) and SGD calls counted."""
    calls = {"aggregate": 0, "sgd": []}
    agg, sgd = tserver.aggregate_fused, tre.fl_client.batched_local_sgd

    def count_agg(*a, **kw):
        calls["aggregate"] += 1
        return agg(*a, **kw)

    def count_sgd(loss_fn, params, xs, *a, **kw):
        calls["sgd"].append(tuple(xs.shape[:2]))
        return sgd(loss_fn, params, xs, *a, **kw)

    monkeypatch.setattr(tserver, "aggregate_fused", count_agg)
    monkeypatch.setattr(tre.fl_client, "batched_local_sgd", count_sgd)
    jp, jl = lad["jeng"].round_step(lad["jp0"], lad["jbank"], sel,
                                    lad["coeffs"], .1, lad["rngs"])
    keys = _slot_keys(lad["rngs"], _rows_of(lad["tbank"], sel),
                      lad["tbank"].bucket_examples)
    tp_, tl = lad["teng"].round_step(lad["tp0"], lad["tbank"], sel,
                                     lad["coeffs"], .1, keys)
    return (jp, np.asarray(jl)), (tp_, tl.numpy()), calls


@pytest.mark.parametrize("sel", [[0, 2, 3, 0], [5, 5, 5, 5]],
                         ids=["tier64", "tier16"])
def test_selection_within_one_tier_is_bitwise_that_tier_round(ladder, sel,
                                                              monkeypatch):
    """Bitwise the tier's own single-bucket round (rows at pos_in_tier,
    the first B_t key columns), and within 1e-4 of the reference."""
    sel = np.asarray(sel)
    bank = ladder["tbank"]
    (jp, jl), (tp_, tl), calls = _round_pair(ladder, sel, monkeypatch)
    (t,) = np.unique(bank.tier_of[sel])
    keys = _slot_keys(ladder["rngs"], _rows_of(bank, sel),
                      bank.bucket_examples)
    p1, l1 = ladder["teng"].round_step(
        ladder["tp0"], bank.tiers[t], bank.pos_in_tier[sel],
        ladder["coeffs"], .1, keys[..., :bank.tier_buckets[t]])
    _assert_bitwise(tp_, p1)
    np.testing.assert_array_equal(tl, l1.numpy())
    _assert_params_close(tp_, jp, ladder["teng"].task)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert calls["aggregate"] == 2 and len(calls["sgd"]) == 2


@pytest.mark.parametrize("sel", [[1, 4, 0, 5], [1, 0, 2, 1], [4, 4, 7, 0]],
                         ids=["four_tiers", "empty_tiers", "two_tiers"])
def test_multi_tier_round_matches_reference(ladder, sel, monkeypatch):
    """One SGD call per HIT tier, over its member slots only, one eq.-(4)
    call for all K; params and losses within 1e-4 of the reference's
    tier loop (which runs all K slots through each hit tier)."""
    sel = np.asarray(sel)
    bank = ladder["tbank"]
    hit = np.unique(bank.tier_of[sel])
    assert hit.size > 1
    (jp, jl), (tp_, tl), calls = _round_pair(ladder, sel, monkeypatch)
    _assert_params_close(tp_, jp, ladder["teng"].task)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert calls["aggregate"] == 1
    assert calls["sgd"] == [(int(np.sum(bank.tier_of[sel] == t)),
                             bank.tier_buckets[t]) for t in hit]


def test_tiered_round_accepts_empty_selection_like_single_bucket(ladder):
    p, l = ladder["teng"].round_step(
        ladder["tp0"], ladder["tbank"], np.asarray([], np.int64),
        np.asarray([], np.float32), .1, torch.zeros(0, E, 128))
    _assert_bitwise(p, ladder["tp0"])
    assert tuple(l.shape) == (0,)


def test_tiered_round_rejects_out_of_range_selection(ladder):
    with pytest.raises(IndexError):
        ladder["teng"].round_step(ladder["tp0"], ladder["tbank"],
                                  np.asarray([len(SKEWED)]),
                                  np.ones(1, np.float32), .1,
                                  torch.zeros(1, E, 128))


# -- the tiered rollout and the arena against the reference ---------------------


def _scan_keys(rng, selected, bank, k):
    """The reference scan's ``[T, k, E, B_max]`` epoch keys on a ladder:
    per round ``split(rng, 3)``, per slot ``fold_in(k_cli, i)``, keys at
    the slot's tier bucket, padded."""
    out = np.zeros((T, k, E, bank.bucket_examples), np.float32)
    for t in range(T):
        rng, _, k_cli = jax.random.split(rng, 3)
        rngs = [jax.random.fold_in(k_cli, i) for i in range(k)]
        out[t] = _slot_keys(rngs, _rows_of(bank, selected[t]),
                            bank.bucket_examples)
    return out


@pytest.fixture(scope="module")
def scan_bed():
    cd = _client_data(SKEWED)
    jeng, teng = _engines("mlp")
    sp = jc.paper_default_params(num_devices=len(SKEWED), sample_count=K,
                                 local_epochs=E,
                                 data_sizes=np.asarray(SKEWED, np.float32))
    p0 = jeng.task.init(jax.random.PRNGKey(0))
    hp = jc.estimate_hyperparams(sp, 0.1, 1.5)
    return dict(
        sp=sp, tp=system_params_from_numpy(sp, "cpu"), jeng=jeng, teng=teng,
        jbank=jeng.make_bank(cd, tiered="tiered"),
        tbank=teng.make_bank(cd, tiered="tiered"), jp0=p0,
        tp0=_port_params(p0, teng.task),
        h=np.random.default_rng(5).uniform(0.05, 0.4, (T, len(SKEWED))
                                           ).astype(np.float32),
        lr=np.asarray([0.1, 0.1, 0.05], np.float32), V=hp.V, lam=hp.lam)


SCAN_CASES = [(p, {}) for p in tc.POLICIES] + [("lroa", "dropout"),
                                               ("lroa", "padded")]


@pytest.mark.parametrize("policy,extra", SCAN_CASES,
                         ids=[f"{p}-{e or 'plain'}" for p, e in SCAN_CASES])
def test_tiered_scan_matches_reference(scan_bed, policy, extra,
                                       monkeypatch):
    b = scan_bed
    kw, k_max = {}, None
    if extra == "dropout":
        kw["drop_seq"] = jfl.ChannelProcess(
            len(SKEWED), jfl.ChannelConfig(seed=4, dropout=0.2)
        ).dropout_sequence(T)
    rng = jax.random.PRNGKey(2)
    jp, jq, jmet = b["jeng"].run_scan(
        b["jp0"], b["sp"], b["jbank"], b["h"], b["lr"], rng, policy=policy,
        V=b["V"], lam=b["lam"], **kw)
    jsel = jmet["selected"]
    if extra == "padded":
        k_max = K + 2
        jsel = np.concatenate([jsel, np.full((T, 2), -1)], axis=1)
    calls = []
    agg = tserver.aggregate_fused
    monkeypatch.setattr(tserver, "aggregate_fused",
                        lambda *a, **k: calls.append(1) or agg(*a, **k))
    keys = _scan_keys(rng, jsel[:, :K], b["tbank"], K)
    if k_max is not None:
        keys = np.concatenate([keys, np.zeros((T, 2) + keys.shape[2:],
                                              np.float32)], axis=1)
    deterministic = policy in ("round_robin", "divfl")
    tp_, tq, tmet = b["teng"].run_scan(
        b["tp0"], b["tp"], b["tbank"], b["h"], b["lr"],
        torch.Generator().manual_seed(0), policy=policy, V=b["V"],
        lam=b["lam"], k_max=k_max,
        replay_selected=None if deterministic else jsel,
        replay_sort_keys=keys, **kw)
    np.testing.assert_array_equal(tmet["selected"], jsel)
    hits = [np.unique(b["tbank"].tier_of[np.maximum(s, 0)]).size
            for s in jsel]
    assert max(hits) > 1
    assert len(calls) == T                   # one eq.-(4) call per round
    for name in METRICS:
        np.testing.assert_allclose(tmet[name], jmet[name], rtol=TOL,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=TOL,
                               atol=TOL)
    _assert_params_close(tp_, jp, b["teng"].task)


def test_tiered_scan_trains_and_stays_finite(scan_bed):
    b = scan_bed
    params, _, m = b["teng"].run_scan(
        b["tp0"], b["tp"], b["tbank"], b["h"], b["lr"],
        torch.Generator().manual_seed(8), policy="uni_d")
    assert np.all(np.isfinite(m["loss"]))
    assert m["selected"].shape == (T, K)
    assert np.all((m["selected"] >= 0) & (m["selected"] < len(SKEWED)))
    assert max(float((params[n] - b["tp0"][n]).abs().max())
               for n in params) > 0


@pytest.mark.parametrize("k_mode", ["pad", "group"])
def test_tiered_arena_matches_reference(scan_bed, k_mode, monkeypatch):
    """The seven controllers and an LROA lane at K = 2 on the ladder: the
    reference's selections and per-tier epoch keys replayed; params,
    queues and metrics within 1e-4; one lane-batched eq.-(4) call per
    round ('pad'; one per group and round for 'group')."""
    b = scan_bed
    hp = jc.estimate_hyperparams(b["sp"], 0.1, 1.5)
    ks = [K] * 7 + [2]

    def grid(pkg):
        return pkg.ScenarioGrid.create(
            list(tc.POLICIES) + ["lroa"], seeds=np.arange(8) + 3, V=hp.V,
            lam=hp.lam, sample_count=ks, num_devices=len(SKEWED))

    h = np.broadcast_to(b["h"], (8,) + b["h"].shape)
    jrep = jsim.Arena(b["jeng"], k_mode=k_mode).run(
        b["jp0"], b["sp"], b["jbank"], grid(jsim), T, b["lr"], h_all=h)
    jsel = jrep.metrics["selected"]
    roll = jsim.scenario_keys(grid(jsim))[1]
    keys = np.stack([_scan_keys(roll[s], jsel[s], b["tbank"], K)
                     for s in range(8)])
    calls = []
    agg = tserver.aggregate_fused_lanes
    monkeypatch.setattr(tserver, "aggregate_fused_lanes",
                        lambda *a, **k: calls.append(1) or agg(*a, **k))
    rep = tsim.Arena(b["teng"], k_mode=k_mode).run(
        b["tp0"], b["tp"], b["tbank"], grid(tsim), T, b["lr"], h_all=h,
        replay_selected=jsel, replay_sort_keys=keys)
    assert len(calls) == T * (1 if k_mode == "pad" else 2)
    np.testing.assert_array_equal(rep.metrics["selected"], jsel)
    for name in METRICS:
        np.testing.assert_allclose(rep.metrics[name], jrep.metrics[name],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(rep.queues, np.asarray(jrep.queues),
                               rtol=TOL, atol=TOL)
    for s in range(8):
        _assert_params_close({n: v[s] for n, v in rep.params.items()},
                             {n: v[s] for n, v in jrep.params.items()},
                             b["teng"].task)
    assert rep.meta["buckets"][0]["tiers"] == [0, 1, 2, 3]
    assert rep.meta["bank_layout"] == tre.bank_layout_key(b["tbank"])
    assert rep.meta["tier_work"] == {0: 32.0, 1: 64.0, 2: 128.0, 3: 256.0}
    assert rep.meta["bank_nbytes"] == b["tbank"].nbytes


# -- the trainer -------------------------------------------------------------


class _TierKeys:
    """The JAX trainer's keys for the round it has just run
    (``_client_rngs`` splits, then ``uniform`` at each client's tier
    bucket), padded to the widest bucket: ``selected`` is set to the
    reference's selection before the port's round."""

    def __init__(self, seed, bank):
        self.rng, self.bank, self.selected = jax.random.PRNGKey(seed), \
            bank, None

    def __call__(self, count):
        rngs = []
        for _ in range(count):
            self.rng, sub = jax.random.split(self.rng)
            rngs.append(sub)
        return _slot_keys(rngs, _rows_of(self.bank, self.selected),
                          self.bank.bucket_examples)


def _trainers(sizes, seed=0, **kw):
    cd = _client_data(sizes)
    sp = jc.paper_default_params(num_devices=len(sizes), sample_count=K,
                                 local_epochs=E,
                                 data_sizes=np.asarray(sizes, np.float32))
    tp = system_params_from_numpy(sp, device="cpu")
    jtask, ttask = _tasks("cnn")
    jtr = jfl.FederatedTrainer(
        jtask, sp, jc.LROAController(sp, jc.estimate_hyperparams(sp, 0.1,
                                                                 1.5)),
        jfl.ChannelProcess(len(sizes), jfl.ChannelConfig(seed=seed)), cd,
        jfl.ClientConfig(local_epochs=E, batch_size=BS),
        jopt.paper_step_decay(0.1, 3), seed=seed)
    ttr = tfl.FederatedTrainer(
        ttask, tp, tc.LROAController(tp, tc.estimate_hyperparams(tp, 0.1,
                                                                 1.5)),
        tfl.ChannelProcess(len(sizes), tfl.ChannelConfig(seed=seed)), cd,
        tfl.ClientConfig(local_epochs=E, batch_size=BS),
        topt.paper_step_decay(0.1, 3), seed=seed, device="cpu", **kw)
    ttr.global_params = _port_params(jtr.global_params, ttask)
    return jtr, ttr


def test_trainer_auto_ladder_matches_reference():
    """``bank_mode='auto'`` (the default) builds the ladder in both
    packages; three LROA rounds agree within 1e-4."""
    jtr, ttr = _trainers(SKEWED)
    assert isinstance(jtr.bank, jfl.TieredClientBank)
    assert isinstance(ttr.bank, tfl.TieredClientBank)
    keys = _TierKeys(0, ttr.bank)
    ttr._sort_keys_fn = keys
    for t in range(3):
        jr = jtr.run_round(t)
        keys.selected = jr.selected
        tr = ttr.run_round(t)
        assert tr.selected == jr.selected
        np.testing.assert_allclose(tr.mean_loss, jr.mean_loss, rtol=TOL,
                                   atol=TOL)
        for field in ("wall_time", "queue_mean", "energy_mean"):
            np.testing.assert_allclose(getattr(tr, field),
                                       getattr(jr, field), rtol=TOL)
        _assert_params_close(ttr.global_params, jtr.global_params,
                             ttr.task)
    _, t_uni = _trainers([64] * 8)
    assert isinstance(t_uni.bank, tfl.ClientBank)
    _, t_single = _trainers(SKEWED, bank_mode="single")
    assert isinstance(t_single.bank, tfl.ClientBank)


def test_tiered_warmup_touches_every_tier_without_mutating_state(
        monkeypatch):
    _, cold = _trainers(SKEWED)
    _, warm = _trainers(SKEWED)
    shapes = []
    sgd = tre.fl_client.batched_local_sgd

    def count_sgd(loss_fn, params, xs, *a, **kw):
        shapes.append(int(xs.shape[1]))
        return sgd(loss_fn, params, xs, *a, **kw)

    monkeypatch.setattr(tre.fl_client, "batched_local_sgd", count_sgd)
    before = {n: v.clone() for n, v in warm.global_params.items()}
    state = warm._key_gen.get_state()
    rng_state = warm._np_rng.bit_generator.state
    warm.warmup()
    assert set(shapes) == set(warm.bank.tier_buckets)
    assert len(shapes) == 2 * warm.bank.num_tiers   # per tier, then mixed
    _assert_bitwise(warm.global_params, before)
    assert torch.equal(warm._key_gen.get_state(), state)
    assert warm._np_rng.bit_generator.state == rng_state
    assert float(warm.controller.queues.abs().max()) == 0.0
    for t in range(3):
        a, b = cold.run_round(t), warm.run_round(t)
        assert a.selected == b.selected
        assert a.mean_loss == b.mean_loss
    _assert_bitwise(cold.global_params, warm.global_params)
