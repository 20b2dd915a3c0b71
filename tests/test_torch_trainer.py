"""The port's whole slice against the JAX package: a 3-round LROA
``FederatedTrainer`` run (N = 6, K = 3, ``bank_mode='single'``, a width-4
CNN on 8x8x1 images) selects the same clients, and its params, losses
and queues agree within 1e-4.  Also the numpy layers that must carry over
bitwise (data, channel gains, client sampling), the bank's layout, and
the parts of the JAX trainer this slice rejects."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.data as jd  # noqa: E402
import repro.data.pipeline as jpipe  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.optim as jopt  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.data as td  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)

N, K, E, BS, ROUNDS = 6, 3, 2, 8, 3
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _testbed(seed=0, num_devices=N, examples=300):
    x, y = td.synthetic_image_classification(examples, (8, 8, 1), 4,
                                             seed=seed)
    parts = td.dirichlet_partition(y, num_devices, 0.5, seed=seed + 2)
    return td.make_client_datasets(x, y, parts), np.asarray(
        [len(p) for p in parts], np.float32)


class _JaxEpochKeys:
    """The JAX trainer's per-round client keys (``_client_rngs``, then
    ``jax.random.split(rng, E)`` and ``uniform`` per epoch), as data."""

    def __init__(self, seed, rows):
        self.rng = jax.random.PRNGKey(seed)
        self.rows = rows

    def __call__(self, count):
        keys = np.zeros((count, E, self.rows), np.float32)
        for i in range(count):
            self.rng, sub = jax.random.split(self.rng)
            for e, ek in enumerate(jax.random.split(sub, E)):
                keys[i, e] = np.asarray(jax.random.uniform(ek, (self.rows,)))
        return keys


def test_trainer_matches_reference_for_three_rounds():
    clients, sizes = _testbed()
    sp = jc.paper_default_params(num_devices=N, sample_count=K,
                                 local_epochs=E, data_sizes=sizes)
    tp = system_params_from_numpy(sp, device="cpu")
    jtask = jm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4)
    ttask = tm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4)
    jtr = jfl.FederatedTrainer(
        jtask, sp, jc.LROAController(sp, jc.estimate_hyperparams(sp, 0.1,
                                                                 1.5)),
        jfl.ChannelProcess(N, jfl.ChannelConfig(seed=0)), clients,
        jfl.ClientConfig(local_epochs=E, batch_size=BS),
        jopt.paper_step_decay(0.1, ROUNDS), seed=0, bank_mode="single")
    rows = jtr.bank.bucket_examples
    ttr = tfl.FederatedTrainer(
        ttask, tp, tc.LROAController(tp, tc.estimate_hyperparams(tp, 0.1,
                                                                 1.5)),
        tfl.ChannelProcess(N, tfl.ChannelConfig(seed=0)), clients,
        tfl.ClientConfig(local_epochs=E, batch_size=BS),
        topt.paper_step_decay(0.1, ROUNDS), seed=0, bank_mode="single",
        device="cpu", sort_keys_fn=_JaxEpochKeys(0, rows))
    assert ttr.bank.bucket_examples == rows and not ttr.bank.uniform
    ttr.global_params = params_from_jax(
        {n: np.asarray(v) for n, v in jtr.global_params.items()}, ttask,
            device="cpu")
    ttr.warmup()
    for t in range(ROUNDS):
        jr, tr = jtr.run_round(t), ttr.run_round(t)
        assert tr.selected == jr.selected
        np.testing.assert_allclose(tr.mean_loss, jr.mean_loss, atol=TOL,
                                   rtol=TOL)
        for field in ("wall_time", "q_min", "q_max", "queue_mean",
                      "energy_mean"):
            np.testing.assert_allclose(getattr(tr, field),
                                       getattr(jr, field), rtol=TOL)
        want = params_from_jax(
            {n: np.asarray(v) for n, v in jtr.global_params.items()}, ttask,
            device="cpu")
        for name, v in want.items():
            np.testing.assert_allclose(ttr.global_params[name].numpy(),
                                       v.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ttr.controller.queues.numpy(),
                                   np.asarray(jtr.controller.queues),
                                   atol=TOL, rtol=TOL)


def test_run_and_warmup_leave_state_consistent():
    """``warmup`` changes no trainer state; ``run`` returns a snapshot."""
    clients, sizes = _testbed(seed=3)
    tp = tc.paper_default_params(num_devices=N, sample_count=K,
                                 local_epochs=E, data_sizes=sizes,
                                 device="cpu")
    task = tm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    x, y = td.synthetic_image_classification(40, (8, 8, 1), 4, seed=9)
    tr = tfl.FederatedTrainer(
        task, tp, tc.LROAController(tp, tc.estimate_hyperparams(tp, 0.1)),
        tfl.ChannelProcess(N), clients,
        tfl.ClientConfig(local_epochs=E, batch_size=BS),
        topt.constant(0.1), test_data=(x, y), eval_every=2, seed=1,
        bank_mode="single", device="cpu")
    before = {n: v.clone() for n, v in tr.global_params.items()}
    state = tr._key_gen.get_state()
    tr.warmup()
    assert torch.equal(tr._key_gen.get_state(), state)
    assert float(tr.controller.queues.abs().max()) == 0.0
    for n, v in before.items():
        assert torch.equal(tr.global_params[n], v)
    res = tr.run(2)
    assert [r.round for r in res.records] == [0, 1]
    assert res.records[-1].test_accuracy is not None
    assert res.controller_name == "lroa" and res.total_time > 0
    assert np.isfinite([r.mean_loss for r in res.records]).all()


def test_data_layer_is_bitwise_the_reference():
    x1, y1 = td.synthetic_image_classification(200, (4, 4, 3), 5, seed=4)
    x2, y2 = jd.synthetic_image_classification(200, (4, 4, 3), 5, seed=4)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    for a, b in zip(td.dirichlet_partition(y1, 7, 0.5, seed=1),
                    jd.dirichlet_partition(y2, 7, 0.5, seed=1)):
        np.testing.assert_array_equal(a, b)
    (a_tr, a_te), (b_tr, b_te) = (td.train_test_split(x1, y1, 0.2, seed=2),
                                  jd.train_test_split(x2, y2, 0.2, seed=2))
    for a, b in zip(a_tr + a_te, b_tr + b_te):
        np.testing.assert_array_equal(a, b)
    clients, _ = _testbed(seed=5)
    for a, b in zip(td.stack_client_arrays(clients, BS),
                    jpipe.stack_client_arrays(clients, BS)):
        np.testing.assert_array_equal(a, b)
    sizes = [3, 17, 40, 100, 260, 33]
    for tiers in (1, 2, 4):
        got, want = (td.assign_tiers(sizes, BS, tiers),
                     jpipe.assign_tiers(sizes, BS, tiers))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("cfg", [
    dict(seed=3), dict(seed=1, mode="markov", p_gb=0.2, p_bg=0.3)])
def test_channel_and_sampling_are_bitwise_the_reference(cfg):
    tproc = tfl.ChannelProcess(9, tfl.ChannelConfig(**cfg))
    jproc = jfl.ChannelProcess(9, jfl.ChannelConfig(**cfg))
    for _ in range(3):
        np.testing.assert_array_equal(tproc.sample(), jproc.sample())
    np.testing.assert_array_equal(tproc.sample_sequence(5),
                                  jproc.sample_sequence(5))
    q = np.random.default_rng(0).dirichlet(np.ones(9)).astype(np.float32)
    w = np.random.default_rng(1).dirichlet(np.ones(9)).astype(np.float32)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(4):
        sel_t = tfl.sample_clients(a, q, 4)
        sel_j = jfl.sample_clients(b, q, 4)
        np.testing.assert_array_equal(sel_t, sel_j)
        np.testing.assert_array_equal(
            tfl.aggregation_weights(sel_t, q, w, 4),
            jfl.aggregation_weights(sel_j, q, w, 4))


def test_bank_layout_matches_reference_bank():
    clients, _ = _testbed(seed=6)
    cfg = tfl.ClientConfig(local_epochs=E, batch_size=BS)
    task = tm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4)
    bank = tfl.RoundEngine(task, cfg, device="cpu").make_bank(
        clients, tiered="single")
    ref = jfl.ClientBank(clients, jfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS))
    xs, ys, ns, ne = bank.device_args()
    rx, ry, rns, rne = ref.device_args()
    np.testing.assert_array_equal(xs.numpy(),
                                  np.moveaxis(np.asarray(rx), -1, -3))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ry))
    np.testing.assert_array_equal(ns.numpy(), np.asarray(rns))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(rne))
    assert bank.steps_per_epoch == ref.steps_per_epoch
    # the reference's dtypes and bytes: f32 features, int32 labels and
    # masks (widened to int64 after the gather)
    assert [t.dtype for t in (xs, ys, ns, ne)] == [torch.float32] + \
        [torch.int32] * 3
    assert bank.nbytes == ref.nbytes == (xs.numel() * 4 + ys.numel() * 4
                                         + 2 * bank.num_clients * 4)


def test_unported_bank_modes_raise():
    """The bank layer's modes build (the ladder, int8 storage, cluster
    routing); a ``mesh=`` that is no ``DeviceMesh`` raises (the sharded
    banks are held in ``tests/test_torch_sharding.py``)."""
    clients, _ = _testbed(seed=0, num_devices=12, examples=900)
    cfg = tfl.ClientConfig(local_epochs=E, batch_size=BS)
    engine = tfl.RoundEngine(tm.MLPTask(input_dim=64, num_classes=4), cfg,
                             device="cpu")
    assert len(td.assign_tiers([len(x) for x, _ in clients], BS)[1]) > 1
    for mode in ("tiered", "auto"):
        assert isinstance(engine.make_bank(clients, tiered=mode),
                          tfl.TieredClientBank)
    assert tfl.ClientBank(clients, cfg, device="cpu",
                          storage="int8").xs.dtype == torch.int8
    assert tfl.ClientBank(clients, cfg, device="cpu",
                          clusters=2).num_clusters == 2
    for build in (tfl.ClientBank, tfl.TieredClientBank):
        with pytest.raises(TypeError, match="DeviceMesh"):
            build(clients, cfg, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="bank mode"):
        engine.make_bank(clients, tiered="ladder")
    uniform = [(np.ones((16, 8, 8, 1), np.float32), np.zeros(16, np.int32))
               for _ in range(3)]
    assert engine.make_bank(uniform, tiered="auto").uniform
    bank = engine.make_bank(clients, tiered="single")
    params = engine.task.init(torch.Generator().manual_seed(0))
    with pytest.raises(IndexError, match="out of range"):
        engine.round_step(params, bank, np.asarray([0, 12]),
                          np.ones(2, np.float32), 0.1,
                          torch.zeros(2, E, bank.bucket_examples))
    with pytest.raises(ValueError, match="impl"):
        tfl.RoundEngine(engine.task, cfg, impl="pallas", device="cpu")
