"""The sequential reference path of the port against the JAX package:
``client.local_update`` (tiling a client of fewer than ``bs`` examples,
gradient clipping), ``FederatedTrainer(use_engine=False)`` under LROA and
DivFL on ``tests/test_round_engine.py``'s testbed (equal selections,
DivFL's included, losses, params, queues and DivFL's update bank within
1e-4), ``accuracy_curve``, the port's fused path against its sequential
one at equal client sizes (losses 1e-5, params 2e-5, as the JAX test
holds its two paths), and ``RoundEngine.round_step_stacked`` bitwise
``round_step``.  The reference's threefry keys are passed in as data."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.optim as jopt  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)

# tests/test_round_engine.py's testbed: 8 clients of 64 examples, K = 2
N, PER_CLIENT, E, BS = 8, 64, 2, 16
TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _testbed(sizes=None, with_test=False):
    sizes = (np.full(N, PER_CLIENT, np.int64) if sizes is None
             else np.asarray(sizes))
    total = int(sizes.sum())
    x, y = synthetic_image_classification(total + 100, (8, 8, 1),
                                          num_classes=4, noise=0.3, seed=3)
    offs = np.cumsum(np.concatenate([[0], sizes]))
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(len(sizes))]
    test = (x[total:], y[total:]) if with_test else None
    return clients, sizes.astype(np.float32), test


class _JaxClientKeys:
    """The JAX sequential path's per-client keys: the trainer key split
    once per client, then ``uniform(split(sub, E)[e], (rows,))``."""

    def __init__(self, seed):
        self.rng = jax.random.PRNGKey(seed)

    def __call__(self, rows):
        self.rng, sub = jax.random.split(self.rng)
        return np.stack([np.asarray(jax.random.uniform(ek, (rows,)))
                         for ek in jax.random.split(sub, E)])


def _trainers(name, seed=0, with_test=False, rounds=3):
    clients, sizes, test = _testbed(with_test=with_test)
    sp = jc.paper_default_params(num_devices=N, data_sizes=sizes)
    tp = system_params_from_numpy(sp, device="cpu")
    jctl = {"lroa": jc.LROAController, "divfl": jc.DivFLController}[name]
    tctl = {"lroa": tc.LROAController, "divfl": tc.DivFLController}[name]
    jhp = jc.estimate_hyperparams(sp, 0.1, loss_scale=1.5, mu=1.0, nu=1e5)
    thp = tc.estimate_hyperparams(tp, 0.1, loss_scale=1.5, mu=1.0, nu=1e5)
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=32)
    ttask = tm.MLPTask(input_dim=64, num_classes=4, hidden=32)
    jtr = jfl.FederatedTrainer(
        jtask, sp, jctl(sp, jhp),
        jfl.ChannelProcess(N, jfl.ChannelConfig(seed=seed)), clients,
        jfl.ClientConfig(local_epochs=E, batch_size=BS),
        jopt.paper_step_decay(0.1, rounds), test_data=test, eval_every=2,
        seed=seed, use_engine=False)
    ttr = tfl.FederatedTrainer(
        ttask, tp, tctl(tp, thp),
        tfl.ChannelProcess(N, tfl.ChannelConfig(seed=seed)), clients,
        tfl.ClientConfig(local_epochs=E, batch_size=BS),
        topt.paper_step_decay(0.1, rounds), test_data=test, eval_every=2,
        seed=seed, use_engine=False, device="cpu",
        client_keys_fn=_JaxClientKeys(seed))
    ttr.global_params = params_from_jax(
        {n: np.asarray(v) for n, v in jtr.global_params.items()}, ttask,
        device="cpu")
    return jtr, ttr


@pytest.mark.parametrize("name", ["lroa", "divfl"])
def test_sequential_trainer_matches_reference(name):
    jtr, ttr = _trainers(name)
    ttr.warmup()
    for t in range(3):
        jr, tr = jtr.run_round(t), ttr.run_round(t)
        assert tr.selected == jr.selected, t
        np.testing.assert_allclose(tr.mean_loss, jr.mean_loss, atol=TOL,
                                   rtol=TOL)
        for field in ("wall_time", "queue_mean", "energy_mean"):
            np.testing.assert_allclose(getattr(tr, field),
                                       getattr(jr, field), rtol=TOL)
        for n, v in jtr.global_params.items():
            np.testing.assert_allclose(ttr.global_params[n].numpy(),
                                       np.asarray(v), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ttr.controller.queues.numpy(),
                                   np.asarray(jtr.controller.queues),
                                   atol=TOL, rtol=TOL)
    if name == "divfl":
        np.testing.assert_allclose(ttr.controller._update_bank,
                                   jtr.controller._update_bank, atol=TOL)
        assert np.any(ttr.controller._update_bank)


def test_accuracy_curve_matches_reference():
    jtr, ttr = _trainers("lroa", seed=1, with_test=True, rounds=4)
    jres, tres = jtr.run(4), ttr.run(4)
    jcurve, tcurve = jres.accuracy_curve(), tres.accuracy_curve()
    assert [r for r, _, _ in tcurve] == [r for r, _, _ in jcurve] == [0, 2, 3]
    for (_, tcum, tacc), (_, jcum, jacc) in zip(tcurve, jcurve):
        np.testing.assert_allclose(tcum, jcum, rtol=1e-6)
        assert tacc == jacc
    assert tres.total_time == tcurve[-1][1]


@pytest.mark.parametrize("n,max_norm", [(40, 0.0), (10, 0.0), (40, 0.05)],
                         ids=["n_gt_bs", "n_lt_bs", "clipped"])
def test_local_update_matches_reference(n, max_norm):
    clients, _, _ = _testbed(sizes=[n])
    x, y = clients[0]
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=32)
    ttask = tm.MLPTask(input_dim=64, num_classes=4, hidden=32)
    jp = jtask.init(jax.random.PRNGKey(5))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, ttask,
                         device="cpu")
    sub = jax.random.PRNGKey(9)
    rows = max(n, BS)
    keys = np.stack([np.asarray(jax.random.uniform(ek, (rows,)))
                     for ek in jax.random.split(sub, E)])
    jd, jl = jfl.local_update(jtask, jp, x, y, 0.1, sub,
                              jfl.ClientConfig(local_epochs=E, batch_size=BS,
                                               max_grad_norm=max_norm))
    td, tl = tfl.local_update(ttask, tp, x, y, 0.1,
                              tfl.ClientConfig(local_epochs=E, batch_size=BS,
                                               max_grad_norm=max_norm),
                              sort_keys=keys)
    assert isinstance(tl, float)
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    for k, v in jd.items():
        np.testing.assert_allclose(td[k].numpy(), np.asarray(v), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    if max_norm:
        free, _ = tfl.local_update(ttask, tp, x, y, 0.1,
                                   tfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS),
                                   sort_keys=keys)
        assert max(float((free[k] - td[k]).abs().max()) for k in td) > 1e-3


class _NumpyKeys:
    """One numpy stream of f64 uniforms read as ``[count, E, rows]`` by
    the fused path or ``[E, rows]`` per client by the sequential one: the
    same keys in the same order."""

    def __init__(self, seed, rows):
        self.rng = np.random.default_rng(seed)
        self.rows = rows

    def fused(self, count):
        return self.rng.random((count, E, self.rows)).astype(np.float32)

    def client(self, rows):
        return self.rng.random((E, rows)).astype(np.float32)


@pytest.mark.parametrize("name", ["lroa", "divfl"])
def test_port_fused_matches_port_sequential(name):
    """Equal client sizes, no padding: the fused round reproduces the
    sequential one up to f32 reduction order (the JAX package's own
    test holds its two paths to the same bounds).  DivFL selects by its
    channel-feature gram on the fused path, so only LROA's selections
    and DivFL's first round are compared."""
    clients, sizes, _ = _testbed()
    runs = []
    for use_engine in (True, False):
        tp = tc.paper_default_params(num_devices=N, data_sizes=sizes,
                                     device="cpu")
        hp = tc.estimate_hyperparams(tp, 0.1, loss_scale=1.5, mu=1.0,
                                     nu=1e5)
        ctl = {"lroa": tc.LROAController, "divfl": tc.DivFLController}[name]
        keys = _NumpyKeys(11, PER_CLIENT)
        tr = tfl.FederatedTrainer(
            tm.MLPTask(input_dim=64, num_classes=4, hidden=32), tp,
            ctl(tp, hp), tfl.ChannelProcess(N), clients,
            tfl.ClientConfig(local_epochs=E, batch_size=BS),
            topt.constant(0.1), seed=0, use_engine=use_engine,
            device="cpu", sort_keys_fn=keys.fused,
            client_keys_fn=keys.client)
        rounds = 4 if name == "lroa" else 1
        runs.append(tr.run(rounds))
    fast, slow = runs
    for a, b in zip(fast.records, slow.records):
        assert a.selected == b.selected
        assert a.mean_loss == pytest.approx(b.mean_loss, abs=1e-5)
    for n in fast.params:
        np.testing.assert_allclose(fast.params[n].numpy(),
                                   slow.params[n].numpy(), atol=2e-5)


def test_round_step_stacked_is_bitwise_round_step():
    clients, _, _ = _testbed(sizes=[64, 40, 10, 64, 33, 17])
    cfg = tfl.ClientConfig(local_epochs=E, batch_size=BS)
    engine = tfl.RoundEngine(tm.CNNTask(image_shape=(8, 8, 1),
                                        num_classes=4, width=4), cfg,
                             device="cpu")
    bank = engine.make_bank(clients, tiered="single")
    params = engine.task.init(torch.Generator().manual_seed(2))
    keys = torch.rand((3, E, bank.bucket_examples),
                      generator=torch.Generator().manual_seed(3))
    coeffs = np.asarray([0.5, 0.3, 0.2], np.float32)
    for sel in (np.asarray([2, 0, 4]), np.asarray([0, 3, 0])):
        xs, ys, ns, ne = bank.gather_host(sel)
        got, gl = engine.round_step_stacked(params, xs, ys, coeffs, 0.1,
                                            keys, ns, ne)
        want, wl = engine.round_step(params, bank, sel, coeffs, 0.1, keys)
        assert torch.equal(gl, wl)
        for n in want:
            assert torch.equal(got[n], want[n]), n


def test_sequential_warmup_changes_no_state():
    clients, sizes, _ = _testbed(sizes=[64, 10, 40, 64, 12, 33, 20, 64])
    tp = tc.paper_default_params(num_devices=N, data_sizes=sizes,
                                 device="cpu")
    tr = tfl.FederatedTrainer(
        tm.MLPTask(input_dim=64, num_classes=4, hidden=8), tp,
        tc.DivFLController(tp), tfl.ChannelProcess(N), clients,
        tfl.ClientConfig(local_epochs=E, batch_size=BS), topt.constant(0.1),
        use_engine=False, device="cpu")
    before = {n: v.clone() for n, v in tr.global_params.items()}
    state = tr._key_gen.get_state()
    tr.warmup()
    assert torch.equal(tr._key_gen.get_state(), state)
    assert tr.controller._update_bank is None
    for n, v in before.items():
        assert torch.equal(tr.global_params[n], v)
    rec = tr.run_round(0)
    assert np.isfinite(rec.mean_loss) and len(rec.selected) == 2
    assert tr.controller._update_bank is not None
