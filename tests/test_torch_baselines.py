"""The port's host controllers (``repro_torch.core.baselines``, the LROA
controller's statistics) against ``repro.core``'s over several rounds of
the same channel draws — decisions and queues within rtol 1e-5, DivFL's
picks equal — and ``FederatedTrainer`` under Uni-D, Uni-S and DivFL
against the JAX trainer for 3 rounds with the reference's epoch keys
(N = 6, K = 3, ``bank_mode='single'``, a width-4 CNN): selections equal,
losses, params and queues within 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.optim as jopt  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
from conftest import make_params  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)
from test_torch_trainer import _JaxEpochKeys, _testbed  # noqa: E402

RTOL = 1e-5
TOL = 1e-4
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


CONTROLLERS = {
    "uni_d": (jc.UniformDynamicController, tc.UniformDynamicController),
    "uni_s": (jc.UniformStaticController, tc.UniformStaticController),
    "divfl": (jc.DivFLController, tc.DivFLController),
}


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_host_controller_matches_reference(name):
    """Eight rounds of decide -> (DivFL: select) -> step_queues."""
    sp = make_params(N, seed=2)
    tp = system_params_from_numpy(sp, device="cpu")
    jcls, tcls = CONTROLLERS[name]
    jctl = jcls(sp, jc.estimate_hyperparams(sp, 0.1, 1.5))
    tctl = tcls(tp, tc.estimate_hyperparams(tp, 0.1, 1.5))
    assert tctl.name == jctl.name == name
    rng = np.random.default_rng(4)
    for _ in range(8):
        h = np.clip(rng.exponential(0.1, N), 0.01, 0.5).astype(np.float32)
        jd, td = jctl.decide(jnp.asarray(h)), tctl.decide(torch.as_tensor(h))
        for g, w in zip(td, jd):
            _close(g, w)
        if name == "divfl":
            np.testing.assert_array_equal(
                tctl.select(torch.as_tensor(h)), jctl.select(jnp.asarray(h)))
        jctl.step_queues(jnp.asarray(h), jd)
        tctl.step_queues(torch.as_tensor(h), td)
        _close(tctl.queues, jctl.queues, atol=1e-3)
    assert float(tctl.queues.max()) > 0.0


def test_divfl_selection_paths_match_reference():
    """No channel: ``arange(K) % N``; observed update sketches take
    precedence over the channel features."""
    sp = jc.paper_default_params(num_devices=5, sample_count=7,
                                 data_sizes=np.full(5, 100, np.float32))
    tp = system_params_from_numpy(sp, device="cpu")
    jctl, tctl = jc.DivFLController(sp), tc.DivFLController(tp)
    np.testing.assert_array_equal(tctl.select(), jctl.select())
    np.testing.assert_array_equal(tctl.select(), np.arange(7) % 5)
    g = np.random.default_rng(0).normal(size=(3, 9)).astype(np.float32)
    for ctl in (jctl, tctl):
        ctl.observe_updates(np.asarray([0, 2, 4]), g)
    h = np.full(5, 0.1, np.float32)
    np.testing.assert_array_equal(tctl.select(torch.as_tensor(h)),
                                  jctl.select(jnp.asarray(h)))
    np.testing.assert_array_equal(tctl._update_bank, jctl._update_bank)


def test_lroa_statistics_match_reference():
    sp = make_params(N, seed=5)
    tp = system_params_from_numpy(sp, device="cpu")
    for args in ((0.1, 1.5, 2.0, 1e4), (0.2, 1.0, 1.0, 1e5)):
        want = jc.estimate_hyperparams_arrays(sp, *args)
        got = tc.estimate_hyperparams_arrays(tp, *args)
        for g, w in zip(got, want):
            _close(g, w)
    jctl = jc.LROAController(sp, jc.estimate_hyperparams(sp, 0.1, 1.5))
    tctl = tc.LROAController(tp, tc.estimate_hyperparams(tp, 0.1, 1.5))
    rng = np.random.default_rng(6)
    for t in range(4):
        h = np.clip(rng.exponential(0.1, N), 0.01, 0.5).astype(np.float32)
        jd, td = jctl.decide(jnp.asarray(h)), tctl.decide(torch.as_tensor(h))
        js = jctl.round_stats(jnp.asarray(h), jd)
        ts = tctl.round_stats(torch.as_tensor(h), td)
        assert ts.keys() == js.keys()
        for key in js:
            np.testing.assert_allclose(ts[key], js[key], rtol=RTOL,
                                       atol=1e-3, err_msg=key)
        sel = np.asarray([t, (5 * t + 1) % N, t])
        _close(tc.realized_energy(tp, torch.as_tensor(h), td, sel),
               jc.realized_energy(sp, jnp.asarray(h), jd, sel))
        jctl.step_queues(jnp.asarray(h), jd)
        tctl.step_queues(torch.as_tensor(h), td)
    assert len(tctl.history) == 4


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_trainer_with_baseline_matches_reference(name):
    """3 rounds of ``FederatedTrainer`` under a baseline controller:
    Uni-D and Uni-S sample by q from the numpy stream, DivFL picks by its
    greedy on the channel features."""
    k, e, bs, rounds = 3, 2, 8, 3
    n = 6
    clients, sizes = _testbed()
    sp = jc.paper_default_params(num_devices=n, sample_count=k,
                                 local_epochs=e, data_sizes=sizes)
    tp = system_params_from_numpy(sp, device="cpu")
    jtask = jm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4)
    ttask = tm.CNNTask(image_shape=(8, 8, 1), num_classes=4, width=4)
    jcls, tcls = CONTROLLERS[name]
    jtr = jfl.FederatedTrainer(
        jtask, sp, jcls(sp, jc.estimate_hyperparams(sp, 0.1, 1.5)),
        jfl.ChannelProcess(n, jfl.ChannelConfig(seed=1)), clients,
        jfl.ClientConfig(local_epochs=e, batch_size=bs),
        jopt.paper_step_decay(0.1, rounds), seed=2, bank_mode="single")
    rows = jtr.bank.bucket_examples
    ttr = tfl.FederatedTrainer(
        ttask, tp, tcls(tp, tc.estimate_hyperparams(tp, 0.1, 1.5)),
        tfl.ChannelProcess(n, tfl.ChannelConfig(seed=1)), clients,
        tfl.ClientConfig(local_epochs=e, batch_size=bs),
        topt.paper_step_decay(0.1, rounds), seed=2, bank_mode="single",
        device="cpu", sort_keys_fn=_JaxEpochKeys(2, rows))
    ttr.global_params = params_from_jax(
        {p: np.asarray(v) for p, v in jtr.global_params.items()}, ttask,
        device="cpu")
    for t in range(rounds):
        jr, tr = jtr.run_round(t), ttr.run_round(t)
        assert tr.selected == jr.selected
        if name == "divfl":
            assert len(set(tr.selected)) == k
        np.testing.assert_allclose(tr.mean_loss, jr.mean_loss, atol=TOL,
                                   rtol=TOL)
        for field in ("wall_time", "q_min", "q_max", "queue_mean",
                      "energy_mean"):
            np.testing.assert_allclose(getattr(tr, field),
                                       getattr(jr, field), rtol=TOL)
        want = params_from_jax(
            {p: np.asarray(v) for p, v in jtr.global_params.items()}, ttask,
            device="cpu")
        for p, v in want.items():
            np.testing.assert_allclose(ttr.global_params[p].numpy(),
                                       v.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(ttr.controller.queues.numpy(),
                                   np.asarray(jtr.controller.queues),
                                   atol=TOL, rtol=TOL)
