"""The port's control plane (system model, queues, Algorithm 2, the LROA
controller) against the JAX package on the same numpy inputs, at N = 16
(``conftest.make_params``), rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from conftest import make_params  # noqa: E402
from repro_torch.convert import system_params_from_numpy  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _gains(n, seed):
    rng = np.random.default_rng(seed)
    return np.clip(rng.exponential(0.1, n), 0.01, 0.5).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.cpu() if hasattr(got, "cpu")
                                          else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def test_system_params_convert_and_validate():
    sp = make_params(16)
    tp = system_params_from_numpy(sp, device="cpu")
    assert tp.num_devices == 16 and tp.device.type == "cpu"
    _close(tp.data_weights, sp.data_weights)
    with pytest.raises(ValueError, match="shape"):
        tc.SystemParams(**{**{f: getattr(tp, f) for f in (
            "num_devices", "sample_count", "local_epochs", "bandwidth_hz",
            "noise_power", "model_bits", "download_rate")},
            **{f: getattr(tp, f) for f in tc.system_model.ARRAY_FIELDS},
            "f_min": torch.ones(3)})
    built = tc.paper_default_params(num_devices=16, sample_count=2,
                                    data_sizes=np.asarray(sp.data_sizes),
                                    device="cpu")
    for name in tc.system_model.ARRAY_FIELDS:
        _close(getattr(built, name), getattr(sp, name), rtol=0)


@pytest.mark.parametrize("fn", ["round_time", "round_time_download",
                                "round_energy", "expected_energy",
                                "expected_round_latency",
                                "selection_probability"])
def test_system_model_equations(fn):
    sp = make_params(16, seed=3)
    tp = system_params_from_numpy(sp, device="cpu")
    rng = np.random.default_rng(4)
    h = _gains(16, 5)
    f = rng.uniform(1e9, 2e9, 16).astype(np.float32)
    p = rng.uniform(1e-3, 0.1, 16).astype(np.float32)
    q = rng.dirichlet(np.ones(16)).astype(np.float32)
    if fn == "round_time":
        want = jc.round_time(sp, jnp.asarray(h), jnp.asarray(p),
                             jnp.asarray(f))
        got = tc.round_time(tp, *map(torch.as_tensor, (h, p, f)))
    elif fn == "round_time_download":
        want = jc.round_time(sp, jnp.asarray(h), jnp.asarray(p),
                             jnp.asarray(f), include_download=True)
        got = tc.round_time(tp, *map(torch.as_tensor, (h, p, f)),
                            include_download=True)
    elif fn == "expected_round_latency":
        t = jc.round_time(sp, jnp.asarray(h), jnp.asarray(p), jnp.asarray(f))
        want = jc.expected_round_latency(jnp.asarray(q), t)
        got = tc.expected_round_latency(torch.as_tensor(q),
                                        torch.tensor(np.asarray(t)))
    elif fn == "round_energy":
        want = jc.round_energy(sp, jnp.asarray(h), jnp.asarray(p),
                               jnp.asarray(f))
        got = tc.round_energy(tp, *map(torch.as_tensor, (h, p, f)))
    elif fn == "expected_energy":
        want = jc.expected_energy(sp, *map(jnp.asarray, (h, p, f, q)))
        got = tc.expected_energy(tp, *map(torch.as_tensor, (h, p, f, q)))
    else:
        want = jc.selection_probability(jnp.asarray(q), 2)
        got = tc.selection_probability(torch.as_tensor(q), 2)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_p2_matches_reference(seed):
    sp = make_params(16, seed=seed)
    tp = system_params_from_numpy(sp, device="cpu")
    h = _gains(16, seed + 10)
    queues = np.random.default_rng(seed + 20).uniform(
        0.0, 400.0, 16).astype(np.float32)
    queues[::5] = 0.0          # zero energy pressure on some devices
    hp = jc.estimate_hyperparams(sp, 0.1, loss_scale=1.5)
    want = jc.solve_p2(sp, jnp.asarray(h), jnp.asarray(queues), hp.V, hp.lam)
    got = tc.solve_p2(tp, torch.as_tensor(h), torch.as_tensor(queues),
                      hp.V, hp.lam)
    for g, w in zip(got, want):
        _close(g, w)
    assert abs(float(got.q.sum()) - 1.0) < 1e-5


def test_solver_components_match_reference():
    sp = make_params(16, seed=7)
    tp = system_params_from_numpy(sp, device="cpu")
    h = _gains(16, 8)
    q = np.random.default_rng(9).dirichlet(np.ones(16)).astype(np.float32)
    queues = np.random.default_rng(10).uniform(1.0, 300.0, 16).astype(
        np.float32)
    V, lam = 7.0e4, 2.0e3
    jh, jq, jqu = map(jnp.asarray, (h, q, queues))
    th, tq, tqu = map(torch.as_tensor, (h, q, queues))
    f_w = jc.solve_f(sp, jq, jqu, V)
    _close(tc.solve_f(tp, tq, tqu, V), f_w)
    p_w = jc.solve_p(sp, jq, jqu, jh, V)
    _close(tc.solve_p(tp, tq, tqu, th, V), p_w)
    t = jc.round_time(sp, jh, p_w, f_w)
    e = jc.round_energy(sp, jh, p_w, f_w)
    q_w = jc.solve_q(sp, t, e, jqu, V, lam, jq)
    q_g = tc.solve_q(tp, torch.tensor(np.asarray(t)),
                     torch.tensor(np.asarray(e)), tqu, V, lam, tq)
    _close(q_g, q_w)


def test_estimate_hyperparams_matches_reference():
    sp = make_params(16)
    want = jc.estimate_hyperparams(sp, 0.1, loss_scale=1.5, mu=2.0, nu=1e4)
    got = tc.estimate_hyperparams(
        system_params_from_numpy(sp, device="cpu"), 0.1, loss_scale=1.5,
        mu=2.0, nu=1e4)
    for name in ("lam", "V", "lam0", "V0", "mu", "nu"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=RTOL)


def test_queue_trajectory_matches_reference():
    """20 rounds of decide -> step_queues on the same channel draws."""
    sp = make_params(16)
    tp = system_params_from_numpy(sp, device="cpu")
    jctl = jc.LROAController(sp, jc.estimate_hyperparams(sp, 0.1, 1.5))
    tctl = tc.LROAController(tp, tc.estimate_hyperparams(tp, 0.1, 1.5))
    rng = np.random.default_rng(1)
    for t in range(20):
        h = np.clip(rng.exponential(0.1, 16), 0.01, 0.5).astype(np.float32)
        jd = jctl.decide(jnp.asarray(h))
        td = tctl.decide(torch.as_tensor(h))
        for g, w in zip(td, jd):
            _close(g, w)
        jctl.step_queues(jnp.asarray(h), jd)
        tctl.step_queues(torch.as_tensor(h), td)
        _close(tctl.queues, jctl.queues, atol=1e-3)
        sel = np.asarray([t % 16, (3 * t) % 16, 5])
        np.testing.assert_allclose(
            tc.realized_round_time(tp, torch.as_tensor(h), td, sel),
            jc.realized_round_time(sp, jnp.asarray(h), jd, sel), rtol=RTOL)
    assert float(tctl.queues.max()) > 0.0
