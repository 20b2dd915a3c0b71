"""The frozen reference held against the port's CPU path at a tiny size:
its draws, its controllers and slot rules, its models and its local SGD
give what ``repro_torch`` gives on the same inputs."""

import numpy as np
import pytest
import torch

from fedbench.reference import control as rc
from fedbench.reference import draws as rd
from fedbench.reference import train as rt

SYSTEM = {"bandwidth_hz": 1.0e6, "noise_power_w": 0.01,
          "model_bits": 357514944.0, "cycles_per_sample": 3.0e9,
          "capacitance": 2.0e-28, "energy_budget_j": 15.0,
          "f_min_hz": 1.0e9, "f_max_hz": 2.0e9, "p_min_w": 1.0e-3,
          "p_max_w": 0.1}


def test_draws_are_the_programs():
    from repro_torch.core import draws as pd
    from repro_torch.sim.arena import ScenarioGrid, scenario_keys

    x = np.asarray([0, 1, 2 ** 40 + 3, 2 ** 62 - 1], np.int64)
    assert np.array_equal(
        rd.splitmix64(x).view(np.int64),
        pd.splitmix64(torch.as_tensor(x)).numpy())
    grid = ScenarioGrid.create(["lroa"], [7, 2 ** 32 - 1], 1.0, 1.0)
    keys = scenario_keys(grid)[1].numpy()
    for seed, key in zip(grid.seed, keys):
        assert int(rd.rollout_key(int(seed))) == int(key)
    key = rd.rollout_key(11)
    tk = torch.as_tensor(np.int64(key))
    u = pd.uniform_f64(pd.fold(pd.round_key(tk, 5, pd.SELECT_STREAM),
                               torch.arange(8)))
    assert np.array_equal(rd.slot_uniforms(key, 5, 8), u.numpy())
    ek = pd.epoch_keys(pd.round_key(tk, 5, pd.CLIENT_STREAM),
                       torch.arange(3), 2, 40)
    for slot in range(3):
        assert np.array_equal(rd.epoch_order_keys(key, 5, slot, 2, 40),
                              ek[slot].numpy())


def _system(n=12, k=3, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 400, n).astype(np.float64)
    return sizes, rng.uniform(0.01, 0.5, n), rng.uniform(0, 40, n)


@pytest.mark.parametrize("name", ["lroa", "uni_d", "uni_s", "divfl"])
def test_controllers_decide_and_select_as_the_program(name):
    from repro_torch.core import paper_default_params
    from repro_torch.core import policy as pol

    sizes, h, queues = _system()
    k, V, lam = 3, 11180.8, 4368.9
    sp = paper_default_params(num_devices=12, sample_count=k,
                              local_epochs=2,
                              data_sizes=sizes.astype(np.float32),
                              device="cpu")
    kv = torch.full((12,), float(k))
    f32 = lambda v: torch.as_tensor(np.float32(v))  # noqa: E731
    dec = pol.decide_by_id(pol.POLICY_IDS[name], sp, f32(h), f32(queues),
                           torch.full((12,), np.float32(V)),
                           torch.full((12,), np.float32(lam)), k=kv)
    sys64 = rc.System.from_config(SYSTEM, sizes, k, 2)
    f, p, q = rc.decide(name, sys64, torch.as_tensor(h),
                        torch.as_tensor(queues), float(np.float32(V)),
                        float(np.float32(lam)))
    for got, want in ((dec.f, f), (dec.p, p), (dec.q, q)):
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=2e-3)
    key = rd.rollout_key(3)
    u = rd.slot_uniforms(key, 4, k)
    select_key = torch.as_tensor(
        rd.round_key(key, 4, rd.SELECT_STREAM).view(np.int64))
    sel = pol.select_by_id(pol.POLICY_IDS[name], sp, 4, f32(h),
                           f32(queues), dec.q, select_key,
                           torch.arange(k), kv).numpy()
    assert rc.selection_gap(name, sys64, q, torch.as_tensor(h), u,
                            sel) < 1e-5
    assert np.array_equal(rc.select(name, sys64, q, torch.as_tensor(h), u),
                          sel)


@pytest.mark.parametrize("task", ["cnn"])
def test_models_are_the_programs(task):
    from repro_torch.models import CNNTask

    model = {"task": task, "image_shape": [8, 8, 3], "num_classes": 5,
             "width": 4}
    prog = CNNTask((8, 8, 3), 5, 4)
    params = rt.init_params(model, torch.Generator().manual_seed(1))
    x = torch.randn(6, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    want = prog.logits(params, prog.device_layout(x))
    torch.testing.assert_close(rt.forward(model, params, x), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [5, 16, 41])
def test_local_sgd_is_the_programs(n):
    from repro_torch.fl.client import ClientConfig, batched_local_sgd
    from repro_torch.models import CNNTask

    model = {"task": "cnn", "image_shape": [8, 8, 3], "num_classes": 5,
             "width": 4}
    prog = CNNTask((8, 8, 3), 5, 4)
    params = rt.init_params(model, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    x = torch.randn(n, 8, 8, 3, generator=g)
    y = torch.randint(0, 5, (n,), generator=g)
    rows = 16 * (1 << max(-(-n // 16) - 1, 0).bit_length())
    keys = rd.epoch_order_keys(rd.rollout_key(9), 2, 0, 2, rows)
    tiled = torch.arange(rows) % n
    deltas, losses = batched_local_sgd(
        prog.loss_fn, params, prog.device_layout(x[tiled])[None],
        y[tiled][None], 0.1, ClientConfig(2, 16, 0.9), rows // 16,
        num_steps=torch.as_tensor([max(n // 16, 1)]),
        num_examples=torch.as_tensor([n]),
        sort_keys=torch.as_tensor(keys)[None])
    delta, loss = rt.local_sgd(model, params, x, y, keys, 0.1, 16, 0.9)
    for k in params:
        torch.testing.assert_close(delta[k], deltas[k][0], rtol=1e-4,
                                   atol=1e-6)
    assert loss == pytest.approx(float(losses[0]), rel=1e-5)


@pytest.mark.parametrize("cell", ["cnn-cifar10.paper4x28"])
def test_a_toy_run_agrees_with_the_reference(cell, toy):
    got = toy(cell)["numbers"]
    assert got["decide_gap"] < 1e-5
    assert got["select_gap"] < 1e-6
    assert got["update_gap"] < 1e-4
    assert got["update_norm_gap"] < 1e-5
    assert got["loss_gap"] < 1e-5
    assert got["eval_gap"] < 1e-5
