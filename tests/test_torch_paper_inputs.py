"""The paper's Sec.-VII experiment inputs in the port, bitwise against the
JAX package: the FEMNIST-like ``writer_partition`` and ``partition_stats``
over several seeds, ``heterogeneous_params`` (spreads 1 and 4) and
``SystemParams.per_device_bandwidth``, ``ChannelProcess.stream``, and
DivFL's update sketch ``flatten_update`` on CNN, ResNet and MLP deltas
(the port ravels its OIHW / (c, h, w) leaves in the JAX layout first);
then the list API ``server.aggregate`` and the CPU form of
``ops.fl_aggregate_pytree`` against the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.data as jd  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.kernels.ops as jops  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.data as td  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)
from repro_torch.kernels import ops as tops  # noqa: E402

FIELDS = ("cycles_per_sample", "data_sizes", "capacitance", "energy_budget",
          "f_min", "f_max", "p_min", "p_max")


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {}), (5, dict(samples_per_writer=(5, 40),
                               label_profile_size=4))])
def test_writer_partition_and_stats_are_bitwise(seed, kw):
    _, y = td.synthetic_image_classification(3000, (4, 4, 1), 62, seed=seed)
    got = td.writer_partition(y, 30, seed=seed, **kw)
    want = jd.writer_partition(y, 30, seed=seed, **kw)
    assert len(got) == len(want) == 30
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    lo, hi = kw.get("samples_per_writer", (50, 400))
    assert all(len(p) <= hi for p in got)
    assert all(len(np.unique(y[p])) <= kw.get("label_profile_size", 12)
               for p in got)
    gs, ws = td.partition_stats(got, y), jd.partition_stats(want, y)
    np.testing.assert_array_equal(gs["sizes"], ws["sizes"])
    assert gs["mean_tv_distance"] == ws["mean_tv_distance"]
    assert gs["max_tv_distance"] == ws["max_tv_distance"]
    dparts = td.dirichlet_partition(y, 30, 0.5, seed=seed)
    assert td.partition_stats(dparts, y)["mean_tv_distance"] == \
        jd.partition_stats(dparts, y)["mean_tv_distance"]


@pytest.mark.parametrize("spreads", [(1.0, 1.0, 1.0), (4.0, 4.0, 1.0),
                                     (4.0, 2.0, 3.0)],
                         ids=["spread1", "spread4", "mixed"])
def test_heterogeneous_params_are_bitwise(spreads):
    sizes = np.random.default_rng(0).integers(200, 600, 40).astype(
        np.float32)
    base = jc.paper_default_params(num_devices=40, data_sizes=sizes,
                                   sample_count=4)
    tbase = system_params_from_numpy(base, device="cpu")
    f, c, b = spreads
    want = jfl.heterogeneous_params(base, jfl.HeterogeneityConfig(
        cpu_speed_spread=f, cycles_spread=c, budget_spread=b, seed=7))
    got = tfl.heterogeneous_params(tbase, tfl.HeterogeneityConfig(
        cpu_speed_spread=f, cycles_spread=c, budget_spread=b, seed=7))
    assert got.device == tbase.device
    for name in FIELDS:
        g = getattr(got, name)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(getattr(want, name)), name)
    if f > 1:
        assert not np.array_equal(got.f_max.numpy(), tbase.f_max.numpy())
        assert bool(torch.all(got.f_min <= got.f_max))
    assert got.per_device_bandwidth == want.per_device_bandwidth == 2.5e5
    assert tbase.per_device_bandwidth == base.per_device_bandwidth


def test_channel_stream_is_the_reference_stream():
    tstream = tfl.ChannelProcess(9, tfl.ChannelConfig(seed=4)).stream()
    jstream = jfl.ChannelProcess(9, jfl.ChannelConfig(seed=4)).stream()
    for _ in range(4):
        np.testing.assert_array_equal(next(tstream), next(jstream))


def _deltas(jtask, ttask, seed):
    """A random update in the JAX layout and the same in the port's."""
    shapes = jax.eval_shape(jtask.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    jd_ = {n: rng.standard_normal(s.shape).astype(np.float32) * 1e-2
           for n, s in shapes.items()}
    return jd_, params_from_jax(jd_, ttask, device="cpu")


@pytest.mark.parametrize("kind", ["cnn", "resnet", "mlp"])
def test_flatten_update_is_bitwise(kind):
    jtask, ttask = {
        "cnn": (jm.CNNTask(image_shape=(8, 12, 1), num_classes=4, width=4),
                tm.CNNTask(image_shape=(8, 12, 1), num_classes=4, width=4)),
        "resnet": (jm.ResNetTask(image_shape=(8, 8, 3), width=4),
                   tm.ResNetTask(image_shape=(8, 8, 3), width=4)),
        "mlp": (jm.MLPTask(input_dim=20, hidden=8),
                tm.MLPTask(input_dim=20, hidden=8))}[kind]
    jd_, td_ = _deltas(jtask, ttask, 3)
    for proj_dim, seed in ((256, 0), (64, 5)):
        want = jfl.flatten_update(jd_, proj_dim=proj_dim, seed=seed)
        got = tfl.flatten_update(td_, ttask, proj_dim=proj_dim, seed=seed)
        assert got.dtype == np.float32 and got.shape == (proj_dim,)
        np.testing.assert_array_equal(got, want)


def _stacked(k=3, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32),
              "c": rng.standard_normal((2, 3, 4, 4)).astype(np.float32)}
    deltas = [{n: rng.standard_normal(v.shape).astype(np.float32)
               for n, v in params.items()} for _ in range(k)]
    coeffs = rng.dirichlet(np.ones(k)).astype(np.float32)
    return params, deltas, coeffs


def _port(tree):
    return {n: torch.as_tensor(v) for n, v in tree.items()}


def test_aggregate_list_api_matches_reference():
    params, deltas, coeffs = _stacked()
    want = jfl.aggregate({n: jnp.asarray(v) for n, v in params.items()},
                         [{n: jnp.asarray(v) for n, v in d.items()}
                          for d in deltas], coeffs)
    got = tfl.aggregate(_port(params), [_port(d) for d in deltas], coeffs)
    stacked = tfl.aggregate_stacked(
        _port(params), tfl.stack_deltas([_port(d) for d in deltas]),
        torch.as_tensor(coeffs))
    for n, v in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(v), atol=2e-6)
        assert torch.equal(got[n], stacked[n])


def test_fl_aggregate_pytree_cpu_form_matches_reference():
    params, deltas, coeffs = _stacked(k=4, seed=1)
    stacked = {n: np.stack([d[n] for d in deltas]) for n in params}
    want = jops.fl_aggregate_pytree(
        {n: jnp.asarray(v) for n, v in params.items()},
        {n: jnp.asarray(v) for n, v in stacked.items()},
        jnp.asarray(coeffs), impl="pallas")
    got = tops.fl_aggregate_pytree(_port(params), _port(stacked),
                                   torch.as_tensor(coeffs))
    plain = tops.fl_aggregate_pytree(_port(params), _port(stacked),
                                     torch.as_tensor(coeffs), impl="ref")
    for n, v in want.items():
        assert got[n].shape == params[n].shape
        np.testing.assert_allclose(got[n].numpy(), np.asarray(v), atol=2e-5,
                                   rtol=2e-5)
        assert torch.equal(got[n], plain[n])
    with pytest.raises(ValueError, match="CUDA"):
        tops.fl_aggregate_pytree(_port(params), _port(stacked),
                                 torch.as_tensor(coeffs), impl="cuda")
