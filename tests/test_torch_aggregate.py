"""The port's eq.-(4) aggregation against the JAX package's Pallas kernel.

On the CPU the port's wrappers take their plain PyTorch path; it is held
against ``fl_aggregate_tpu`` run in interpret mode on the sweep of
``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2).  ``test_torch_cuda.py``
holds the hand-written CUDA kernel against that plain path on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fl import ParamRavel as JaxParamRavel  # noqa: E402
from repro.fl import aggregate_stacked as jax_aggregate_stacked  # noqa: E402
from repro.kernels.fl_aggregate import fl_aggregate_tpu  # noqa: E402
from repro_torch.fl import server  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SWEEP = [(1000, 2, 256), (4096, 6, 512), (333, 1, 128), (65_537, 3, 65_536),
         (129, 1, 256)]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(n, k, seed):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=n).astype(np.float32)
    deltas = rng.normal(size=(k, n)).astype(np.float32)
    c = rng.normal(size=k)
    coeffs = (np.exp(c) / np.exp(c).sum()).astype(np.float32)
    return theta, deltas, coeffs


def _both(a, dtype):
    """The same values in both packages (bf16 rounds f32 to nearest even
    on both sides)."""
    return (jnp.asarray(a).astype(jnp.dtype(dtype)),
            torch.as_tensor(a).to(TORCH_DTYPES[dtype]))


@pytest.mark.parametrize("n,k,block", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fl_aggregate_matches_pallas_interpret(n, k, block, dtype):
    theta, deltas, coeffs = _inputs(n, k, seed=n * 7 + k)
    tj, tt = _both(theta, dtype)
    dj, dt = _both(deltas, dtype)
    want = fl_aggregate_tpu(tj, dj, jnp.asarray(coeffs), block=block,
                            interpret=True)
    got = ops.fl_aggregate(tt, dt, torch.as_tensor(coeffs))
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (n,)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("n,k,block", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fl_delta_reduce_matches_pallas_interpret(n, k, block, dtype):
    """The theta-less reduce: on a TPU the JAX package runs the same
    kernel against a zero f32 theta."""
    _, deltas, coeffs = _inputs(n, k, seed=n * 11 + k)
    dj, dt = _both(deltas, dtype)
    want = fl_aggregate_tpu(jnp.zeros((n,), jnp.float32), dj,
                            jnp.asarray(coeffs), block=block, interpret=True)
    got = ops.fl_delta_reduce(dt, torch.as_tensor(coeffs))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _params_and_deltas(k=3, seed=5):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(13, 7)), "b": np.zeros(7),
              "head": rng.normal(size=(7, 3))}
    params = {n: v.astype(np.float32) for n, v in params.items()}
    deltas = {n: rng.normal(size=(k,) + v.shape).astype(np.float32)
              for n, v in params.items()}
    c = rng.normal(size=k)
    return params, deltas, (np.exp(c) / np.exp(c).sum()).astype(np.float32)


def _torch(tree):
    return {n: torch.as_tensor(v) for n, v in tree.items()}


def test_aggregate_fused_matches_reference_stacked():
    """The fused entry point (CPU: per-leaf) against the JAX package's
    ``aggregate_stacked``."""
    params, deltas, coeffs = _params_and_deltas()
    want = jax_aggregate_stacked(
        {n: jnp.asarray(v) for n, v in params.items()},
        {n: jnp.asarray(v) for n, v in deltas.items()}, jnp.asarray(coeffs))
    got = server.aggregate_fused(_torch(params), _torch(deltas),
                                 torch.as_tensor(coeffs))
    assert set(got) == set(params)
    for name in params:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=2e-5, rtol=2e-5)


def test_param_ravel_matches_reference_and_feeds_the_flat_kernel():
    """``ParamRavel`` lays the model out as the JAX adapter does, and the
    flat path the card takes (ravel -> eq. (4) on [N] -> unravel) agrees
    with the Pallas kernel on the JAX ravel."""
    params, deltas, coeffs = _params_and_deltas(k=4, seed=9)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jd = {n: jnp.asarray(v) for n, v in deltas.items()}
    jad, tad = JaxParamRavel(jp), server.ParamRavel(_torch(params))
    theta, flat = tad.ravel(_torch(params)), tad.ravel_stacked(_torch(deltas))
    assert tad.total == jad.total == theta.shape[0]
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jad.ravel(jp)))
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jad.ravel_stacked(jd)))
    want = jad.unravel(fl_aggregate_tpu(jad.ravel(jp), jad.ravel_stacked(jd),
                                        jnp.asarray(coeffs), block=64,
                                        interpret=True))
    got = tad.unravel(ref.aggregate_reference(theta, flat,
                                              torch.as_tensor(coeffs)))
    for name in params:
        assert got[name].shape == params[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=2e-5, rtol=2e-5)


def test_fedavg_reference_normalises_weights():
    params, deltas, _ = _params_and_deltas(k=3, seed=1)
    listed = [{n: torch.as_tensor(v[i]) for n, v in deltas.items()}
              for i in range(3)]
    w = np.asarray([1.0, 2.0, 5.0], np.float32)
    got = server.fedavg_reference(_torch(params), listed, w)
    for name, p in params.items():
        want = p + np.tensordot(w / w.sum(), deltas[name], axes=1)
        np.testing.assert_allclose(got[name].numpy(), want, atol=2e-5)


def test_cuda_impl_on_cpu_tensors_raises():
    theta, deltas, coeffs = (torch.as_tensor(a) for a in _inputs(64, 2, 0))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.fl_aggregate(theta, deltas, coeffs, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.fl_delta_reduce(deltas, coeffs, impl="cuda")
    params, stacked, c = _params_and_deltas()
    with pytest.raises(ValueError, match="impl='cuda'"):
        server.aggregate_fused(_torch(params), _torch(stacked),
                               torch.as_tensor(c), impl="cuda")


def test_dispatch_predicate():
    cpu = torch.device("cpu")
    assert not ops.use_cuda_kernel("auto", cpu)
    assert not ops.use_cuda_kernel("ref", cpu)
    assert ops.use_cuda_kernel("auto", torch.device("cuda"))
    assert ops.use_cuda_kernel("cuda", torch.device("cuda"))
    with pytest.raises(ValueError, match="impl='ref'"):
        ops.use_cuda_kernel("ref", torch.device("cuda"))
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.use_cuda_kernel("pallas", cpu)


def test_kernel_wrapper_without_a_card_raises():
    """No quiet fallback: asking for the CUDA kernel where torch sees no
    card fails at the build."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
    theta, deltas, coeffs = (torch.as_tensor(a) for a in _inputs(64, 2, 0))
    with pytest.raises(RuntimeError, match="CUDA device"):
        fl_aggregate_cuda(theta, deltas, coeffs)
