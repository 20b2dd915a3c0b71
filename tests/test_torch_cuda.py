"""Tests that need a CUDA card (marked ``cuda``; they skip without one).

They import no JAX, so the GPU machine runs them on their own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

The hand-written CUDA kernel is held against its plain PyTorch version
(``kernels/ref.py``, which ``test_torch_aggregate.py`` holds against the
JAX package), and a short trainer run on the card against the same run on
the CPU.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the sweep of tests/test_kernels.py, the slice's CNN, and a tiny ragged N
CASES = [(1000, 2), (4096, 6), (333, 1), (65_537, 3), (129, 1),
         (545_002, 8), (7, 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, k, seed, dtype, device):
    rng = np.random.default_rng(seed)
    theta = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    deltas = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32))
    c = rng.normal(size=k)
    coeffs = torch.as_tensor((np.exp(c) / np.exp(c).sum()).astype(np.float32))
    return (theta.to(device, DTYPES[dtype]), deltas.to(device, DTYPES[dtype]),
            coeffs.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda, dtype):
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref
    for n, k in CASES:
        theta, deltas, coeffs = _inputs(n, k, n + k, dtype, cuda)
        before = dict(fk.LAUNCHES)
        out = fk.fl_aggregate_cuda(theta, deltas, coeffs)
        red = fk.fl_delta_reduce_cuda(deltas, coeffs)
        torch.cuda.synchronize()
        assert fk.LAUNCHES["fl_aggregate"] == before["fl_aggregate"] + 1
        assert fk.LAUNCHES["fl_delta_reduce"] == before["fl_delta_reduce"] + 1
        assert out.dtype == theta.dtype and red.dtype == torch.float32
        torch.testing.assert_close(
            out.float(), ref.aggregate_reference(theta, deltas,
                                                 coeffs).float(),
            atol=TOL[dtype], rtol=TOL[dtype])
        torch.testing.assert_close(
            red, ref.delta_reduce_reference(deltas, coeffs),
            atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_kernel_mixed_dtypes_and_bad_inputs(cuda):
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref
    theta, deltas, coeffs = _inputs(5003, 4, 1, "float32", cuda)
    for t, d in ((theta, deltas.bfloat16()), (theta.bfloat16(), deltas)):
        torch.testing.assert_close(
            fk.fl_aggregate_cuda(t, d, coeffs).float(),
            ref.aggregate_reference(t, d, coeffs).float(), atol=2e-2,
            rtol=2e-2)
    # a theta 4 or 8 bytes off a 16-byte boundary narrows the vector
    # loads (scalar, then 2-wide); every width must agree
    theta, deltas, coeffs = _inputs(4096, 3, 2, "float32", cuda)
    for off in (1, 2):
        shifted = torch.zeros(4096 + off, device=cuda)[off:]
        shifted.copy_(theta)
        torch.testing.assert_close(
            fk.fl_aggregate_cuda(shifted, deltas, coeffs),
            ref.aggregate_reference(theta, deltas, coeffs))
    with pytest.raises(ValueError, match="contiguous"):
        fk.fl_aggregate_cuda(theta, deltas.t().contiguous().t(), coeffs)
    with pytest.raises(ValueError, match="coeffs"):
        fk.fl_aggregate_cuda(theta, deltas, coeffs.double())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.fl_aggregate_cuda(theta.cpu(), deltas, coeffs)
    with pytest.raises(ValueError, match="theta"):
        fk.fl_aggregate_cuda(theta[:-1].contiguous(), deltas, coeffs)


@pytest.mark.cuda
def test_trainer_on_the_card_matches_the_cpu(cuda):
    """Three LROA rounds on the card (CUDA kernel, cuDNN) against the CPU
    path, with the same data, init and epoch keys: the check that
    ``chip_smoke.py`` runs, loaded from the repo root."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_reference()
