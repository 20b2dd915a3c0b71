"""Tests that need a CUDA card (marked ``cuda``; they skip without one).

They import no JAX, so the GPU machine runs them on their own:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

The hand-written CUDA kernels are held against their plain PyTorch
versions (``kernels/ref.py``, which ``test_torch_aggregate.py`` and
``test_torch_lm_kernels.py`` hold against the JAX package), bad inputs
must raise, and short trainer, rollout and LM serving runs on the card
are held against the same runs on the CPU.
"""

import importlib.util
import pathlib
import sys

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


# the paper-scale CNN's leaves (b1, b2, c1, c2, d1, d2) and ragged ones:
# odd, prime, one past a vector or a tile, and a 0-d leaf
CNN_SHAPES = {"b1": (128,), "b2": (10,), "c1": (32, 3, 3, 3),
              "c2": (64, 32, 3, 3), "d1": (4096, 128), "d2": (128, 10)}
RAGGED_SHAPES = [(1,), (7,), (3, 11), (257,), (5, 13, 2), (1025,), (),
                 (4099,)]


def _leaves(shapes, k, seed, theta_dtype, delta_dtype, device):
    rng = np.random.default_rng(seed)
    thetas = [torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(
        device, theta_dtype) for s in shapes]
    deltas = [torch.as_tensor(rng.normal(size=(k,) + s).astype(
        np.float32)).to(device, delta_dtype) for s in shapes]
    c = rng.normal(size=k)
    coeffs = torch.as_tensor((np.exp(c) / np.exp(c).sum()).astype(
        np.float32)).to(device)
    return thetas, deltas, coeffs


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 12, 20])
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16"),
                                    ("bfloat16", "float32")])
def test_leaf_kernel_matches_plain(cuda, k, dtypes):
    """Every K bucket (<= 8, <= 16, batches of 4; K = 1 takes scalar
    tails) over the CNN's leaves and ragged ones, in one call: within TOL
    of the plain version and bitwise its order of arithmetic."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref
    shapes = list(CNN_SHAPES.values()) + RAGGED_SHAPES
    thetas, deltas, coeffs = _leaves(shapes, k, k, DTYPES[dtypes[0]],
                                     DTYPES[dtypes[1]], cuda)
    before = fk.LAUNCHES["fl_aggregate"]
    outs = fk.fl_aggregate_leaves_cuda(thetas, deltas, coeffs)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fl_aggregate"] == before + 1
    tol = max(TOL[d] for d in dtypes)
    for out, want, exact in zip(
            outs, ref.aggregate_leaves_reference(thetas, deltas, coeffs),
            ref.aggregate_leaves_fma_reference(thetas, deltas, coeffs)):
        assert out.dtype == want.dtype and out.shape == want.shape
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        assert torch.equal(out, exact)


@pytest.mark.cuda
def test_leaf_kernel_is_bitwise_the_ravel_path_on_the_cnn(cuda):
    """``aggregate_fused`` (one launch over the leaves) against the ravel
    path (ravel, the flat entry, unravel) and the exact order of
    arithmetic, bit for bit."""
    from repro_torch.fl import server
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref
    names = sorted(CNN_SHAPES)
    thetas, deltas, coeffs = _leaves([CNN_SHAPES[n] for n in names], 8, 5,
                                     torch.float32, torch.float32, cuda)
    params, stacked = dict(zip(names, thetas)), dict(zip(names, deltas))
    before = fk.LAUNCHES["fl_aggregate"]
    got = server.aggregate_fused(params, stacked, coeffs)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fl_aggregate"] == before + 1
    ad = server.ParamRavel(params)
    want = ad.unravel(fk.fl_aggregate_cuda(ad.ravel(params),
                                           ad.ravel_stacked(stacked), coeffs))
    exact = ref.aggregate_leaves_fma_reference(thetas, deltas, coeffs)
    for name, e in zip(names, exact):
        assert torch.equal(got[name], want[name]), name
        assert torch.equal(got[name], e), name


@pytest.mark.cuda
def test_leaf_kernel_more_leaves_than_the_cap(cuda):
    """150 leaves of one dtype pair take ceil(150 / 64) = 3 launches; two
    dtype pairs take a launch each."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    shapes = [(int(n),) for n in rng.integers(1, 3000, 150)]
    thetas, deltas, coeffs = _leaves(shapes, 4, 6, torch.bfloat16,
                                     torch.bfloat16, cuda)
    before = fk.LAUNCHES["fl_aggregate"]
    outs = fk.fl_aggregate_leaves_cuda(thetas, deltas, coeffs)
    assert fk.LAUNCHES["fl_aggregate"] == before + 3
    for out, want, exact in zip(
            outs, ref.aggregate_leaves_reference(thetas, deltas, coeffs),
            ref.aggregate_leaves_fma_reference(thetas, deltas, coeffs)):
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert torch.equal(out, exact)
    mixed = [t.float() if i % 2 else t for i, t in enumerate(thetas[:6])]
    before = fk.LAUNCHES["fl_aggregate"]
    fk.fl_aggregate_leaves_cuda(mixed, deltas[:6], coeffs)
    assert fk.LAUNCHES["fl_aggregate"] == before + 2


@pytest.mark.cuda
def test_leaf_kernel_rejects_bad_leaves(cuda):
    from repro_torch.kernels import fl_aggregate as fk
    thetas, deltas, coeffs = _leaves([(6, 5), (7,)], 3, 0, torch.float32,
                                     torch.float32, cuda)
    with pytest.raises(ValueError, match="leaf 0 theta must be contiguous"):
        fk.fl_aggregate_leaves_cuda([thetas[0].t(), thetas[1]], deltas,
                                    coeffs)
    with pytest.raises(ValueError, match="leaf 1: deltas must be"):
        fk.fl_aggregate_leaves_cuda(
            thetas, [deltas[0], deltas[1][:, :6].contiguous()], coeffs)
    with pytest.raises(ValueError, match="leaf 1: deltas must be"):
        fk.fl_aggregate_leaves_cuda(thetas, [deltas[0], deltas[1][:2]],
                                    coeffs)
    with pytest.raises(ValueError, match="dtype"):
        fk.fl_aggregate_leaves_cuda([thetas[0].half(), thetas[1]], deltas,
                                    coeffs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fk.fl_aggregate_leaves_cuda([thetas[0], thetas[1].cpu()], deltas,
                                    coeffs)
    with pytest.raises(ValueError, match="thetas against"):
        fk.fl_aggregate_leaves_cuda(thetas[:1], deltas, coeffs)


@pytest.mark.cuda
def test_aggregate_fused_replays_in_a_cuda_graph(cuda):
    """The launch allocates, uploads and synchronises nothing, so a CUDA
    graph captures it; a replay on new inputs equals the eager call."""
    from repro_torch.fl import server
    names = sorted(CNN_SHAPES)
    thetas, deltas, coeffs = _leaves([CNN_SHAPES[n] for n in names], 8, 9,
                                     torch.float32, torch.float32, cuda)
    params, stacked = dict(zip(names, thetas)), dict(zip(names, deltas))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        server.aggregate_fused(params, stacked, coeffs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = server.aggregate_fused(params, stacked, coeffs)
    for d in stacked.values():
        d.mul_(-0.5)
    graph.replay()
    eager = server.aggregate_fused(params, stacked, coeffs)
    torch.cuda.synchronize()
    for name in names:
        assert torch.equal(captured[name], eager[name]), name


def _lane_leaves(shapes, lanes, k, seed, theta_dtype, delta_dtype, device):
    """``[S, ...]`` thetas, ``[S, K, ...]`` deltas, ``[S, K]`` coeffs (the
    last lane's last slot inert, coefficient 0, as padded K gives)."""
    per = [_leaves(shapes, k, seed + s, theta_dtype, delta_dtype, device)
           for s in range(lanes)]
    thetas = [torch.stack([p[0][i] for p in per]) for i in range(len(shapes))]
    deltas = [torch.stack([p[1][i] for p in per]) for i in range(len(shapes))]
    coeffs = torch.stack([p[2] for p in per]).contiguous()
    coeffs[-1, -1] = 0.0
    return thetas, deltas, coeffs


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("float32", "bfloat16")],
                         ids=["f32", "bf16", "f32_bf16"])
@pytest.mark.parametrize("shapes,lanes,k", [
    (list(CNN_SHAPES.values()), 7, 8), (RAGGED_SHAPES, 3, 3),
    (RAGGED_SHAPES, 9, 5)], ids=["cnn", "ragged", "two_tables"])
def test_lane_kernel_is_bitwise_its_fma_order_and_the_one_lane_calls(
        cuda, dtypes, shapes, lanes, k):
    """The lane kernel: bitwise ``ref.aggregate_lanes_fma_reference``,
    bitwise S one-lane launches on each lane's tensors, within TOL of the
    plain version; one launch per table (9 lanes x 8 ragged leaves = 72
    segments: two tables)."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref
    td, dd = DTYPES[dtypes[0]], DTYPES[dtypes[1]]
    thetas, deltas, coeffs = _lane_leaves(shapes, lanes, k, 31, td, dd, cuda)
    cap = fk._library().fl_aggregate_max_segments()
    before = fk.LAUNCHES["fl_aggregate_lanes"]
    out = fk.fl_aggregate_lanes_cuda(thetas, deltas, coeffs)
    launched = fk.LAUNCHES["fl_aggregate_lanes"] - before
    exact = ref.aggregate_lanes_fma_reference(thetas, deltas, coeffs)
    plain = ref.aggregate_lanes_reference(thetas, deltas, coeffs)
    tol = TOL[dtypes[1]] if "bfloat16" in dtypes else TOL["float32"]
    for i in range(len(shapes)):
        assert out[i].dtype == td and out[i].shape == thetas[i].shape
        assert torch.equal(out[i], exact[i]), i
        torch.testing.assert_close(out[i].float(), plain[i].float(),
                                   atol=tol, rtol=tol)
    for s in range(lanes):
        one = fk.fl_aggregate_leaves_cuda([t[s] for t in thetas],
                                          [d[s] for d in deltas], coeffs[s])
        for i in range(len(shapes)):
            assert torch.equal(out[i][s], one[i]), (s, i)
    assert launched == -(-lanes * len(shapes) // cap)


@pytest.mark.cuda
def test_lane_kernel_rejects_bad_inputs(cuda):
    from repro_torch.fl import server
    from repro_torch.kernels import fl_aggregate as fk
    thetas, deltas, coeffs = _lane_leaves(list(CNN_SHAPES.values()), 3, 4,
                                          5, torch.float32, torch.float32,
                                          cuda)
    for bad in (coeffs[0], coeffs[:2], coeffs[:, :3], coeffs.double(),
                coeffs.t().contiguous().t(), coeffs.cpu()):
        with pytest.raises(ValueError):
            fk.fl_aggregate_lanes_cuda(thetas, deltas, bad)
    with pytest.raises(ValueError):
        fk.fl_aggregate_lanes_cuda(thetas, deltas[:-1], coeffs)
    with pytest.raises(ValueError):
        fk.fl_aggregate_lanes_cuda([t[:2] for t in thetas], deltas, coeffs)
    with pytest.raises(ValueError, match="impl='ref'"):
        server.aggregate_fused_lanes(
            dict(enumerate(thetas)), dict(enumerate(deltas)), coeffs,
            impl="ref")


@pytest.mark.cuda
def test_samplers_give_the_cpu_bits_on_the_card(cuda):
    """The lane-batched channel samplers and dropout masks: the same keys
    give the same bits on the card as on the CPU."""
    from repro_torch.fl import environment as env
    keys = torch.tensor([0, 3, 11, 42], dtype=torch.int64)
    cols = dict(mode=torch.tensor([0, 1, 0, 1], dtype=torch.int32),
                mean_gain=torch.tensor([0.1, 0.1, 0.05, 0.2]),
                bad_gain=torch.tensor([0.02, 0.02, 0.02, 0.01]),
                min_gain=torch.tensor([0.01] * 4),
                max_gain=torch.tensor([0.5] * 4),
                p_gb=torch.tensor([0.0, 0.2, 0.0, 0.05]),
                p_bg=torch.tensor([0.0, 0.3, 0.0, 0.5]))
    runs = []
    for dev in ("cpu", cuda):
        c = {n: v.to(dev) for n, v in cols.items()}
        runs.append((env.sample_channel_sequence(keys.to(dev), 300, 120,
                                                 **c).cpu(),
                     env.sample_dropout_mask(
                         keys.to(dev), 300, 120,
                         torch.tensor([0.0, 0.2, 0.5, 0.9]).to(dev)).cpu()))
    (h_cpu, d_cpu), (h_gpu, d_gpu) = runs
    assert torch.equal(h_cpu, h_gpu)
    assert torch.equal(d_cpu, d_gpu)


@pytest.mark.cuda
def test_arena_on_the_card_matches_the_cpu(cuda):
    """The scenario arena's lanes on the card against the CPU and against
    ``run_scan``: the check that ``chip_smoke.py`` runs."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_reference_arena()


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


@pytest.mark.cuda
def test_run_scan_on_the_card_matches_the_cpu(cuda):
    """``RoundEngine.run_scan`` under each of the seven controllers, with
    dropout and with padded K, on the card against the CPU: the check
    that ``chip_smoke.py`` runs (selections equal, the rest within 1e-4,
    one ``fl_aggregate`` launch per round on the card)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.phase_reference_scan()


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_tiered_trainer_on_the_card_matches_the_cpu(cuda, storage):
    """Three LROA rounds on a 3-rung ladder (fp32, and int8 codes
    dequantized in the gather) on the card against the CPU: selections
    equal, the rest within 1e-4, exactly one ``fl_aggregate`` launch per
    round however many tiers it hits (``chip_smoke.py``'s
    ``reference.tiered``)."""
    smoke = _chip_smoke()
    smoke.phase_reference(cfg=smoke.TIERED, bank_mode="auto",
                          storage=storage, label="reference.tiered")


@pytest.mark.cuda
def test_pool_and_hierarchical_round_on_the_card_match_the_cpu(cuda):
    """A ``BankPool`` after churn (storage unmoved) and a hierarchical
    round on the card against the CPU (``reference.pool``)."""
    _chip_smoke().phase_reference_pool()


@pytest.mark.cuda
def test_f16_banks_on_the_card_hold_the_reference_bytes_and_match_the_cpu(
        cuda):
    """Float16 clients through a ``ClientBank``, a ``TieredClientBank``
    and a ``BankPool`` on the card: ``nbytes`` equal to
    ``estimate_bank_nbytes(..., feature_dtype=np.float16,
    label_dtype=np.int32)``, features half the f32 bank's bytes, one
    round within 1e-4 of the CPU's with one ``fl_aggregate`` launch
    (``reference.pool``'s ``f16.*`` rounds)."""
    _chip_smoke().phase_reference_pool_f16()


@pytest.mark.cuda
def test_sweep_on_the_card_matches_the_cpu(cuda):
    """The sweep service on the tiered testbed (``reference.sweep``):
    killed and resumed bitwise on each device, another lr schedule
    finding no checkpoint, card against CPU within 1e-6 (queues 1e-4),
    one lane launch per bucket round."""
    _chip_smoke().phase_reference_sweep()


@pytest.mark.cuda
def test_sequential_path_on_the_card_matches_the_cpu(cuda):
    """The sequential reference path under LROA and DivFL on the card
    against the CPU (selections equal; params, losses, queues and DivFL's
    update bank within 1e-4; no ``fl_aggregate`` launch), the fused
    trainer against the sequential one on the card at equal client sizes
    (losses 1e-5, params 2e-5) and ``round_step_stacked`` bitwise
    ``round_step`` (``chip_smoke.py``'s ``reference.sequential``)."""
    _chip_smoke().phase_reference_sequential()


@pytest.mark.cuda
def test_resnet_round_on_the_card_matches_the_cpu(cuda):
    """Three LROA rounds of a small ResNet trainer (width 4, 16x16x3) on
    the card against the CPU, one ``fl_aggregate`` launch per round."""
    smoke = _chip_smoke()
    cfg = dict(smoke.SMALL, image_shape=(16, 16, 3), num_classes=10,
               task="resnet")
    smoke.phase_reference(cfg=cfg, label="reference.resnet")


@pytest.mark.cuda
def test_pytree_aggregate_launches_once_per_leaf(cuda):
    """``ops.fl_aggregate_pytree`` on a small ResNet's leaves: one launch
    per leaf, each leaf bitwise the one-launch ``aggregate_fused``."""
    from repro_torch.fl import server
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ops
    from repro_torch.models import ResNetTask
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = ResNetTask(image_shape=(8, 8, 3), width=4).init(gen)
    stacked = {n: torch.randn((3,) + tuple(p.shape), device="cuda",
                              generator=gen) for n, p in params.items()}
    coeffs = torch.tensor([0.5, 0.3, 0.2], device="cuda")
    before = fk.LAUNCHES["fl_aggregate"]
    per_leaf = ops.fl_aggregate_pytree(params, stacked, coeffs)
    assert fk.LAUNCHES["fl_aggregate"] - before == len(params)
    one = server.aggregate_fused(params, stacked, coeffs)
    for n in params:
        assert torch.equal(per_leaf[n], one[n]), n


# (B, H, Hkv, Sq, Sk, D): tests/test_kernels.py, then a D = 128 and a
# D = 256 point with several query and kv tiles and ragged ends (Sq <= Sk,
# so every query row sees at least one key under every mask below)
FLASH_CASES = [(1, 2, 2, 33, 33, 16), (2, 4, 2, 64, 64, 32),
               (1, 8, 1, 48, 80, 64), (2, 4, 2, 200, 200, 128),
               (1, 2, 1, 70, 130, 256)]
FLASH_MASKS = [(True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0),
               (True, 0, 20.0), (True, 100, 50.0)]
# (B, S, nh, hd, N, chunk): tests/test_kernels.py, then mamba2's chunk
SSD_CASES = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16),
             (1, 48, 1, 32, 16, 16), (1, 512, 2, 64, 128, 256)]


def _randn(shape, seed, dtype, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to(
        device, DTYPES[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    for b, h, hkv, sq, sk, d in FLASH_CASES:
        q = _randn((b, h, sq, d), sq, dtype, cuda)
        k = _randn((b, hkv, sk, d), sk + 1, dtype, cuda)
        v = _randn((b, hkv, sk, d), sk + 2, dtype, cuda)
        for causal, window, cap in FLASH_MASKS:
            kw = dict(causal=causal, window=window, softcap=cap)
            before = fa.LAUNCHES["flash_attention"]
            out = fa.flash_attention_cuda(q, k, v, **kw)
            torch.cuda.synchronize()
            assert fa.LAUNCHES["flash_attention"] == before + 1
            assert out.dtype == q.dtype and out.shape == q.shape
            torch.testing.assert_close(
                out.float(), ref.mha_reference(q, k, v, **kw).float(),
                atol=TOL[dtype], rtol=TOL[dtype])
    # the model's [B, S, H, D] layout, read through strides
    qs = _randn((2, 40, 4, 32), 1, dtype, cuda)
    ks = _randn((2, 40, 2, 32), 2, dtype, cuda)
    out = fa.flash_attention_cuda(qs.transpose(1, 2), ks.transpose(1, 2),
                                  ks.transpose(1, 2))
    assert out.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(
        out.float(), ref.mha_reference(qs.transpose(1, 2),
                                       ks.transpose(1, 2),
                                       ks.transpose(1, 2)).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(cuda, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    for b, s, nh, hd, n, chunk in SSD_CASES:
        x = _randn((b, s, nh, hd), s, dtype, cuda)
        dt = torch.nn.functional.softplus(
            _randn((b, s, nh), s + 1, "float32", cuda)).to(DTYPES[dtype])
        a_log = torch.log(torch.linspace(1.0, 8.0, nh, device=cuda)).to(
            DTYPES[dtype])
        bm = _randn((b, s, n), s + 2, dtype, cuda)
        cm = _randn((b, s, n), s + 3, dtype, cuda)
        before = dict(sk.LAUNCHES)
        y, states = sk.ssd_chunk_cuda(x, dt, a_log, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        assert sk.LAUNCHES == {k: n + 1 for k, n in before.items()}
        wy, wstates = ref.ssd_chunk_batched_reference(x, dt, a_log, bm, cm,
                                                      chunk)
        tol = 5 * TOL[dtype]
        assert y.dtype == x.dtype and states.dtype == torch.float32
        torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(states, wstates, atol=tol, rtol=tol)


# bf16 flash at the tensor-core kernel's padded head dims (D = 80 pads to
# 128), S = 1024: (B, H, Hkv, Sq, Sk, D); GQA, ragged Sq != Sk (Sq <= Sk,
# so every row sees a key under the causal and window masks)
FLASH_BF16_CASES = [(1, 4, 2, 1024, 1024, 64), (1, 4, 2, 1024, 1024, 128),
                    (1, 4, 2, 1024, 1024, 256), (1, 4, 2, 1024, 1024, 80),
                    (2, 4, 1, 1000, 1024, 128)]
FLASH_BF16_MASKS = [(True, 0, 0.0), (True, 256, 0.0), (True, 0, 50.0),
                    (True, 256, 50.0), (False, 0, 50.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_BF16_CASES)
def test_flash_bf16_tensor_core_kernel_matches_plain(cuda, shape):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, h, hkv, sq, sk, d = shape
    q = _randn((b, h, sq, d), sq + d, "bfloat16", cuda)
    k = _randn((b, hkv, sk, d), sk + d + 1, "bfloat16", cuda)
    v = _randn((b, hkv, sk, d), sk + d + 2, "bfloat16", cuda)
    for causal, window, cap in FLASH_BF16_MASKS:
        kw = dict(causal=causal, window=window, softcap=cap)
        out = fa.flash_attention_cuda(q, k, v, **kw).float()
        want = ref.mha_reference(q, k, v, **kw).float()
        # chip_smoke.FLASH_TOL: atol 5e-3, rtol 2e-2 per element, a
        # relative L2 error within 4e-3 and within 1e-2 in every row
        torch.testing.assert_close(out, want, atol=5e-3, rtol=2e-2)
        diff = out - want
        assert float(diff.norm()) <= 4e-3 * float(want.norm())
        assert bool(torch.all(diff.norm(dim=-1)
                              <= 1e-2 * want.norm(dim=-1)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_at_mamba2_widths(cuda, dtype):
    """nh = 24, hd = 64, N = 128, chunk 256, S = 512 (two chunks)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    b, s, nh, hd, n, chunk = 2, 512, 24, 64, 128, 256
    x = _randn((b, s, nh, hd), 5, dtype, cuda)
    dt = torch.nn.functional.softplus(
        _randn((b, s, nh), 6, "float32", cuda)).to(DTYPES[dtype])
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=cuda)).to(
        DTYPES[dtype])
    bm = _randn((b, s, n), 7, dtype, cuda)
    cm = _randn((b, s, n), 8, dtype, cuda)
    y, states = sk.ssd_chunk_cuda(x, dt, a_log, bm, cm, chunk=chunk)
    wy, wstates = ref.ssd_chunk_batched_reference(x, dt, a_log, bm, cm, chunk)
    tol = 5 * TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(states, wstates, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_lm_kernels_reject_bad_inputs(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    q = _randn((1, 2, 16, 32), 0, "float32", cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(q[..., :24].contiguous(),
                                q[..., :24].contiguous(),
                                q[..., :24].contiguous())
    big = _randn((1, 1, 16, 272), 0, "float32", cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(2, 3), q.transpose(2, 3),
                                q.transpose(2, 3))
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q.cpu(), q, q)
    # the tensor-core kernel copies 16-byte pieces: a bf16 view 2 bytes
    # off a 16-byte boundary is refused, not read wrongly
    qb = _randn((1, 2, 16, 33), 0, "bfloat16", cuda)[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_cuda(qb, qb, qb)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention_cuda(q, q[:, :1].expand(1, 3, 16, 32)[:, :3],
                                q[:, :1].expand(1, 3, 16, 32)[:, :3])
    x = _randn((1, 32, 2, 8), 0, "float32", cuda)
    dt = torch.ones((1, 32, 2), device=cuda)
    a_log = torch.zeros(2, device=cuda)
    bm = _randn((1, 32, 4), 1, "float32", cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        sk.ssd_chunk_cuda(x, dt, a_log, bm, bm, chunk=12)
    with pytest.raises(ValueError, match="contiguous"):
        sk.ssd_chunk_cuda(x.transpose(2, 3).contiguous().transpose(2, 3),
                          dt, a_log, bm, bm, chunk=8)
    with pytest.raises(ValueError, match="dtype"):
        sk.ssd_chunk_cuda(x, dt.bfloat16(), a_log, bm, bm, chunk=8)
    with pytest.raises(ValueError, match="b_in"):
        sk.ssd_chunk_cuda(x, dt, a_log, bm[:, :16], bm, chunk=8)


def _smoke_module():
    root = pathlib.Path(__file__).resolve().parents[1]
    # the sharded phases' spawned ranks import the module by its name
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    return smoke


# the smoke LMs of chip_smoke.LM_REFERENCE, by position: gemma2 (flash,
# binding window), mamba2, granite-moe, grok-1, recurrentgemma, Whisper,
# qwen2-vl and gemma2 with int8 global caches
LM_CASES = ["gemma2", "mamba2", "granite_moe", "grok", "recurrentgemma",
            "whisper", "qwen2_vl", "gemma2_int8"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(LM_CASES)), ids=LM_CASES)
def test_lm_on_the_card_matches_the_cpu(cuda, case):
    """Each smoke LM served greedily on the card and on the CPU, with the
    launches each layer kind makes: the check ``chip_smoke.py`` runs."""
    smoke = _smoke_module()
    assert len(smoke.LM_REFERENCE) == len(LM_CASES)
    smoke.phase_reference_lm(cases=smoke.LM_REFERENCE[case:case + 1])


# the flash kernel at each new family's shape class, small: (B, H, Hkv,
# Sq, Sk, D), causal, window, soft-cap
FAMILY_FLASH = [((1, 10, 1, 300, 300, 256), True, 128, 0.0),
                ((2, 6, 6, 150, 150, 64), False, 0, 0.0),
                ((2, 6, 6, 24, 150, 64), False, 0, 0.0),
                ((2, 6, 6, 1, 150, 64), False, 0, 0.0),
                ((1, 6, 2, 200, 200, 64), True, 0, 0.0),
                ((1, 7, 1, 200, 200, 128), True, 0, 0.0),
                ((1, 4, 2, 200, 200, 128), True, 0, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,softcap", FAMILY_FLASH)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_the_families_shapes_matches_plain(cuda, shape, causal,
                                                    window, softcap, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, h, hkv, sq, sk, d = shape
    q = _randn((b, h, sq, d), 1, dtype, cuda)
    k = _randn((b, hkv, sk, d), 2, dtype, cuda)
    v = _randn((b, hkv, sk, d), 3, dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = fa.flash_attention_cuda(q, k, v, **kw)
    want = ref.mha_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# the flash kernel's lse output and the training path's backwards:
# (B, H, Hkv, Sq, Sk, D), causal, window, soft-cap; gemma-2b's head shape
# (MQA, D = 256) at a short sequence, a ragged GQA case with a window, and
# a soft-capped one
LSE_CASES = [((2, 8, 1, 200, 200, 256), True, 0, 0.0),
             ((1, 4, 2, 77, 77, 64), True, 16, 0.0),
             ((1, 4, 2, 130, 130, 128), True, 0, 30.0)]
# lse against the plain version: f32 2e-5; bf16 2e-2, plus cap x 5e-4
# under a soft-cap (the kernel's tanh.approx; chip_smoke.LSE_CAP_TOL)
LSE_CAP_TOL = 5e-4
# the flash backward on the card against autograd through the plain
# version, f32: the backward reads the kernel's out and lse, each within
# 2e-5 of the plain version's, and sums up to S such terms into dq / dk,
# so the gradients are held within 1e-4 (atol and rtol)
GRAD_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,softcap", LSE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_lse_matches_plain_and_leaves_out_unchanged(
        cuda, shape, causal, window, softcap, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, h, hkv, sq, sk, d = shape
    q = _randn((b, h, sq, d), 4, dtype, cuda)
    k = _randn((b, hkv, sk, d), 5, dtype, cuda)
    v = _randn((b, hkv, sk, d), 6, dtype, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention_cuda(q, k, v, **kw)
    out2, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    assert fa.LAUNCHES["flash_attention_lse"] == \
        before["flash_attention_lse"] + 1
    assert torch.equal(out, out2)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    _, want = ref.mha_reference(q, k, v, return_lse=True, **kw)
    tol = TOL[dtype] + (LSE_CAP_TOL * softcap if dtype == "bfloat16"
                        else 0.0)
    torch.testing.assert_close(lse, want, atol=tol, rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,softcap", LSE_CASES)
def test_flash_backward_on_the_card_matches_autograd_through_plain(
        cuda, shape, causal, window, softcap):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models.flash import FlashConfig, flash_attention
    b, h, hkv, sq, sk, d = shape
    q = _randn((b, sq, h, d), 7, "float32", cuda).requires_grad_(True)
    k = _randn((b, sk, hkv, d), 8, "float32", cuda).requires_grad_(True)
    v = _randn((b, sk, hkv, d), 9, "float32", cuda).requires_grad_(True)
    dout = _randn((b, sq, h, d), 10, "float32", cuda)
    cfg = FlashConfig(block_q=64, block_kv=32, causal=causal, window=window,
                      softcap=softcap, scale=d ** -0.5)
    before = fa.LAUNCHES["flash_attention_lse"]
    got = torch.autograd.grad(flash_attention(q, k, v, cfg), (q, k, v),
                              dout)
    assert fa.LAUNCHES["flash_attention_lse"] == before + 1
    want_out = ref.mha_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap,
        scale=d ** -0.5).transpose(1, 2)
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.cuda
def test_ssd_backward_on_the_card_matches_autograd_through_plain(cuda):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models.ssm import SSDChunk
    b, s, nh, hd, n, chunk = 2, 128, 3, 16, 8, 64
    x = _randn((b, s, nh, hd), 11, "float32", cuda)
    dt = torch.nn.functional.softplus(_randn((b, s, nh), 12, "float32",
                                             cuda))
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=cuda))
    bm = _randn((b, s, n), 13, "float32", cuda)
    cm = _randn((b, s, n), 14, "float32", cuda)
    ins = [t.requires_grad_(True) for t in (x, dt, a_log, bm, cm)]
    dy = _randn((b, s, nh, hd), 15, "float32", cuda)
    ds = _randn((b, s // chunk, nh, hd, n), 16, "float32", cuda)
    before = dict(sk.LAUNCHES)
    y, states = SSDChunk.apply(*ins, chunk)
    assert sk.LAUNCHES["ssd_chunk"] == before["ssd_chunk"] + 1
    got = torch.autograd.grad((y, states), ins, (dy, ds))
    wy, wstates = ref.ssd_chunk_batched_reference(*ins, chunk)
    torch.testing.assert_close(y, wy, atol=2e-5, rtol=2e-5)
    want = torch.autograd.grad((wy, wstates), ins, (dy, ds))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_kernels_under_grad_without_a_backward_raise(cuda):
    """A kernel's output is a fresh tensor autograd cannot see: each
    wrapper refuses inputs that require grad under grad mode instead of
    returning a detached result, and takes them under ``no_grad``."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk
    theta, deltas, coeffs = _inputs(1000, 2, 0, "float32", cuda)
    q = _randn((1, 2, 16, 16), 1, "float32", cuda)
    x = _randn((1, 16, 2, 8), 2, "float32", cuda)
    dt, bm = (_randn(s, 3, "float32", cuda) for s in ((1, 16, 2), (1, 16, 4)))
    a_log = torch.zeros(2, device=cuda)
    calls = [
        ("fl_aggregate", lambda t: fk.fl_aggregate_cuda(t, deltas, coeffs),
         theta),
        ("fl_aggregate", lambda t: fk.fl_aggregate_leaves_cuda(
            [t], [deltas], coeffs), theta),
        ("flash_attention", lambda t: fa.flash_attention_cuda(t, q, q), q),
        ("ssd_chunk", lambda t: sk.ssd_chunk_cuda(t, dt, a_log, bm, bm,
                                                  chunk=8), x)]
    for name, call, arg in calls:
        leaf = arg.clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=name):
            call(leaf)
        with torch.no_grad():
            call(leaf)
        call(arg)


@pytest.mark.cuda
def test_training_steps_on_the_card_match_the_cpu(cuda):
    """``make_train_step`` (gemma-2b with the flash path, remat and 2
    microbatches; mamba2-130m) and ``make_fl_round_step`` on the card
    against the CPU, every leaf's gradient present, finite and nonzero:
    the check ``chip_smoke.py``'s ``reference.train`` runs."""
    _smoke_module().phase_reference_train()


@pytest.mark.cuda
def test_delta_reduce_leaves_writes_views_bitwise_its_fma_order(cuda):
    """The client-sharded round's partial: the zero-theta leaf table
    writing f32 partials into views of one flat buffer, one launch,
    bitwise the kernel's order of arithmetic; bad outputs raise."""
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=cuda).manual_seed(4)
    shapes = [(16, 3, 3, 3), (16,), (33, 7), (), (5,)]
    deltas = [torch.randn((4,) + s, device=cuda, generator=gen)
              for s in shapes]
    deltas[1] = deltas[1].bfloat16()
    coeffs = torch.softmax(torch.randn(4, device=cuda, generator=gen), 0)
    total = sum(int(np.prod(s)) for s in shapes)
    flat = torch.full((total,), float("nan"), device=cuda)
    views, off = [], 0
    for s in shapes:
        views.append(flat[off:off + int(np.prod(s))].view(s))
        off += int(np.prod(s))
    before = fk.LAUNCHES["fl_delta_reduce"]
    got = ops.fl_delta_reduce_leaves(deltas, coeffs, outs=views)
    torch.cuda.synchronize()
    # one launch per delta dtype
    assert fk.LAUNCHES["fl_delta_reduce"] == before + 2
    assert all(g.data_ptr() == v.data_ptr() for g, v in zip(got, views))
    for g, w in zip(got, ref.aggregate_leaves_fma_reference(None, deltas,
                                                            coeffs)):
        assert torch.equal(g, w)
    for g, w in zip(got, ref.delta_reduce_leaves_reference(deltas, coeffs)):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
    for bad in ([torch.empty(3, device=cuda)] + views[1:],
                [views[0].bfloat16()] + views[1:],
                [torch.empty(shapes[0])] + views[1:]):
        with pytest.raises(ValueError):
            fk.fl_delta_reduce_leaves_cuda(deltas, coeffs, outs=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_world_on_the_card_matches_unsharded(cuda, tmp_path, ranks,
                                                     backend):
    """``chip_smoke.py``'s reference.shard: the sharded round (single
    bucket, ladder, hierarchical), run_scan and arena on the card against
    the unsharded port, params bitwise across ranks, each partial bitwise
    its fma order; with one NCCL rank every round is bitwise the
    unsharded one (the same order of arithmetic)."""
    smoke = _smoke_module()
    out = smoke._run_shard_world(ranks, backend, None, str(tmp_path / "w"),
                                 str(tmp_path))
    smoke._check_shard_reference(f"reference.shard.{backend}", out)
    if ranks == 1:
        rounds = out[0]["reference"]["rounds"]
        assert all(r["bitwise"] for r in rounds.values()), rounds


@pytest.mark.cuda
def test_no_kernel_builds_after_warmup(cuda):
    """``Arena.warmup`` on the card under a strict watchdog
    (``chip_smoke.py``'s ``warmup.arena`` on the tiered testbed): zero
    violations and no kernel library loaded after warmup, a K_max drift
    raises, one lane launch per round."""
    smoke = _chip_smoke()
    cfg = dict(smoke.TIERED, rounds=20)
    trainer = smoke.build_trainer("cuda", cfg, smoke.make_data(cfg))
    out = smoke.phase_warmup_arena(trainer, cfg)
    assert out["violations"] == [] and out["kernels_loaded_after_warmup"] == []


def _counted_calls(device):
    """Each kernel wrapper once on ``device`` under an op counter, on the
    same inputs: the counter's ``kernels`` record."""
    from repro_torch.kernels import ops
    from repro_torch.launch import op_cost

    g = torch.Generator().manual_seed(3)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(device, dtype)
    deltas = [r(3, 6, 5), r(3, 7)]
    inputs = dict(thetas=[r(6, 5), r(7)], deltas=deltas, coeffs=r(3),
                  lane_thetas=[r(2, 6, 5), r(2, 7)],
                  lane_deltas=[r(2, 3, 6, 5), r(2, 3, 7)],
                  lane_coeffs=r(2, 3),
                  outs=[torch.empty(d.shape[1:], device=device)
                        for d in deltas],
                  q=r(1, 4, 80, 64, dtype=torch.bfloat16),
                  k=r(1, 2, 80, 64, dtype=torch.bfloat16),
                  v=r(1, 2, 80, 64, dtype=torch.bfloat16),
                  x=r(1, 64, 2, 16), dt=r(1, 64, 2).abs(), a_log=r(2),
                  b_in=r(1, 64, 8), c_in=r(1, 64, 8))
    t = inputs
    with op_cost.OpCounter() as c:
        ops.fl_aggregate_leaves(t["thetas"], t["deltas"], t["coeffs"])
        ops.fl_aggregate_lanes(t["lane_thetas"], t["lane_deltas"],
                               t["lane_coeffs"])
        ops.fl_delta_reduce_leaves(t["deltas"], t["coeffs"], t["outs"])
        ops.flash_attention(t["q"], t["k"], t["v"], causal=True, window=48,
                            softcap=30.0, return_lse=True)
        ops.ssd_chunk(t["x"], t["dt"], t["a_log"], t["b_in"], t["c_in"],
                      chunk=32)
    return c.kernels, dict(c.rows)


@pytest.mark.cuda
def test_op_counter_attribution_on_the_card_equals_the_cpu(cuda):
    """Every kernel wrapper reports the same work to an op counter on the
    card (where it launches its kernel) as on the CPU (where the plain
    version runs uncounted)."""
    card, card_rows = _counted_calls("cuda")
    torch.cuda.synchronize()
    cpu, cpu_rows = _counted_calls("cpu")
    assert card == cpu
    assert card_rows == cpu_rows
    assert set(card) == {"fl_aggregate", "fl_aggregate_lanes",
                         "fl_delta_reduce", "flash_attention", "ssd_chunk"}
