"""The LM slice's kernels in the port, held against the JAX package on the
CPU: the plain versions of the flash-attention and SSD-chunk kernels
(``repro_torch.kernels.ref``) against the Pallas TPU kernels run in
interpret mode and against the JAX oracles, the ``ops`` dispatch rule,
and ``models.flash`` against ``repro.models.flash``.  Inputs come from
numpy, from a seed.  Tolerances are those of ``tests/test_kernels.py``:
2e-5 for f32 and 2e-2 for bf16, five times that for the SSD.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_tpu  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunk_tpu  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, H, Hkv, Sq, Sk, D), tests/test_kernels.py
SHAPES = [(1, 2, 2, 33, 33, 16), (2, 4, 2, 64, 64, 32), (1, 8, 1, 48, 80, 64)]
MASKS = [(True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0), (True, 0, 20.0)]
# (B, S, nh, hd, N, chunk), tests/test_kernels.py
SSD_DIMS = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 1, 32, 16, 16)]


def _normal(rng, shape, dtype):
    """The same values for both packages: f32 numpy, rounded to bf16 by
    each side's exact cast when ``dtype`` is bf16."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), torch.as_tensor(a).to(
        TDT[dtype])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _qkv(shape, dtype, seed):
    b, h, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, h, sq, d), dtype),
            _normal(rng, (b, hkv, sk, d), dtype),
            _normal(rng, (b, hkv, sk, d), dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_mha_reference_matches_jax_oracle(shape, dtype, causal, window,
                                          softcap):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(shape, dtype, sum(shape))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ref.mha_reference(tq, tk, tv, **kw)
    assert out.dtype == TDT[dtype] and out.shape == tq.shape
    _close(out, jref.mha_reference(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("shape,mask", list(zip(SHAPES, MASKS[1:])))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_reference_matches_pallas_kernel(shape, mask, dtype):
    """The plain version against the Pallas kernel body (interpret mode),
    one mask configuration per shape: window, non-causal, soft-cap."""
    causal, window, softcap = mask
    (jq, tq), (jk, tk), (jv, tv) = _qkv(shape, dtype, 7 + sum(shape))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_tpu(jq, jk, jv, block_q=16, block_kv=16,
                               interpret=True, **kw)
    _close(ops.flash_attention(tq, tk, tv, **kw), want, TOL[dtype])


# the shape classes the remaining LM families bring to the flash kernel,
# at small sizes: (label, (B, H, Hkv, Sq, Sk, D), causal, window, softcap)
FAMILY_POINTS = [
    # recurrentgemma's local layers: D = 256, MQA (a group of 10), window
    ("mqa_d256_window", (1, 10, 1, 96, 96, 256), True, 32, 0.0),
    # Whisper's encoder: D = 64, non-causal, Sk not a block multiple
    ("noncausal_d64", (2, 6, 6, 75, 75, 64), False, 0, 0.0),
    # Whisper's cross-attention in prefill and in a decode step
    ("cross_sq_lt_sk", (2, 6, 6, 24, 75, 64), False, 0, 0.0),
    ("cross_sq1", (2, 6, 6, 1, 75, 64), False, 0, 0.0),
    # granite-moe's group of 3, qwen2-vl's of 7, grok's soft-cap of 30
    ("gqa3", (1, 6, 2, 48, 48, 64), True, 0, 0.0),
    ("gqa7", (1, 7, 1, 40, 40, 128), True, 0, 0.0),
    ("softcap30", (1, 4, 2, 48, 48, 128), True, 0, 30.0),
]


@pytest.mark.parametrize("label,shape,causal,window,softcap", FAMILY_POINTS,
                         ids=[p[0] for p in FAMILY_POINTS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_the_families_shapes_matches_pallas_kernel(
        label, shape, causal, window, softcap, dtype):
    """The port's CPU flash path (``ops.flash_attention``, the kernel's
    plain version) against the Pallas kernel in interpret mode at each
    new family's shape class, and through ``models.flash`` in the model's
    [B, S, H, D] layout."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(shape, dtype, 11 + sum(shape))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_tpu(jq, jk, jv, block_q=16, block_kv=16,
                               interpret=True, **kw)
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    _close(got, want, TOL[dtype])
    fcfg = tflash.FlashConfig(causal=causal, window=window, softcap=softcap,
                              scale=shape[-1] ** -0.5)
    bshd = tflash.flash_attention(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                                  fcfg)
    _close(bshd.transpose(1, 2), want, TOL[dtype])


def _ssd_inputs(dims, dtype, seed):
    b, s, nh, hd, n, _ = dims
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, s, nh, hd), dtype)
    raw = rng.standard_normal((b, s, nh)).astype(np.float32)
    dt_np = np.log1p(np.exp(raw)).astype(np.float32)        # softplus
    dt = (jnp.asarray(dt_np).astype(JDT[dtype]),
          torch.as_tensor(dt_np).to(TDT[dtype]))
    a_np = np.log(np.linspace(1.0, 8.0, nh)).astype(np.float32)
    a_log = (jnp.asarray(a_np).astype(JDT[dtype]),
             torch.as_tensor(a_np).to(TDT[dtype]))
    return x, dt, a_log, _normal(rng, (b, s, n), dtype), \
        _normal(rng, (b, s, n), dtype)


@pytest.mark.parametrize("dims", SSD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_matches_pallas_kernel(dims, dtype):
    chunk = dims[-1]
    ins = _ssd_inputs(dims, dtype, sum(dims))
    jy, jstates = ssd_chunk_tpu(*(j for j, _ in ins), chunk=chunk,
                                interpret=True)
    ty, tstates = ops.ssd_chunk(*(t for _, t in ins), chunk=chunk)
    assert ty.dtype == TDT[dtype] and tstates.dtype == torch.float32
    assert tuple(tstates.shape) == jstates.shape
    _close(ty, jy, 5 * TOL[dtype])
    _close(tstates, jstates, 5 * TOL[dtype])


@pytest.mark.parametrize("dims", SSD_DIMS)
def test_ssd_chunk_reference_matches_jax_oracle_per_chunk(dims):
    """One chunk of the batched plain version, and the per-chunk plain
    version, against the JAX per-chunk oracle."""
    chunk = dims[-1]
    (jx, tx), (jdt, tdt), (ja, ta), (jb, tb), (jc, tc) = _ssd_inputs(
        dims, "float32", 3 + sum(dims))
    ty, tstates = ref.ssd_chunk_batched_reference(tx, tdt, ta, tb, tc, chunk)
    b = dims[0] - 1
    sl = slice(chunk, 2 * chunk)
    jy1, js1 = jref.ssd_chunk_reference(jx[b, sl], jdt[b, sl], ja, jb[b, sl],
                                        jc[b, sl])
    ty1, ts1 = ref.ssd_chunk_reference(tx[b, sl], tdt[b, sl], ta, tb[b, sl],
                                       tc[b, sl])
    for got in ((ty[b, sl], tstates[b, 1]), (ty1, ts1)):
        _close(got[0], jy1, 5e-5)
        _close(got[1], js1, 5e-5)


def test_ssd_reference_selects_above_the_diagonal():
    """Large dt makes exp(cum_i - cum_j) overflow above the diagonal; the
    selection keeps the output finite."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((1, 16, 1, 4)), dtype=torch.float32)
    dt = torch.full((1, 16, 1), 60.0)
    bc = torch.as_tensor(rng.standard_normal((1, 16, 4)), dtype=torch.float32)
    y, states = ref.ssd_chunk_batched_reference(
        x, dt, torch.zeros(1), bc, bc, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(states).all()


def test_ops_dispatch_raises_where_request_and_device_disagree():
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.flash_attention(q, q, q, impl="cuda")
    x = torch.zeros(1, 8, 1, 4)
    dt = torch.zeros(1, 8, 1)
    bc = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.ssd_chunk(x, dt, torch.zeros(1), bc, bc, chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.ssd_chunk(x, dt, torch.zeros(1), bc, bc, chunk=8, impl="jnp")
    # impl='ref' is the CPU plain path
    torch.testing.assert_close(
        ops.flash_attention(q, q, q, impl="ref"),
        ref.mha_reference(q, q, q))


def test_kernel_wrappers_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        flash_attention_cuda(q, q, q)
    x = torch.zeros(1, 8, 1, 4)
    bc = torch.zeros(1, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ssd_chunk_cuda(x, torch.zeros(1, 8, 1), torch.zeros(1), bc, bc,
                       chunk=8)


@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_model_flash_attention_matches_jax_scan(causal, window, softcap):
    """``models.flash.flash_attention`` ([B, S, H, D], GQA, ragged S)
    against the JAX blockwise scan with 16-wide blocks."""
    rng = np.random.default_rng(11)
    b, s, h, hkv, d = 2, 37, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = (
        _normal(rng, (b, s, n, d), "float32") for n in (h, hkv, hkv))
    jcfg = jflash.FlashConfig(block_q=16, block_kv=16, causal=causal,
                              window=window, softcap=softcap,
                              scale=d ** -0.5)
    tcfg = tflash.FlashConfig(**dataclasses.asdict(jcfg))
    out = tflash.flash_attention(tq, tk, tv, tcfg)
    assert out.shape == tq.shape
    _close(out, jflash.flash_attention(jq, jk, jv, jcfg), 2e-5)
    with pytest.raises(ValueError, match="q_offset"):
        tflash.flash_attention(tq, tk, tv,
                               dataclasses.replace(tcfg, q_offset=3))
    with pytest.raises(ValueError, match="kv_valid_len"):
        tflash.flash_attention(tq, tk, tv,
                               dataclasses.replace(tcfg, kv_valid_len=5))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 20.0)])
def test_flash_decode_matches_jax(window, softcap):
    rng = np.random.default_rng(5)
    b, sk, h, hkv, d, idx = 2, 40, 4, 2, 16, 29
    (jq, tq), (jk, tk), (jv, tv) = (
        _normal(rng, shape, "float32")
        for shape in ((b, 1, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    kw = dict(scale=0.3, window=window, softcap=softcap, block_kv=16)
    want = jflash.flash_decode(jq, jk, jv, cache_index=jnp.int32(idx), **kw)
    _close(tflash.flash_decode(tq, tk, tv, cache_index=idx, **kw), want,
           2e-5)
