"""The arithmetic of the port's redesigned CUDA kernels, modelled in plain
PyTorch on the CPU and held against the JAX package's Pallas kernels (run
in interpret mode), plus the plain functions the wrappers and
``chip_smoke.py`` use: the flash kernel's choice of path and padded head
dim, and each kernel's operation count against a brute-force count of
its mask.

* The bf16 flash kernel: kv tiles of 128 (64 at a padded head dim of
  256), f32 online softmax in base 2 on t = tanh(scale * s / cap) with
  k = cap * log2(e) (or t = s, k = scale * log2(e) without a cap): the
  row max on t, p = exp2(k t - m), masked logits selected to p = 0, P
  rounded to bf16 before PV, the row sum taken from the unrounded P.
  Held against ``flash_attention_tpu`` in bf16 within 2e-2
  (tests/test_kernels.py), and within 4e-3 in relative L2 error, the
  limit ``chip_smoke.py`` holds the kernel to.
* The two-pass SSD kernel: S = C B^T once per (batch, chunk), lower
  triangle, stored transposed; then per head the decay and dt applied to
  S and the end-state factor.  Held against ``ssd_chunk_tpu`` in f32
  within 1e-4.

Inputs come from numpy, from a seed.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_tpu  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunk_tpu  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402

LOG2E = 1.4426950408889634
# (B, H, Hkv, Sq, Sk, D) and masks of tests/test_torch_lm_kernels.py
SHAPES = [(1, 2, 2, 33, 33, 16), (2, 4, 2, 64, 64, 32), (1, 8, 1, 48, 80, 64)]
MASKS = [(True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0), (True, 0, 20.0)]
# gemma2-like: D = 128, soft-cap 50, a window shorter than S, GQA group 2,
# several kv tiles
GEMMA_LIKE = ((1, 4, 2, 160, 160, 128), (True, 48, 50.0))
SSD_DIMS = [(1, 32, 2, 8, 4, 8), (2, 64, 3, 16, 8, 16), (1, 48, 1, 32, 16, 16)]


def flash_bf16_design(q, k, v, *, causal, window, softcap, scale=None):
    """The bf16 kernel's arithmetic, row by row (a kv tile the mask
    empties changes nothing, so skipping it is not modelled)."""
    b, h, sq, d = q.shape
    hkv, sk_len = k.shape[1], k.shape[2]
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kv_tile = fa.kernel_path(q.dtype, d).kv_tile
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    kexp = softcap * LOG2E if softcap > 0 else scale * LOG2E
    m = torch.full((b, h, sq), -math.inf)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    rows = torch.arange(sq)[:, None]
    for c0 in range(0, sk_len, kv_tile):
        kt, vt = kf[:, :, c0:c0 + kv_tile], vf[:, :, c0:c0 + kv_tile]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt)
        if softcap > 0:
            s = torch.tanh(s * (scale / softcap))
        cols = c0 + torch.arange(kt.shape[2])[None, :]
        vis = torch.ones_like(cols + rows, dtype=torch.bool)
        if causal:
            vis &= cols <= rows
        if window > 0:
            vis &= cols > rows - window
        s = torch.where(vis, s, -math.inf)
        m_new = torch.maximum(m, kexp * s.amax(-1))
        m_sub = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_sub)
        p = torch.exp2(kexp * s - m_sub[..., None])
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def ssd_two_pass_design(x, dt, a_log, b_in, c_in, chunk):
    """The two-pass SSD kernel's order: scores once per (batch, chunk),
    then per-head decay, in f32."""
    bsz, s, nh, hd = x.shape
    nc = s // chunk
    f32 = torch.float32
    bc = b_in.reshape(bsz, nc, chunk, -1).to(f32)
    cc = c_in.reshape(bsz, nc, chunk, -1).to(f32)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool)).T  # [j, i]
    # pass 1: scores[b, c, j, i] = C_i . B_j, 0 above the diagonal
    scores = torch.where(tri, torch.einsum("bcjn,bcin->bcji", bc, cc), 0.0)
    # pass 2, per (b, h, chunk)
    xc = x.reshape(bsz, nc, chunk, nh, hd).to(f32)
    dtc = dt.reshape(bsz, nc, chunk, nh).to(f32)
    cum = torch.cumsum(dtc * -torch.exp(a_log.to(f32)), dim=2)  # [b,c,L,h]
    seg = cum[:, :, None, :, :] - cum[:, :, :, None, :]          # [b,c,j,i,h]
    decay = torch.exp(torch.where(tri[..., None], seg, -math.inf))
    w_t = scores[..., None] * decay * dtc[:, :, :, None, :]
    y = torch.einsum("bcjih,bcjhd->bcihd", w_t, xc)
    fac = dtc * torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjhd,bcjn->bchdn", xc * fac[..., None], bc)
    return y.reshape(bsz, s, nh, hd).to(x.dtype), states


def _bf16_pair(rng, shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.as_tensor(a).bfloat16()


@pytest.mark.parametrize("shape,mask", [(s, m) for s in SHAPES for m in MASKS]
                         + [GEMMA_LIKE])
def test_flash_bf16_design_matches_pallas_kernel(shape, mask):
    b, h, hkv, sq, sk_len, d = shape
    causal, window, softcap = mask
    rng = np.random.default_rng(sum(shape) + window)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(rng, (b, h, sq, d)),
                                    _bf16_pair(rng, (b, hkv, sk_len, d)),
                                    _bf16_pair(rng, (b, hkv, sk_len, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_tpu(jq, jk, jv, block_q=32, block_kv=32,
                               interpret=True, **kw)
    out = flash_bf16_design(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    got, want = out.float().numpy(), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.linalg.norm(got - want) <= 4e-3 * np.linalg.norm(want)


@pytest.mark.parametrize("dims", SSD_DIMS)
def test_ssd_two_pass_design_matches_pallas_kernel(dims):
    b, s, nh, hd, n, chunk = dims
    rng = np.random.default_rng(sum(dims))
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, nh)).astype(np.float32)
    b_in = rng.standard_normal((b, s, n)).astype(np.float32)
    c_in = rng.standard_normal((b, s, n)).astype(np.float32)
    ins = (x, dt, a_log, b_in, c_in)
    jy, jstates = ssd_chunk_tpu(*map(jnp.asarray, ins), chunk=chunk,
                                interpret=True)
    ty, tstates = ssd_two_pass_design(*map(torch.as_tensor, ins), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tstates.numpy(), np.asarray(jstates),
                               atol=1e-4, rtol=1e-4)


# (path, padded head dim, kv rows per tile)
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, ("wgmma_bf16", 64, 128)),
    (torch.bfloat16, 64, ("wgmma_bf16", 64, 128)),
    (torch.bfloat16, 80, ("wgmma_bf16", 128, 128)),
    (torch.bfloat16, 128, ("wgmma_bf16", 128, 128)),
    (torch.bfloat16, 144, ("wgmma_bf16", 256, 64)),
    (torch.bfloat16, 256, ("wgmma_bf16", 256, 64)),
    (torch.float32, 16, ("cuda_cores_f32", 16, 64)),
    (torch.float32, 80, ("cuda_cores_f32", 80, 64)),
    (torch.float32, 256, ("cuda_cores_f32", 256, 64)),
])
def test_flash_kernel_path(dtype, d, want):
    assert fa.kernel_path(dtype, d) == want


@pytest.mark.parametrize("dtype,d,match", [
    (torch.bfloat16, 24, "head_dim"), (torch.float32, 272, "head_dim"),
    (torch.bfloat16, 0, "head_dim"), (torch.float16, 64, "dtype"),
])
def test_flash_kernel_path_rejects(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        fa.kernel_path(dtype, d)


@pytest.mark.parametrize("b,h,d,sq,sk_len,causal,window", [
    (1, 1, 16, 7, 7, True, 0), (2, 3, 32, 33, 33, True, 16),
    (1, 2, 64, 48, 80, True, 0), (1, 2, 16, 48, 80, False, 0),
    (2, 1, 16, 80, 48, True, 0), (1, 1, 16, 40, 40, False, 8),
    (1, 4, 128, 130, 130, True, 64),
])
def test_flash_flops_match_brute_force(b, h, d, sq, sk_len, causal, window):
    pairs = 0
    for i in range(sq):
        for j in range(sk_len):
            pairs += ((not causal or j <= i)
                      and (window <= 0 or j > i - window))
    assert fa.visible_pairs(sq, sk_len, causal, window) == pairs
    assert fa.flash_attention_flops(b, h, d, sq, sk_len, causal,
                                    window) == 4 * b * h * d * pairs


def _ssd_multiply_adds(b, s, nh, hd, n, chunk):
    """Every multiply-add of the two passes, counted one by one."""
    count = 0
    for _ in range(b * (s // chunk)):        # pass 1, per (b, chunk)
        for i in range(chunk):
            for j in range(i + 1):
                for _ in range(n):           # C_i . B_j
                    count += 1
        for _ in range(nh):                  # pass 2, per head
            for i in range(chunk):
                for j in range(i + 1):
                    for _ in range(hd):      # y_i += W_ij x_j
                        count += 1
            for _ in range(hd):
                for _ in range(n):
                    for j in range(chunk):   # state += x_j B_j
                        count += 1
    return count


@pytest.mark.parametrize("dims", SSD_DIMS + [(1, 12, 2, 3, 5, 4),
                                             (2, 24, 3, 4, 8, 8)])
def test_ssd_flops_match_brute_force(dims):
    assert sk.ssd_chunk_flops(*dims) == 2 * _ssd_multiply_adds(*dims)


def test_ssd_flops_at_mamba2():
    """6.72 GFLOP at mamba2-130m's prefill: 0.100 ms at 67 TFLOP/s."""
    flops = sk.ssd_chunk_flops(4, 2048, 24, 64, 128, 256)
    assert flops == pytest.approx(6.7245e9, rel=1e-4)
    assert flops / 67e12 * 1e3 == pytest.approx(0.1004, rel=1e-3)
