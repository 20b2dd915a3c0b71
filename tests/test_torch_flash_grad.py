"""The training path's two differentiable kernels, held against the JAX
package on the CPU: the port's flash attention (``FlashAttention``: the
forward's lse and the blockwise plain backward, ``flash_backward``)
against ``repro.models.flash`` (``_forward``, ``_backward`` and
``jax.grad`` of its ``custom_vjp``), and the SSD chunk's backward
(``SSDChunk``) against ``jax.grad`` of the jnp ``ssd_chunked``.  Inputs
come from numpy seeds; tolerance 2e-5 (f32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import flash as jflash  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = 2e-5
# (B, S, nq, nkv, D), causal, window, soft-cap, (block_q, block_kv): GQA
# and MQA, a ragged S that is no multiple of either block, masks
CASES = [((2, 37, 4, 2, 16), True, 0, 0.0, (16, 8)),
         ((2, 37, 4, 2, 16), True, 5, 0.0, (16, 8)),
         ((1, 29, 4, 4, 32), False, 0, 0.0, (8, 16)),
         ((2, 37, 4, 1, 16), True, 0, 20.0, (16, 16)),
         ((1, 50, 6, 2, 16), True, 9, 30.0, (16, 8))]


def _inputs(shape, seed):
    b, s, nq, nkv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, s, nq, d)).astype(np.float32)
    return q, k, v, dout


def _configs(shape, causal, window, softcap, blocks):
    kw = dict(block_q=blocks[0], block_kv=blocks[1], causal=causal,
              window=window, softcap=softcap, scale=shape[-1] ** -0.5)
    return jflash.FlashConfig(**kw), tflash.FlashConfig(**kw)


def _close(t, a, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape,causal,window,softcap,blocks", CASES)
def test_forward_and_lse_match_the_reference(shape, causal, window, softcap,
                                             blocks):
    q, k, v, _ = _inputs(shape, 0)
    jcfg, tcfg = _configs(shape, causal, window, softcap, blocks)
    jout, jlse = jflash._forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jcfg)
    out, lse = tflash._forward(*(torch.as_tensor(a) for a in (q, k, v)),
                               tcfg, return_lse=True)
    assert lse.shape == (shape[0], shape[2], shape[1])
    _close(out, jout)
    _close(lse, jlse)
    # the plain version's lse is the kernel's second output
    _, lse2 = ops.flash_attention(
        *(torch.as_tensor(a).transpose(1, 2) for a in (q, k, v)),
        causal=causal, window=window, softcap=softcap,
        scale=tcfg.scale, return_lse=True)
    assert torch.equal(lse, lse2)


@pytest.mark.parametrize("shape,causal,window,softcap,blocks", CASES)
def test_backward_matches_the_reference_backward(shape, causal, window,
                                                 softcap, blocks):
    """``flash_backward`` against ``_backward`` on the same residuals."""
    q, k, v, dout = _inputs(shape, 1)
    jcfg, tcfg = _configs(shape, causal, window, softcap, blocks)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, dout))
    jout, jlse = jflash._forward(jq, jk, jv, jcfg)
    want = jflash._backward(jq, jk, jv, jout, jlse, jdo, jcfg)
    got = tflash.flash_backward(
        *(torch.as_tensor(np.array(a)) for a in (q, k, v, jout, jlse,
                                                   dout)), tcfg)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape,causal,window,softcap,blocks", CASES)
def test_autograd_matches_jax_grad(shape, causal, window, softcap, blocks):
    """``flash_attention`` under autograd against ``jax.grad`` through the
    reference's ``custom_vjp``, with a cotangent from a seed."""
    q, k, v, dout = _inputs(shape, 2)
    jcfg, tcfg = _configs(shape, causal, window, softcap, blocks)

    def jloss(q_, k_, v_):
        return jnp.sum(jflash.flash_attention(q_, k_, v_, jcfg)
                       * jnp.asarray(dout))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    out = tflash.flash_attention(*ts, tcfg)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.as_tensor(dout))
    for g, w in zip(got, want):
        _close(g, w)


def test_no_grad_forward_takes_no_backward_path():
    """Serving (no grad) runs the plain forward, with no autograd node."""
    q, k, v, _ = _inputs((1, 20, 2, 1, 16), 3)
    cfg = tflash.FlashConfig(block_q=16, block_kv=16)
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        out = tflash.flash_attention(*ts, cfg)
    assert out.grad_fn is None
    torch.testing.assert_close(out, tflash.flash_attention(*ts, cfg),
                               atol=0, rtol=0)


def _ssd_inputs(seed, dt_scale):
    b, s, nh, hd, n = 2, 40, 3, 8, 4
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.standard_normal((b, s, nh))))
          ).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a_log, bm, cm


def _ssd_grads(inputs, chunk):
    def jloss(*a):
        y, h = jssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * jnp.cos(y)) + jnp.sum(h)

    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in inputs))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in inputs]
    y, h = tssm.ssd_chunked(*ts, chunk)
    got = torch.autograd.grad(torch.sum(y * torch.cos(y)) + h.sum(), ts)
    return got, want


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunk_backward_matches_jax_grad(chunk):
    """``ssd_chunked`` (``SSDChunk`` for the intra-chunk part) under
    autograd against ``jax.grad`` of the reference's jnp version, with
    step sizes whose intra-chunk decays stay in range; S = 40 is ragged
    against both chunks."""
    got, want = _ssd_grads(_ssd_inputs(0, 0.05), chunk)
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_backward_stays_finite_where_the_reference_gives_nan():
    """A standing divergence (ROADMAP section C): where exp(seg) above the
    chunk's diagonal overflows f32, the reference's
    ``where(tri, exp(seg), 0)`` backpropagates 0 * inf = NaN into dt and
    a_log; the port exponentiates 0 there (same forward values) and its
    gradients stay finite.  The other inputs' gradients agree."""
    got, want = _ssd_grads(_ssd_inputs(1, 1.0), 16)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert not all(np.isfinite(np.asarray(w)).all() for w in want)
    for i in (0, 3, 4):          # x, B, C
        _close(got[i], want[i])
