"""The port's int8 KV cache (``quantized_kv``) held against the JAX
package on the CPU: the codes and scales of ``quantize_kv`` bitwise
(``torch.round`` and ``jnp.round`` both round half to even), the
dequantized flash-decode, attention decode steps writing codes into the
cache (flash-decode and the masked plain path), the prefill cache, and
greedy generation of gemma2's smoke config with int8 global caches
against the JAX serving loop.

Inputs come from numpy seeds; everything runs in f32.  Codes and scales
are bitwise wherever both packages quantize the same floats (the decode
steps' inputs are chosen so that the projections are exact in f32); a
whole model's K/V differ from the JAX package's in the last bit (other
matmul orders), so a value on a code's rounding edge may take the
neighbouring code there: the model-level tests hold every code within
one of JAX's and count the rest.  Outputs within 1e-4, but greedy logits
after such a code (see the test).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import flash as jflash  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from test_torch_lm import (FLASH, NAIVE, _close, _pair,  # noqa: E402
                           check_greedy_against_jax)


def _codes_equal(t, j):
    assert np.array_equal(t.numpy(), np.asarray(j))


def test_quantize_kv_is_bitwise_jax():
    """Random values, values on a code's half-way point (ties), and an
    all-zero head (the 1e-8 floor of the scale)."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 7, 3, 32))).astype(np.float32)
    x[0, 0, 0] = np.arange(32) - 15.5           # amax 16.5: ties on codes
    x[0, 0, 0, 0] = 127.0 / 2                   # a code of exactly x.5
    x[1, 2, 1] = 0.0
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    tq, ts = tattn.quantize_kv(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _codes_equal(tq, jq)
    _codes_equal(ts, js)
    _close(tattn.dequantize_kv(tq, ts), jattn.dequantize_kv(jq, js), 0.0)


def test_flash_decode_with_scales_matches_jax():
    rng = np.random.default_rng(1)
    b, s, nq, nkv, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, 1, nq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, nkv, d)).astype(np.float32)
            for _ in range(2))
    (jkq, jks), (jvq, jvs) = (jattn.quantize_kv(jnp.asarray(a))
                              for a in (k, v))
    (tkq, tks), (tvq, tvs) = (tattn.quantize_kv(torch.as_tensor(a))
                              for a in (k, v))
    for window in (0, 24):
        want = jflash.flash_decode(
            jnp.asarray(q), jkq, jvq, scale=d ** -0.5,
            cache_index=jnp.asarray(40), window=window, block_kv=16,
            k_scale=jks, v_scale=jvs)
        got = tflash.flash_decode(
            torch.as_tensor(q), tkq, tvq, scale=d ** -0.5, cache_index=40,
            window=window, block_kv=16, k_scale=tks, v_scale=tvs)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("over", [FLASH, NAIVE], ids=["flash", "naive"])
def test_quantized_decode_steps_match_jax(over):
    """Six decode steps on a global layer's int8 cache from a quantized
    prefill of 20 tokens: flash-decode with the scales (flash) or the
    dequantized masked path (naive); the codes written are JAX's."""
    over = dict(over, quantized_kv=True)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("gemma2-27b"),
                               **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("gemma2-27b"),
                               **over)
    # weights in 1/16 steps, activations in 1/8 steps, both at most 1/2:
    # every product is a multiple of 2^-7 and every projection an exact
    # f32 sum in any order, so both packages quantize the same floats
    # (no rope: its tables differ in the last bit)
    jcfg = dataclasses.replace(jcfg, rope_type="none")
    tcfg = dataclasses.replace(tcfg, rope_type="none")
    rng = np.random.default_rng(2)
    jp = {k: jnp.asarray(rng.integers(-8, 9, np.shape(v)) / 16.0,
                         jnp.float32)
          for k, v in jattn.init_attention(jax.random.PRNGKey(2),
                                           jcfg).items()}
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    b, s, steps = 2, 20, 6
    x = (rng.integers(-4, 5, (b, s + steps, jcfg.d_model)) / 8.0).astype(
        np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    _, kv = tattn.attention(tp, torch.as_tensor(x[:, :s]), tcfg,
                            positions=torch.as_tensor(pos))
    assert kv["k"].abs().max() > 1.0
    jcache = jattn.init_kv_cache(b, s + steps, jcfg, quantized=True)
    tcache = tattn.init_kv_cache(b, s + steps, tcfg, quantized=True,
                                 device="cpu")
    for name in ("k", "v"):
        codes, scale = tattn.quantize_kv(kv[name])
        tcache[name][:, :s] = codes
        tcache[f"{name}_scale"][:, :s] = scale
        jcache[name] = jnp.asarray(tcache[name].numpy())
        jcache[f"{name}_scale"] = jnp.asarray(tcache[f"{name}_scale"].numpy())
    for i in range(steps):
        idx = s + i
        xi = x[:, idx:idx + 1]
        jo, jcache = jattn.attention(
            jp, jnp.asarray(xi), jcfg, positions=jnp.full((b, 1), idx),
            kv_cache=jcache, cache_index=jnp.int32(idx))
        to, tcache = tattn.attention(
            tp, torch.as_tensor(xi), tcfg, positions=torch.full((b, 1), idx),
            kv_cache=tcache, cache_index=idx)
        _close(to, jo, 1e-4)
    for name in ("k", "v", "k_scale", "v_scale"):
        _codes_equal(tcache[name], jcache[name])


def test_quantized_prefill_cache_matches_jax():
    """The prefill caches: int8 codes and scales on the global layers
    (every code within one of JAX's, at most 1 in 1000 off; scales, the
    heads' amax / 127, within 1e-4 / 127 as the K/V floats are within
    1e-4), the local ring in the activations' dtype."""
    jm, jp, tm, tp = _pair("gemma2-27b", dict(FLASH, quantized_kv=True))
    toks = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _, jc = jm.apply(jp, jnp.asarray(toks), mode="prefill")
    tl, _, tc = tm.apply(tp, torch.as_tensor(toks), mode="prefill")
    _close(tl, jl, 1e-4)
    kinds = dict(zip(("b0", "b1"), tm.cfg.block_pattern))
    for key, kind in kinds.items():
        assert set(tc[key]) == set(jc[key])
        if kind == "global":
            assert tc[key]["k"].dtype == torch.int8
            for name in ("k", "v"):
                off = np.abs(tc[key][name].numpy().astype(int)
                             - np.asarray(jc[key][name]).astype(int))
                assert off.max() <= 1 and off.sum() <= off.size // 1000
                np.testing.assert_allclose(
                    tc[key][f"{name}_scale"].numpy(),
                    np.asarray(jc[key][f"{name}_scale"]), rtol=0,
                    atol=1e-4 / 127)
        else:
            assert tc[key]["k"].dtype == torch.float32
            _close(tc[key]["k"], jc[key]["k"], 1e-4)


@pytest.mark.parametrize("over", [FLASH, NAIVE], ids=["flash", "naive"])
def test_greedy_generate_with_int8_caches_matches_jax(over):
    """Equal tokens; the prefill's logits within 1e-4.  Here one of the
    global layer's 6,144 prefill V codes sits on a rounding edge and takes
    the neighbouring code in the port (its float is the JAX package's to
    the last bit): one code step (the head's amax / 127) in one cached
    value moves the decode logits by up to 3.5e-4, so they are held within
    1e-3."""
    check_greedy_against_jax("gemma2-27b", dict(over, quantized_kv=True),
                             new_tokens=16, decode_tol=1e-3)
