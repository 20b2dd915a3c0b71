"""The port's RG-LRU block (``repro_torch.models.rglru``) and the
recurrentgemma family held against the JAX package on the CPU: the causal
conv, the log-depth scan against ``jax.lax.associative_scan`` (with and
without an initial state), the decode step, the block in train and
decode, the prefill cache (final state and conv tail), a model with a
``block_pattern_suffix``, and greedy generation against the JAX serving
loop.

Inputs come from numpy seeds; everything runs in f32.  The scan combines
its pairs in another tree order than JAX's, so it is held within 1e-5;
model outputs and caches within 1e-4.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.transformer import TransformerLM as JLM  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.models.transformer import (TransformerLM,  # noqa: E402
                                            tree_leaves)
from test_torch_lm import _close, check_greedy_against_jax  # noqa: E402

ARCH = "recurrentgemma-2b"


def _setup(seed=0):
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    jp = jrg.init_rglru(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("s", [1, 7, 300])
def test_scan_matches_associative_scan(s):
    """S = 1 (no doubling step), a short ragged S, and 300 positions (nine
    doubling steps) with decays near 1, so early inputs still count."""
    jcfg, _, jp, tp = _setup()
    rng = np.random.default_rng(s)
    width = jcfg.rglru_width
    u = rng.standard_normal((2, s, width)).astype(np.float32)
    h0 = rng.standard_normal((2, width)).astype(np.float32)
    for init in (None, h0):
        jh, jlast = jrg.rglru_scan(jnp.asarray(u), jp,
                                   None if init is None else jnp.asarray(init))
        th, tlast = trg.rglru_scan(torch.as_tensor(u), tp,
                                   None if init is None
                                   else torch.as_tensor(init))
        assert tlast.dtype == torch.float32
        _close(th, jh, 1e-5)
        _close(tlast, jlast, 1e-5)


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    b = rng.standard_normal((2, 37, 5)).astype(np.float32)
    want, h = np.zeros_like(b), np.zeros((2, 5), np.float32)
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = trg.linear_scan(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_conv_and_step_match_jax():
    jcfg, _, jp, tp = _setup(1)
    rng = np.random.default_rng(1)
    width = jcfg.rglru_width
    u = rng.standard_normal((2, 9, width)).astype(np.float32)
    tail = rng.standard_normal((2, 3, width)).astype(np.float32)
    for t in (None, tail):
        jy, jt = jrg._causal_conv(jnp.asarray(u), jp["conv_w"],
                                  jp["conv_b"],
                                  None if t is None else jnp.asarray(t))
        ty, tt = trg._causal_conv(torch.as_tensor(u), tp["conv_w"],
                                  tp["conv_b"],
                                  None if t is None else torch.as_tensor(t))
        _close(ty, jy, 1e-6)
        _close(tt, jt, 0.0)
    h = rng.standard_normal((2, width)).astype(np.float32)
    jo, jh = jrg.rglru_step(jnp.asarray(u[:, 0]), jp, jnp.asarray(h))
    to, th = trg.rglru_step(torch.as_tensor(u[:, 0]), tp, torch.as_tensor(h))
    _close(to, jo, 1e-6)
    _close(th, jh, 1e-6)


def test_block_train_prefill_cache_and_decode_match_jax():
    """The block over 20 positions; the prefill cache (the scan's final
    state and the pre-conv tail, from the one scan) equals the state the
    JAX package's prefill computes; then 4 decode steps from it."""
    jcfg, tcfg, jp, tp = _setup(2)
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((2, 24, jcfg.d_model))).astype(np.float32)
    jout, _ = jrg.apply_rglru(jp, jnp.asarray(x[:, :20]), jcfg)
    tout, cache = trg.apply_rglru(tp, torch.as_tensor(x[:, :20]), tcfg,
                                  return_cache=True)
    _close(tout, jout, 1e-4)
    # the JAX package's prefill cache (transformer.py:135-147)
    u0 = jnp.asarray(x[:, :20]) @ jp["w_u"]
    u, jtail = jrg._causal_conv(u0, jp["conv_w"], jp["conv_b"], None)
    _, jlast = jrg.rglru_scan(u, jp)
    _close(cache.h, jlast, 1e-5)
    _close(cache.conv, jtail, 1e-6)
    jcache = jrg.RGLRUCache(h=jlast, conv=jtail)
    for t in range(20, 24):
        jo, jcache = jrg.apply_rglru(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                     jcache)
        to, cache = trg.apply_rglru(tp, torch.as_tensor(x[:, t:t + 1]),
                                    tcfg, cache)
        _close(to, jo, 1e-4)
    _close(cache.h, jcache.h, 1e-4)
    _close(cache.conv, jcache.conv, 1e-6)


def test_suffix_model_prefill_and_decode_match_jax():
    """recurrentgemma's layout in small: (recurrent, local) x 2 plus a
    trailing recurrent layer in ``block_pattern_suffix``; a prefill of 16
    tokens (the 8-slot ring wraps), then 4 decode steps."""
    fields = dict(name="sfx", family="hybrid", num_layers=5, d_model=64,
                  num_heads=4, num_kv_heads=1, d_ff=96, vocab_size=61,
                  block_pattern=("recurrent", "local"), window_size=8,
                  block_pattern_suffix=("recurrent",), gated_mlp=True,
                  activation="gelu", embedding_scale=True)
    jm = JLM(JConfig(**fields))
    tm = TransformerLM(TConfig(**fields), device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm.cfg,
                            device="cpu")
    assert "suffix_blocks" in tp
    toks = np.random.default_rng(4).integers(0, 61, (2, 20)).astype(np.int32)
    japply = jax.jit(jm.apply, static_argnames=("mode",))
    jdecode = jax.jit(jm.decode_step)
    jl, _, _ = japply(jp, jnp.asarray(toks))
    tl, _, _ = tm.apply(tp, torch.as_tensor(toks))
    _close(tl, jl, 1e-4)
    _, _, jc = japply(jp, jnp.asarray(toks[:, :16]), mode="prefill")
    _, _, tc = tm.apply(tp, torch.as_tensor(toks[:, :16]), mode="prefill")
    for a, t in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        _close(t, a, 1e-4)
    for i in range(16, 20):
        jlg, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                          jnp.asarray(i, jnp.int32))
        tlg, tc = tm.decode_step(tp, tc, torch.as_tensor(toks[:, i:i + 1]),
                                 i)
        _close(tlg, jlg, 1e-4)
        _close(tlg[:, 0], jl[:, i], 1e-4)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_greedy_generate_matches_the_jax_serving_loop(impl):
    """A 16-slot window under 24-token prompts: the local ring wraps in
    prefill and in decode; the recurrent caches carry the states."""
    check_greedy_against_jax(ARCH, dict(attn_impl=impl, window_size=16))
