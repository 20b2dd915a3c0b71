"""The port's encoder-decoder (``repro_torch.models.encdec``, Whisper)
held against the JAX package on the CPU: the sinusoidal positions, the
encoder, the decoder in train, prefill and decode modes (self-attention
caches written in place, cross-attention over the encoder states every
step), the learned positions' clamp, ``apply`` and ``loss``, the
converter's checks, and greedy generation against the JAX serving loop.

Inputs come from numpy seeds; everything runs in f32.  Tolerances: 1e-6
for the positions, 1e-4 for model outputs, caches and loss.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402

from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from test_torch_lm import (_close, _pair, check_greedy_against_jax,  # noqa
                           family_inputs)

ARCH = "whisper-tiny"


@pytest.mark.parametrize("seq_len,dim", [(32, 256), (1500, 384), (5, 2)])
def test_sinusoidal_positions_match_jax(seq_len, dim):
    """Whisper's table, and D = 2, where the divisor max(D/2 - 1, 1) is 1.
    The exponents are bitwise JAX's; XLA's f32 ``exp`` on the CPU is off
    the correctly rounded result by one ulp in 22 of Whisper's 192
    frequencies (torch's in 2), and position p turns an ulp of a frequency
    into p ulps of the angle: the table is held within 1e-6 plus
    p * 2^-23 at its last position p."""
    idx = np.arange(dim // 2, dtype=np.float32)
    arg = -np.log(np.float32(10_000.0)) * idx / max(dim // 2 - 1, 1)
    want = np.asarray(jL.sinusoidal_positions(seq_len, dim))
    got = tL.sinusoidal_positions(seq_len, dim, "cpu").numpy()
    inv = np.exp(arg.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got[1, :dim // 2], np.sin(inv), atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 + (seq_len - 1) * 2.0 ** -23)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_encode_and_decode_modes_match_jax(impl):
    """encode; decode in train and prefill (logits, stacked caches); then
    4 decode steps from the prefill caches padded to the horizon."""
    jm, jp, tm, tp = _pair(ARCH, dict(attn_impl=impl))
    cfg = tm.cfg
    frames = family_inputs(cfg, 2, "cpu")["frame_embeds"]
    jenc = jax.jit(jm.encode)(jp, jnp.asarray(frames.numpy()))
    tenc = tm.encode(tp, frames)
    _close(tenc, jenc, 1e-4)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jdecode = jax.jit(jm.decode, static_argnames=("mode",))
    jl, _ = jdecode(jp, jnp.asarray(toks), jenc, mode="train")
    tl, tc = tm.decode(tp, torch.as_tensor(toks), tenc, mode="train")
    _close(tl, jl, 1e-4)
    assert tc is None
    jl, jc = jdecode(jp, jnp.asarray(toks[:, :16]), jenc, mode="prefill")
    tl, tc = tm.decode(tp, torch.as_tensor(toks[:, :16]), tenc,
                       mode="prefill")
    _close(tl, jl, 1e-4)
    for a, t in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        assert tuple(t.shape) == a.shape == (cfg.num_layers, 2, 16,
                                             cfg.num_kv_heads, 64)
        _close(t, a, 1e-4)
    pad = lambda c: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]), c)
    jc = pad(jc)
    tc = {k: torch.as_tensor(np.array(v)) for k, v in jc.items()}
    jstep = jax.jit(jm.decode_step)
    full, _ = jdecode(jp, jnp.asarray(toks), jenc, mode="train")
    for i in range(16, 20):
        jlg, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                        jnp.asarray(i, jnp.int32), jenc)
        tlg, tc = tm.decode_step(tp, tc, torch.as_tensor(toks[:, i:i + 1]),
                                 i, tenc)
        _close(tlg, jlg, 1e-4)
        _close(tlg[:, 0], full[:, i], 1e-4)
    for a, t in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
        _close(t, a, 1e-4)


def test_learned_positions_clamp_as_dynamic_slice():
    """The decoder's position rows start at the offset, clamped so the
    slice stays inside the table (``dynamic_slice_in_dim``)."""
    jm, jp, tm, tp = _pair(ARCH, {})
    rows = tp["dec_pos"].shape[0]
    toks = np.array([[3, 7, 11]], np.int32)
    for offset in (0, 5, rows - 3, rows - 1, rows + 40):
        _close(tm._dec_embed(tp, torch.as_tensor(toks), offset),
               jm._dec_embed(jp, jnp.asarray(toks), offset), 0.0)


def test_apply_and_loss_match_jax():
    jm, jp, tm, tp = _pair(ARCH, dict(attn_impl="flash"))
    frames = family_inputs(tm.cfg, 2, "cpu", seed=6)["frame_embeds"]
    toks = np.random.default_rng(6).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jaux, _ = jm.apply(jp, jnp.asarray(toks),
                           frame_embeds=jnp.asarray(frames.numpy()))
    tl, taux, _ = tm.apply(tp, torch.as_tensor(toks), frame_embeds=frames)
    _close(tl, jl, 1e-4)
    assert float(taux) == float(jaux) == 0.0
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    _close(tm.loss(tp, {**{k: torch.as_tensor(v) for k, v in batch.items()},
                        "frame_embeds": frames}),
           jm.loss(jp, {**{k: jnp.asarray(v) for k, v in batch.items()},
                        "frame_embeds": jnp.asarray(frames.numpy())}), 1e-4)


def test_lm_params_from_jax_checks_the_encoder_decoder_tree():
    _, jp, tm, _ = _pair(ARCH, {})
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="top-level keys"):
        lm_params_from_jax({k: v for k, v in np_p.items() if k != "dec_pos"},
                           tm.cfg, device="cpu")
    bad = dict(np_p, enc_layers=jax.tree_util.tree_map(
        lambda a: a[:1], np_p["enc_layers"]))
    with pytest.raises(ValueError, match="stacked"):
        lm_params_from_jax(bad, tm.cfg, device="cpu")
    bad_cfg = dataclasses.replace(tm.cfg, encoder_layers=3)
    with pytest.raises(ValueError, match="stacked"):
        lm_params_from_jax(np_p, bad_cfg, device="cpu")


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_greedy_generate_matches_the_jax_serving_loop(impl):
    """The audio frames are encoded once; every decode step attends them
    (on the flash path through the kernel's plain version, one call per
    decoder layer)."""
    check_greedy_against_jax(ARCH, dict(attn_impl=impl))
