"""The port's M-RoPE (``repro_torch.models.vlm``, ``layers.mrope_tables``)
and the qwen2-vl family held against the JAX package on the CPU: the
[3, B, S] position ids bitwise (prefill and decode, square and explicit
grids, no patches), the cos/sin tables, the model with vision embeddings
overwriting the first positions, and greedy generation against the JAX
serving loop.

Inputs come from numpy seeds; everything runs in f32.  Ids are compared
exactly, tables within 1e-6 plus the angle's rounding at the largest
position, model outputs within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jL  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402

from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from test_torch_lm import (_close, _pair, check_greedy_against_jax,  # noqa
                           family_inputs)

ARCH = "qwen2-vl-7b"


@pytest.mark.parametrize("batch,seq_len,patches,grid", [
    (2, 24, 16, None), (1, 40, 10, None), (3, 30, 12, (3, 4)),
    (2, 20, 12, (2, 4)), (2, 9, 0, None), (1, 256, 256, None)])
def test_mrope_positions_bitwise(batch, seq_len, patches, grid):
    """Square grids (ceil(sqrt(P)) a side, a ragged last row at P = 10),
    explicit grids (h clamped to its last row when P > gh * gw), no
    patches, and qwen2-vl's 16 x 16."""
    want = np.asarray(jvlm.mrope_positions(batch, seq_len, patches, grid))
    got = tvlm.mrope_positions(batch, seq_len, patches, grid, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, batch, seq_len)
    assert np.array_equal(got.numpy(), want)
    for idx in (seq_len, seq_len + 7):
        want = np.asarray(jvlm.mrope_decode_positions(
            batch, jnp.asarray(idx, jnp.int32), patches, grid))
        got = tvlm.mrope_decode_positions(batch, idx, patches, grid,
                                          device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("head_dim,sections,theta", [
    (64, (8, 12, 12), 1e6), (128, (16, 24, 24), 1e6), (16, (2, 3, 3), 1e4)])
def test_mrope_tables_match_jax(head_dim, sections, theta):
    pos = tvlm.mrope_positions(2, 300, 256, device="cpu")
    jc, js = jL.mrope_tables(jnp.asarray(pos.numpy()), head_dim, theta,
                             sections)
    tc, ts = tL.mrope_tables(pos, head_dim, theta, sections)
    assert tc.shape == (2, 300, head_dim // 2)
    # an ulp of a frequency is p ulps of the angle at position p
    atol = 1e-6 + int(pos.max()) * 2.0 ** -23
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=atol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=atol)
    with pytest.raises(ValueError, match="sections"):
        tL.mrope_tables(pos, head_dim + 2, theta, sections)


def test_vlm_apply_matches_jax():
    """Train and prefill with 16 vision patches over the first positions
    and M-RoPE ids; the prefill caches hold the M-RoPE-rotated keys."""
    jm, jp, tm, tp = _pair(ARCH, {})
    cfg = tm.cfg
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    ve = family_inputs(cfg, 2, "cpu")["vision_embeds"]
    pos = tvlm.mrope_positions(2, 24, cfg.vision_patches, device="cpu")
    for mode in ("train", "prefill"):
        jl, _, jc = jm.apply(jp, jnp.asarray(toks),
                             positions_thw=jnp.asarray(pos.numpy()),
                             vision_embeds=jnp.asarray(ve.numpy()),
                             mode=mode)
        tl, _, tc = tm.apply(tp, torch.as_tensor(toks), positions_thw=pos,
                             vision_embeds=ve, mode=mode)
        _close(tl, jl, 1e-4)
        if mode == "prefill":
            _close(tc["b0"]["k"], jc["b0"]["k"], 1e-4)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_greedy_generate_matches_the_jax_serving_loop(impl):
    """16 patches of a 4 x 4 grid, then text; decode continues the text
    positions past the grid."""
    check_greedy_against_jax(ARCH, dict(attn_impl=impl))
