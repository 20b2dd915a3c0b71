"""The port's LM serving path held against the JAX package on the CPU:
the copied configs and token stream, the layers, attention (prefill,
ring-buffer decode across wraps, flash-decode on global caches), the
chunked SSD, ``TransformerLM.apply`` (train and prefill logits and
caches) and the greedy serving loop of ``examples/serve_decode.py``.

Both packages get the same numbers: the JAX model's parameters go
through ``repro_torch.convert.lm_params_from_jax``, other inputs come
from numpy.  Everything runs in f32; tolerances are 1e-4 for model
outputs (logits, caches) and 2e-5 for single layers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.data import synthetic_lm_tokens as jax_tokens  # noqa: E402
from repro.launch.steps import build_model as jbuild  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import synthetic_lm_tokens  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.models.vlm import mrope_positions  # noqa: E402

# the smoke configs with the flash path exercised: GQA (4 q heads over 2
# kv heads), 16-wide blocks, and a window shorter than the prompt so the
# window mask binds and the local ring buffer wraps during decode
FLASH = dict(attn_impl="flash", flash_block_q=16, flash_block_kv=16,
             num_kv_heads=2, window_size=16)
NAIVE = dict(attn_impl="naive", num_kv_heads=2, window_size=16)
CASES = [("gemma2-27b", FLASH), ("gemma2-27b", NAIVE), ("mamba2-130m", {})]
IDS = ["gemma2-flash", "gemma2-naive", "mamba2"]


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _shapes(tree, path=()):
    """{key path: shape} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, path + (k,)))
        return out
    return {path: tuple(tree.shape)}


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _pair(arch, over):
    """(JAX model, its params, port model, the same params converted)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **over)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tsteps.build_model(tcfg, device="cpu")
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                            device="cpu")
    return jm, jp, tm, tp


# --------------------------------------------------------------------------
# copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_configs_equal_the_originals_field_for_field(arch):
    js, ts = jconfigs.get_spec(arch), tconfigs.get_spec(arch)
    assert dataclasses.asdict(js.config) == dataclasses.asdict(ts.config)
    assert (js.citation, js.long_context_ok, js.decode_ok, js.skip_note) == \
        (ts.citation, ts.long_context_ok, ts.decode_ok, ts.skip_note)
    assert dataclasses.asdict(jconfigs.get_smoke_config(arch)) == \
        dataclasses.asdict(tconfigs.get_smoke_config(arch))
    assert js.config.param_count() == ts.config.param_count()


def test_synthetic_lm_tokens_bitwise():
    for args in ((4, 24, 512, 1), (2, 33, 50280, 7)):
        a, b = jax_tokens(*args), synthetic_lm_tokens(*args)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_build_model_builds_every_family():
    """Every registered arch's smoke config builds, initialises the JAX
    package's parameter tree (keys and shapes) and runs a forward."""
    from repro_torch.models.encdec import EncoderDecoderLM
    for arch in sorted(tconfigs.ARCHS):
        cfg = tconfigs.get_smoke_config(arch)
        model = tsteps.build_model(cfg, device="cpu")
        assert isinstance(model, EncoderDecoderLM) == cfg.is_encoder_decoder
        params = model.init(torch.Generator().manual_seed(0))
        jp = jax.eval_shape(jbuild(jconfigs.get_smoke_config(arch)).init,
                            jax.random.PRNGKey(0))
        assert _shapes(params) == _shapes(jp), arch
        toks = torch.zeros((1, 24), dtype=torch.long)
        kw = family_inputs(cfg, 1, "cpu")
        if cfg.family == "vlm":
            kw["positions_thw"] = mrope_positions(1, 24, cfg.vision_patches,
                                                  device="cpu")
        logits, aux, _ = model.apply(params, toks, **kw)
        assert logits.shape == (1, 24, cfg.vocab_size), arch
        assert torch.isfinite(logits).all() and torch.isfinite(aux), arch


def test_dryrun_config_is_bf16_flash_without_a_mesh():
    cfg = tsteps.dryrun_config(tconfigs.get_config("gemma2-27b"))
    assert (cfg.param_dtype, cfg.dtype, cfg.attn_impl, cfg.batch_axes) == \
        ("bfloat16", "bfloat16", "flash", ())
    assert round(cfg.param_count() / 1e9, 2) == 27.23


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = 0.1 * rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    _close(tL.rms_norm(_t(x), _t(w)), jL.rms_norm(jnp.asarray(x), w), 2e-5)
    _close(tL.layer_norm(_t(x), _t(w), _t(bias)),
           jL.layer_norm(jnp.asarray(x), w, bias), 2e-5)
    pos = np.tile(np.arange(5), (2, 1))
    (jc, js), (tc, ts) = (jL.rope_tables(jnp.asarray(pos), 8, 1e4),
                          tL.rope_tables(torch.as_tensor(pos), 8, 1e4))
    _close(tc, jc, 2e-5)
    _close(ts, js, 2e-5)
    xh = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    _close(tL.apply_rotary(_t(xh), tc, ts),
           jL.apply_rotary(jnp.asarray(xh), jc, js), 2e-5)
    mlp = {k: (0.2 * rng.standard_normal(s)).astype(np.float32)
           for k, s in (("w_up", (16, 24)), ("w_gate", (16, 24)),
                        ("w_down", (24, 16)))}
    for act in ("gelu", "silu"):
        for gated in (True, False):
            p = mlp if gated else {k: v for k, v in mlp.items()
                                   if k != "w_gate"}
            _close(tL.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x),
                                act, gated),
                   jL.apply_mlp(p, jnp.asarray(x), act, gated), 2e-5)
    _close(tL.softcap(_t(10 * x), 3.0), jL.softcap(jnp.asarray(10 * x), 3.0),
           2e-5)
    labels = rng.integers(0, 16, (2, 5))
    _close(tL.token_nll(_t(x), torch.as_tensor(labels)),
           jL.token_nll(jnp.asarray(x), jnp.asarray(labels)), 2e-5)


# --------------------------------------------------------------------------
# attention and SSD
# --------------------------------------------------------------------------

def _attn_setup(over, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("gemma2-27b"),
                               **over)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("gemma2-27b"),
                               **over)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("over", [FLASH, NAIVE], ids=["flash", "naive"])
@pytest.mark.parametrize("kind", ["global", "local"])
def test_attention_prefill_and_decode_match_jax(over, kind):
    """Prefill over 20 tokens, then 6 decode steps.  With a 16-slot
    window the local ring wraps; global layers take flash-decode (flash)
    or the masked plain path (naive)."""
    jcfg, tcfg, jp, tp = _attn_setup(over)
    rng = np.random.default_rng(1)
    b, s, steps, d = 2, 20, 6, jcfg.d_model
    x = (0.5 * rng.standard_normal((b, s + steps, d))).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1))
    jout, _ = jattn.attention(jp, jnp.asarray(x[:, :s]), jcfg, kind=kind,
                              positions=jnp.asarray(pos))
    tout, kv = tattn.attention(tp, _t(x[:, :s]), tcfg, kind=kind,
                               positions=torch.as_tensor(pos))
    _close(tout, jout, 2e-5)
    # decode caches: the rotated prefill keys, ring-placed for local layers
    total = s + steps
    ring = min(total, tcfg.window_size) if kind == "local" else total
    jcache = {n: np.zeros((b, ring) + kv[n].shape[2:], np.float32)
              for n in ("k", "v")}
    keep = range(s - ring, s) if kind == "local" else range(s)
    for p in keep:
        for n in ("k", "v"):
            jcache[n][:, p % ring] = kv[n][:, p].numpy()
    tcache = {n: _t(v) for n, v in jcache.items()}
    jcache = {n: jnp.asarray(v) for n, v in jcache.items()}
    for i in range(steps):
        idx = s + i
        xi = x[:, idx:idx + 1]
        jo, jcache = jattn.attention(
            jp, jnp.asarray(xi), jcfg, kind=kind,
            positions=jnp.full((b, 1), idx), kv_cache=jcache,
            cache_index=jnp.int32(idx))
        to, tcache = tattn.attention(
            tp, _t(xi), tcfg, kind=kind,
            positions=torch.full((b, 1), idx), kv_cache=tcache,
            cache_index=idx)
        _close(to, jo, 2e-5)
    _close(tcache["k"], jcache["k"], 2e-5)


@pytest.mark.parametrize("s,chunk", [(37, 16), (32, 8), (5, 16)])
def test_ssd_chunked_and_decode_match_jax(s, chunk):
    """S not a chunk multiple (padding), several chunks with a carried
    state, and a decode step from the final state."""
    rng = np.random.default_rng(s)
    b, nh, hd, n = 2, 3, 8, 4
    x = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, nh)).astype(np.float32)
    bi, ci = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((b, nh, hd, n)).astype(np.float32)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bi, ci)),
                              chunk, initial_state=jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(_t, (x, dt, a_log, bi, ci)), chunk,
                              initial_state=_t(h0))
    _close(ty, jy, 1e-4)
    _close(th, jh, 1e-4)
    jy1, jh1 = jssm.ssd_decode_step(*map(jnp.asarray, (
        x[:, 0], dt[:, 0], a_log, bi[:, 0], ci[:, 0])), jh)
    ty1, th1 = tssm.ssd_decode_step(*map(_t, (
        x[:, 0], dt[:, 0], a_log, bi[:, 0], ci[:, 0])), th)
    _close(ty1, jy1, 1e-4)
    _close(th1, jh1, 1e-4)


# --------------------------------------------------------------------------
# the model and the serving loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_transformer_apply_matches_jax(arch, over):
    jm, jp, tm, tp = _pair(arch, over)
    toks = np.random.default_rng(3).integers(
        0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    for mode in ("train", "prefill"):
        jl, _, jcache = jm.apply(jp, jnp.asarray(toks), mode=mode)
        tl, aux, tcache = tm.apply(tp, torch.as_tensor(toks), mode=mode)
        _close(tl, jl, 1e-4)
        assert float(aux) == 0.0
        if mode == "train":
            assert tcache is None
            continue
        jleaves = jax.tree_util.tree_leaves(jcache)
        tleaves = list(tree_leaves(tcache))
        assert [tuple(a.shape) for a in jleaves] == \
            [tuple(t.shape) for t in tleaves]
        for a, t in zip(jleaves, tleaves):
            _close(t, a, 1e-4)
    labels = np.roll(toks, -1, axis=1)
    batch = {"tokens": toks, "labels": labels}
    _close(tm.loss(tp, {k: torch.as_tensor(v) for k, v in batch.items()}),
           jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}), 1e-4)


def family_inputs(cfg, batch: int, device, seed: int = 2) -> dict:
    """The modality inputs of ``cfg``'s family, from a numpy seed: audio
    frames ``frame_embeds`` [B, T_enc, d] and VLM patches
    ``vision_embeds`` [B, P, d] (f32), or nothing."""
    rng = np.random.default_rng(seed)
    if cfg.is_encoder_decoder:
        return {"frame_embeds": torch.as_tensor(rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32),
            device=device)}
    if cfg.family == "vlm":
        return {"vision_embeds": torch.as_tensor(rng.standard_normal(
            (batch, cfg.vision_patches, cfg.d_model)).astype(np.float32),
            device=device)}
    return {}


def jax_serve(jcfg, jm, jp, prompts, new_tokens, extra=None):
    """The JAX package's serving loop for any family: its
    ``make_prefill_step`` (frames or patches in the batch), the caches
    padded against ``init_cache`` as examples/serve_decode.py pads them,
    then ``make_serve_step`` (Whisper's encoder states in the batch)."""
    from repro.launch.steps import make_prefill_step, make_serve_step
    extra = {k: jnp.asarray(v.numpy()) for k, v in (extra or {}).items()}
    prefill, serve = make_prefill_step(jcfg), make_serve_step(jcfg)
    b, prompt_len = prompts.shape
    logits, cache = prefill(jp, {"tokens": prompts, **extra})
    ref_cache = jm.init_cache(b, prompt_len + new_tokens)
    cache = jax.tree_util.tree_map(
        lambda cp, cf: jnp.pad(cp, [(0, cf.shape[i] - cp.shape[i])
                                    for i in range(cp.ndim)]),
        cache, ref_cache)
    step_extra = {}
    if jcfg.is_encoder_decoder:
        step_extra["enc_states"] = jm.encode(jp, extra["frame_embeds"])
    serve = jax.jit(serve)
    tok = jnp.argmax(logits, axis=-1)[:, None]
    toks, all_logits = [tok], [logits]
    for i in range(new_tokens - 1):
        logits, cache = serve(jp, cache, {
            "tokens": tok, "cache_index": jnp.asarray(prompt_len + i,
                                                      jnp.int32),
            **step_extra})
        tok = jnp.argmax(logits, axis=-1)[:, None]
        toks.append(tok)
        all_logits.append(logits)
    return np.asarray(jnp.concatenate(toks, axis=1)), all_logits


def check_greedy_against_jax(arch, over, new_tokens=12, batch=2,
                             prompt_len=24, decode_tol=1e-4):
    """Greedy generation through the port's ``greedy_generate`` against
    the JAX serving loop: equal tokens, the prefill's logits within 1e-4
    and every decode step's within ``decode_tol``."""
    jm, jp, tm, tp = _pair(arch, over)
    prompts = synthetic_lm_tokens(batch, prompt_len, tm.cfg.vocab_size,
                                  seed=1)
    extra = family_inputs(tm.cfg, batch, "cpu")
    jtoks, jlogits = jax_serve(jm.cfg, jm, jp, jnp.asarray(prompts),
                               new_tokens, extra)
    ttoks, tlogits = greedy_generate(tm, tp, torch.as_tensor(prompts),
                                     new_tokens, **extra)
    assert np.array_equal(ttoks.numpy(), jtoks)
    _close(tlogits[0], jlogits[0], 1e-4)
    for t, j in zip(tlogits[1:], jlogits[1:]):
        _close(t, j, decode_tol)


def _jax_greedy(jm, jp, prompts, new_tokens):
    """The loop of examples/serve_decode.py."""
    prompt_len = prompts.shape[1]
    logits, _, cache = jax.jit(
        lambda p, t: jm.apply(p, t, mode="prefill"))(jp, prompts)
    ref_cache = jm.init_cache(prompts.shape[0], prompt_len + new_tokens)
    cache = jax.tree_util.tree_map(
        lambda cp, cf: jnp.pad(cp, [(0, cf.shape[i] - cp.shape[i])
                                    for i in range(cp.ndim)]),
        cache, ref_cache)
    decode = jax.jit(jm.decode_step)
    last = logits[:, -1, :]
    tok = jnp.argmax(last, axis=-1)[:, None]
    toks, all_logits = [tok], [last]
    for i in range(new_tokens - 1):
        lg, cache = decode(jp, cache, tok,
                           jnp.asarray(prompt_len + i, jnp.int32))
        tok = jnp.argmax(lg[:, -1, :], axis=-1)[:, None]
        toks.append(tok)
        all_logits.append(lg[:, -1, :])
    return np.asarray(jnp.concatenate(toks, axis=1)), all_logits


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_greedy_generate_matches_the_jax_serving_loop(arch, over):
    """24-token prompts, 16 new tokens: the 16-slot local rings wrap in
    prefill and again during decode."""
    jm, jp, tm, tp = _pair(arch, over)
    prompts = synthetic_lm_tokens(3, 24, tm.cfg.vocab_size, seed=1)
    jtoks, jlogits = _jax_greedy(jm, jp, jnp.asarray(prompts), 16)
    ttoks, tlogits = greedy_generate(tm, tp, torch.as_tensor(prompts), 16)
    assert np.array_equal(ttoks.numpy(), jtoks)
    for t, j in zip(tlogits, jlogits):
        _close(t, j, 1e-4)


def test_lm_params_from_jax_checks_the_tree():
    _, jp, tm, _ = _pair("mamba2-130m", {})
    np_p = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match="top-level keys"):
        lm_params_from_jax({k: v for k, v in np_p.items() if k != "embed"},
                           tm.cfg, device="cpu")
    bad = dict(np_p, blocks={"b0": jax.tree_util.tree_map(
        lambda a: a[:1], np_p["blocks"]["b0"])})
    with pytest.raises(ValueError, match="stacked"):
        lm_params_from_jax(bad, tm.cfg, device="cpu")
    bf16 = lm_params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16)), jp), tm.cfg, device="cpu")
    assert bf16["embed"].dtype == torch.bfloat16


def test_port_init_runs_the_smoke_model():
    """The port's own init (torch generator, stacked layer by layer) gives
    finite outputs of the reference's shapes, and the same seed the same
    parameters."""
    cfg = tconfigs.get_smoke_config("gemma2-27b")
    model = tsteps.build_model(cfg, device="cpu")
    p1 = model.init(torch.Generator().manual_seed(0))
    p2 = model.init(torch.Generator().manual_seed(0))
    _, jp, _, _ = _pair("gemma2-27b", {})
    assert _shapes(p1) == _shapes(jp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                 tree_leaves(p2)))
    logits, _, _ = model.apply(p1, torch.zeros((1, 8), dtype=torch.long))
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
