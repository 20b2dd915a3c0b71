"""LM training in the port, held against the JAX package on the CPU:
``make_train_step`` (gemma-2b with the flash path forced, microbatch 1
and 2, remat on and off; mamba2-130m; the encoder-decoder and VLM
branches), ``make_fl_round_step`` with given coefficients, the
optimizers and the cosine schedule, the batch iterators (bitwise), and
the ``launch/train.py`` driver's save, resume and a JAX-written
checkpoint restored in the port.  Parameters come across through
``convert.lm_params_from_jax``; batches from numpy seeds.  Tolerance
2e-5 (f32) unless a test states another."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.schedule import cosine as jcosine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import batch_iterator, lm_batches  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as tdriver  # noqa: E402
from repro_torch.optim import (SGD, AdamW, apply_updates,  # noqa: E402
                               cosine)
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 2e-5
FLASH = dict(attn_impl="flash", flash_block_q=16, flash_block_kv=16)
B, S, STEPS = 4, 24, 2


def _configs(arch, over):
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _jax_params(cfg):
    return jsteps.build_model(cfg).init(jax.random.PRNGKey(0))


def _to_port(jparams, cfg):
    return lm_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              cfg, device="cpu")


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(STEPS, B, S + 1))
    out = []
    for i in range(STEPS):
        b = {"tokens": toks[i, :, :-1], "labels": toks[i, :, 1:]}
        if cfg.is_encoder_decoder:
            b["frame_embeds"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            b["vision_embeds"] = rng.standard_normal(
                (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _assert_trees_close(tparams, jparams, tol=TOL):
    jl = jax.tree_util.tree_leaves(jparams)
    tl = list(tree_leaves(tparams))
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), atol=tol,
                                   rtol=tol)


# (arch, config overrides, microbatch, remat)
TRAIN_CASES = {
    "gemma-flash-mb1": ("gemma-2b", FLASH, 1, False),
    "gemma-flash-mb1-remat": ("gemma-2b", FLASH, 1, True),
    "gemma-flash-mb2": ("gemma-2b", FLASH, 2, False),
    "gemma-flash-mb2-remat": ("gemma-2b", FLASH, 2, True),
    "mamba2": ("mamba2-130m", {}, 1, True),
    "whisper": ("whisper-tiny", {}, 1, False),
    "qwen2-vl": ("qwen2-vl-7b", {}, 2, True),
}


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def train_run(request):
    """Both packages' train steps run STEPS steps from the same params on
    the same batches (JAX compiles each case's step once)."""
    arch, over, micro, remat = TRAIN_CASES[request.param]
    jcfg, tcfg = _configs(arch, over)
    jp = _jax_params(jcfg)
    tp = _to_port(jp, tcfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg, lr=0.1, remat=remat,
                                           microbatch=micro))
    tstep = tsteps.make_train_step(tcfg, lr=0.1, remat=remat,
                                   microbatch=micro, device="cpu")
    js, ts = jsgd.SGD(momentum=0.9).init(jp), SGD(momentum=0.9).init(tp)
    jl, tl = [], []
    for b in _batches(jcfg, 1):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    return dict(jl=jl, tl=tl, jp=jp, tp=tp, js=js, ts=ts)


def test_train_step_matches_the_reference(train_run):
    np.testing.assert_allclose(train_run["tl"], train_run["jl"], atol=TOL,
                               rtol=TOL)
    _assert_trees_close(train_run["tp"], train_run["jp"])
    _assert_trees_close(train_run["ts"].momentum,
                        train_run["js"].momentum)


def test_every_leaf_gets_a_gradient_through_the_kernels():
    """The flash and SSD layers' parameters get finite, nonzero gradients
    through the autograd Functions (the CPU runs their plain forwards)."""
    for arch, over in (("gemma-2b", FLASH), ("mamba2-130m", {})):
        _, cfg = _configs(arch, over)
        model = tsteps.build_model(cfg, "cpu", remat=True)
        params = model.init(torch.Generator().manual_seed(0))
        b = {k: torch.as_tensor(v) for k, v in _batches(cfg, 2)[0].items()}
        _, grads = tsteps.value_and_grad(tsteps.make_loss_fn(model),
                                         params, b)
        assert len(grads) == len(list(tree_leaves(params)))
        for g in grads:
            assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_fl_round_step_matches_the_reference():
    jcfg, tcfg = _configs("gemma-2b", FLASH)
    jp = _jax_params(jcfg)
    tp = _to_port(jp, tcfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 2, S + 1))
    batch = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:],
             "coeffs": np.asarray([0.7, 0.45], np.float32)}
    jn, jm = jax.jit(jsteps.make_fl_round_step(jcfg, 2, lr=0.05,
                                               local_steps=3))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    before = [t.clone() for t in tree_leaves(tp)]
    tn, tm = tsteps.make_fl_round_step(tcfg, 2, lr=0.05, local_steps=3,
                                       device="cpu")(
        tp, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=TOL, rtol=TOL)
    _assert_trees_close(tn, jn)
    # the global parameters are left as they were
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(tp)))


@pytest.mark.parametrize("weight_decay,nesterov",
                         [(0.0, False), (1e-2, False), (0.0, True),
                          (5e-3, True)])
def test_sgd_matches_the_reference(weight_decay, nesterov):
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda v: rng.standard_normal(v.shape).astype(np.float32), params)
        for _ in range(3)]
    jopt = jsgd.SGD(momentum=0.9, weight_decay=weight_decay,
                    nesterov=nesterov)
    topt = SGD(momentum=0.9, weight_decay=weight_decay, nesterov=nesterov)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.as_tensor, params)
    tp2 = jax.tree_util.tree_map(torch.clone, tp)
    js, ts, ts2 = jopt.init(jp), topt.init(tp), topt.init(tp2)
    lr = 0.1
    for g in grads:
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                             jnp.float32(lr))
        jp = jsgd.apply_updates(jp, ju)
        tg = jax.tree_util.tree_map(torch.as_tensor, g)
        tu, ts = topt.update(tg, ts, tp, torch.tensor(lr))
        tp = apply_updates(tp, tu)
        topt.step_(tg, ts2, tp2, torch.tensor(lr))
    _assert_trees_close(tp, jp)
    _assert_trees_close(ts.momentum, js.momentum)
    # the in-place step is the same arithmetic, leaf by leaf
    for a, b in zip(tree_leaves(tp), tree_leaves(tp2)):
        assert torch.equal(a, b)


def test_sgd_casts_back_to_the_parameter_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = SGD(momentum=0.9)
    u, st = opt.update({"w": torch.full((4,), 0.5, dtype=torch.bfloat16)},
                       opt.init(p), p, torch.tensor(0.1))
    assert st.momentum["w"].dtype == torch.float32
    assert apply_updates(p, u)["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamw_matches_the_reference(weight_decay):
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    jopt = jsgd.AdamW(weight_decay=weight_decay)
    topt = AdamW(weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, jnp.float32(1e-2))
        jp = jsgd.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.as_tensor(v) for k, v in g.items()},
                             ts, tp, torch.tensor(1e-2))
        tp = apply_updates(tp, tu)
    assert int(ts.step) == int(js.step) == 4
    _assert_trees_close(tp, jp)
    _assert_trees_close(ts.nu, js.nu)


@pytest.mark.parametrize("warmup,final", [(0, 0.0), (10, 0.1)])
def test_cosine_matches_the_reference(warmup, final):
    jfn, tfn = jcosine(0.3, 100, warmup, final), cosine(0.3, 100, warmup,
                                                       final)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(tfn(step),
                                   float(jfn(jnp.asarray(step))),
                                   atol=TOL, rtol=TOL)


def test_batch_iterators_are_bitwise_the_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((37, 3)).astype(np.float32)
    y = rng.integers(0, 5, size=37)
    toks = rng.integers(0, 100, size=(21, 9))
    for drop in (True, False):
        a = jpipe.batch_iterator(x, y, 8, seed=2, drop_remainder=drop)
        b = batch_iterator(x, y, 8, seed=2, drop_remainder=drop)
        for _ in range(12):
            ja, tb = next(a), next(b)
            assert all(np.array_equal(ja[k], tb[k]) for k in ("x", "y"))
    a, b = jpipe.lm_batches(toks, 4, seed=3), lm_batches(toks, 4, seed=3)
    for _ in range(12):
        ja, tb = next(a), next(b)
        assert all(np.array_equal(ja[k], tb[k]) for k in ja)


DRIVER = ["--arch", "mamba2-130m", "--batch", "2", "--seq", "16",
          "--log-every", "1", "--device", "cpu"]


def test_driver_saves_and_resumes(tmp_path):
    """4 steps with checkpoints at 2 and 4, then ``--steps 6`` resumes
    from step 4 with the parameters of step 4 and a zero momentum (as the
    JAX driver does, and with its batch iterator started again): two
    train steps from the step-4 checkpoint with a fresh momentum, on the
    driver's first two batches, give the resumed run's result."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import synthetic_lm_tokens

    argv = DRIVER + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = tdriver.main(argv + ["--steps", "4"])
    assert first["start"] == 0 and np.isfinite(first["loss"])
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "step_2.npz", "step_4.npz"]
    resumed = tdriver.main(argv + ["--steps", "6"])
    assert resumed["start"] == 4 and np.isfinite(resumed["loss"])
    cfg = get_smoke_config("mamba2-130m")
    params, _ = restore_checkpoint(str(tmp_path), "step_4",
                                   resumed["params"])
    step = tsteps.make_train_step(cfg, lr=0.3, remat=False, device="cpu")
    state = SGD(momentum=0.9).init(params)
    batches = lm_batches(synthetic_lm_tokens(64, 17, cfg.vocab_size, seed=0),
                         2, seed=1)
    for _ in range(2):
        params, state, _ = step(params, state, {
            k: torch.as_tensor(v) for k, v in next(batches).items()})
    for a, b in zip(tree_leaves(params), tree_leaves(resumed["params"])):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def test_driver_restores_a_checkpoint_the_jax_driver_wrote(tmp_path):
    """A JAX-written ``step_3`` (the JAX package's own ``save_checkpoint``
    of its smoke params, as its driver writes it) restores in the port's
    driver bitwise; with ``--steps 3`` no step runs after it."""
    jcfg = jax_smoke("mamba2-130m")
    jp = _jax_params(jcfg)
    jax_save(str(tmp_path), "step_3", jp, {"step": 3, "loss": 1.0})
    out = tdriver.main(DRIVER + ["--ckpt-dir", str(tmp_path), "--steps",
                                 "3"])
    assert out["start"] == 3 and out["loss"] is None
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    tree_leaves(out["params"])):
        assert np.array_equal(t.numpy(), np.asarray(a))
    resumed = tdriver.main(DRIVER + ["--ckpt-dir", str(tmp_path), "--steps",
                                     "4"])
    assert resumed["start"] == 3 and np.isfinite(resumed["loss"])
