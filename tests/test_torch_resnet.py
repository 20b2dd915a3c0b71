"""The port's ``ResNetTask`` against the JAX package's: XLA's "SAME"
padding (asymmetric at stride 2 on an even size), logits, loss, metrics
and grads from the reference's initial params (width 8, one and two
blocks per stage, 8x8x3 and 7x7x3; 2e-5, grads 1e-4), the strided-slice
shortcut with a projection removed, the paper-scale task's 17 leaves and
694,378 parameters, the layout converters both ways, and one fused
ResNet round against the JAX ``RoundEngine.round_step`` with the
reference's epoch keys."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 params_to_jax_layout)
from repro_torch.models.cnn import _same_pads  # noqa: E402

TOL, GRAD_TOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(shape, width, blocks, classes=5, seed=0):
    jt = jm.ResNetTask(image_shape=shape, num_classes=classes, width=width,
                       blocks_per_stage=blocks)
    tt = tm.ResNetTask(image_shape=shape, num_classes=classes, width=width,
                       blocks_per_stage=blocks)
    jp = {n: np.asarray(v) for n, v in jt.init(jax.random.PRNGKey(seed))
          .items()}
    return jt, tt, jp


def _batch(shape, classes, n=6, seed=1):
    x, y = synthetic_image_classification(n, shape, classes, seed=seed)
    return x, y


@pytest.mark.parametrize("n,stride,k,want", [
    (32, 2, 3, (0, 1)), (8, 2, 3, (0, 1)), (7, 2, 3, (1, 1)),
    (4, 2, 3, (0, 1)), (8, 1, 3, (1, 1)), (8, 2, 1, (0, 0)),
    (7, 2, 1, (0, 0)), (5, 1, 1, (0, 0))])
def test_same_padding_is_xlas(n, stride, k, want):
    assert _same_pads(n, stride, k) == want
    x = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, n, n, 1)).astype(np.float32))
    w = jnp.ones((k, k, 1, 1), jnp.float32)
    ref = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    lo, hi = want
    padded = jnp.pad(x, ((0, 0), (lo, hi), (lo, hi), (0, 0)))
    got = jax.lax.conv_general_dilated(
        padded, w, (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("shape,blocks", [
    ((8, 8, 3), 1), ((8, 8, 3), 2), ((7, 7, 3), 1), ((7, 7, 3), 2)])
def test_resnet_matches_reference(shape, blocks):
    jt, tt, jp = _pair(shape, 8, blocks)
    tp = params_from_jax(jp, tt, device="cpu")
    x, y = _batch(shape, 5)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": tt.device_layout(torch.as_tensor(x)),
          "y": torch.as_tensor(y.astype(np.int64))}
    np.testing.assert_allclose(tt.logits(tp, tb["x"]).detach().numpy(),
                               np.asarray(jax.jit(jt.logits)(jp, jb["x"])),
                               atol=TOL, rtol=TOL)
    jm_, tm_ = jax.jit(jt.metrics)(jp, jb), tt.metrics(tp, tb)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                   atol=TOL, rtol=TOL)
    jl, jg = jax.jit(jax.value_and_grad(jt.loss_fn))(jp, jb)
    tl, tg = torch.func.grad_and_value(tt.loss_fn)(tp, tb)[::-1]
    np.testing.assert_allclose(float(tl), float(jl), atol=TOL, rtol=TOL)
    tg = params_to_jax_layout(tg, tt)
    assert sorted(tg) == sorted(jg)
    for n, v in jg.items():
        np.testing.assert_allclose(tg[n], np.asarray(v), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=n)


def test_strided_slice_shortcut_matches_reference():
    """Every stage transition of the task's own init has a projection;
    dropping stage 1's reaches the ``x[:, ::2, ::2]`` shortcut (width 1,
    so its one channel broadcasts over the block's two)."""
    jt, tt, jp = _pair((8, 8, 3), 1, 1)
    del jp["s1b0_proj"]
    del tt._parameters["s1b0_proj"], tt.shapes["s1b0_proj"]
    tp = params_from_jax(jp, tt, device="cpu")
    x, y = _batch((8, 8, 3), 5)
    jl, jg = jax.jit(jax.value_and_grad(jt.loss_fn))(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tg, tl = torch.func.grad_and_value(tt.loss_fn)(
        tp, {"x": tt.device_layout(torch.as_tensor(x)),
             "y": torch.as_tensor(y.astype(np.int64))})
    np.testing.assert_allclose(float(tl), float(jl), atol=TOL, rtol=TOL)
    tg = params_to_jax_layout(tg, tt)
    for n, v in jg.items():
        np.testing.assert_allclose(tg[n], np.asarray(v), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=n)


def test_paper_scale_task_leaves_and_size():
    task = tm.ResNetTask()
    params = task.init(torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(jm.ResNetTask().init, jax.random.PRNGKey(0))
    assert len(params) == len(jshapes) == 17
    assert sum(p.numel() for p in params.values()) == 694_378
    jl = params_to_jax_layout(params, task)
    for n, s in jshapes.items():
        assert jl[n].shape == s.shape, n
    # the fan-in init: std ~ 1/sqrt(fan_in) within 10% on the big leaves
    w = params["s2b1_c2"]
    assert abs(float(w.std()) * np.sqrt(9 * 128) - 0.88) < 0.09
    assert float(w.abs().max()) <= 2.0 / np.sqrt(9 * 128) + 1e-7
    assert torch.equal(params["head_b"], torch.zeros(10))


@pytest.mark.parametrize("task", [
    tm.ResNetTask(image_shape=(8, 8, 3), width=4),
    tm.CNNTask(image_shape=(8, 12, 2), width=4), tm.MLPTask(input_dim=12)],
    ids=["resnet", "cnn", "mlp"])
def test_layout_converters_are_inverse(task):
    params = task.init(torch.Generator().manual_seed(0))
    stacked = {n: torch.stack([v, -v]) for n, v in params.items()}
    for tree in (params, stacked):
        back = params_from_jax(params_to_jax_layout(tree, task), task,
                               device="cpu")
        for n, v in tree.items():
            assert torch.equal(back[n], v), n


def test_fused_resnet_round_matches_reference():
    shape, k, e, bs = (8, 8, 3), 3, 2, 4
    sizes = (16, 9, 24, 16)
    x, y = synthetic_image_classification(sum(sizes), shape, 5, seed=4)
    offs = np.cumsum((0,) + sizes)
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(len(sizes))]
    jt, tt, jp = _pair(shape, 8, 1, seed=3)
    jeng = jfl.RoundEngine(jt, jfl.ClientConfig(local_epochs=e,
                                                batch_size=bs))
    teng = tfl.RoundEngine(tt, tfl.ClientConfig(local_epochs=e,
                                                batch_size=bs),
                           device="cpu")
    jbank = jeng.make_bank(clients, tiered="single")
    tbank = teng.make_bank(clients, tiered="single")
    rows = jbank.bucket_examples
    assert tbank.bucket_examples == rows
    sel = np.asarray([2, 1, 2])
    coeffs = np.asarray([0.4, 0.35, 0.25], np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(8), k)
    keys = np.stack([np.stack([np.asarray(jax.random.uniform(ek, (rows,)))
                               for ek in jax.random.split(r, e)])
                     for r in rngs])
    jnew, jl = jeng.round_step({n: jnp.asarray(v) for n, v in jp.items()},
                               jbank, sel, coeffs, 0.05, rngs)
    start = params_from_jax(jp, tt, device="cpu")
    tnew, tl = teng.round_step(start, tbank, sel, coeffs, 0.05,
                               torch.as_tensor(keys))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    want = params_from_jax({n: np.asarray(v) for n, v in jnew.items()}, tt,
                           device="cpu")
    moved = max(float((want[n] - start[n]).abs().max()) for n in want)
    assert moved > 0
    for n, v in want.items():
        np.testing.assert_allclose(tnew[n].numpy(), v.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=n)
