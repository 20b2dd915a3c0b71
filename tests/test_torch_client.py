"""The port's model and local training against the JAX package: the CNN
and MLP tasks, one SGD step, and ``batched_local_sgd`` masked and
unmasked on a width-4 ``CNNTask`` with 8x8x1 images.  The reference's
init comes in through ``params_from_jax`` and its threefry epoch keys as
``sort_keys``; deltas and losses agree at atol and rtol 1e-4."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl.client as jclient  # noqa: E402
import repro.models as jm  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro.optim import SGD as JaxSGD  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fl import ClientConfig, batched_local_sgd  # noqa: E402
from repro_torch.optim import SGD, apply_updates  # noqa: E402

TOL = 1e-4
SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tasks(kind):
    if kind == "cnn":
        return (jm.CNNTask(image_shape=SHAPE, num_classes=4, width=4),
                tm.CNNTask(image_shape=SHAPE, num_classes=4, width=4))
    return (jm.MLPTask(input_dim=64, num_classes=4, hidden=16),
            tm.MLPTask(input_dim=64, num_classes=4, hidden=16))


def _np(tree):
    return {n: np.asarray(v) for n, v in tree.items()}


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int32)
    return x, y


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), want,
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["cnn", "mlp"])
def test_task_forward_loss_and_grads_match_reference(kind):
    jt, tt = _tasks(kind)
    jp = jt.init(jax.random.PRNGKey(3))
    tp = params_from_jax(_np(jp), tt, device="cpu")
    assert {n: tuple(v.shape) for n, v in tp.items()} == tt.shapes
    x, y = _batch(10, 1)
    tx = tt.device_layout(torch.as_tensor(x))
    ty = torch.as_tensor(y.astype(np.int64))
    _close(tt.logits(tp, tx), np.asarray(jt.logits(jp, jnp.asarray(x))))
    jl, jg = jax.value_and_grad(jt.loss_fn)(jp, {"x": jnp.asarray(x),
                                                 "y": jnp.asarray(y)})
    tg, tl = torch.func.grad_and_value(tt.loss_fn)(tp, {"x": tx, "y": ty})
    _close(tl, np.asarray(jl))
    want_g = params_from_jax(_np(jg), tt, device="cpu")
    for name in tp:
        _close(tg[name], want_g[name].numpy())
    acc = tt.metrics(tp, {"x": tx, "y": ty})["accuracy"]
    np.testing.assert_allclose(
        float(acc), float(jt.metrics(jp, {"x": jnp.asarray(x),
                                          "y": jnp.asarray(y)})["accuracy"]))


def test_init_shapes_and_statistics():
    _, tt = _tasks("cnn")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = tt.init(gen)
    assert {n: tuple(v.shape) for n, v in p.items()} == tt.shapes
    d1 = p["d1"]
    bound = 2.0 / np.sqrt(tt.shapes["d1"][0])
    assert float(d1.abs().max()) <= bound + 1e-6
    assert float(p["b1"].abs().max()) == 0.0


def test_sgd_step_matches_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    grads = [{n: rng.normal(size=v.shape).astype(np.float32)
              for n, v in params.items()} for _ in range(3)]
    jopt, topt = JaxSGD(momentum=0.9), SGD(momentum=0.9)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    tp = {n: torch.as_tensor(v) for n, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                             jp, jnp.float32(0.1))
        jp = {n: jp[n] + ju[n] for n in jp}
        tu, ts = topt.update({n: torch.as_tensor(v) for n, v in g.items()},
                             ts, tp, torch.tensor(0.1))
        tp = apply_updates(tp, tu)
    for n in params:
        _close(tp[n], np.asarray(jp[n]), tol=1e-6)


def _epoch_keys(k, epochs, rows, seed):
    """The reference's per-client epoch keys (``jax.random.split`` per
    client, then per epoch, then ``uniform``), as data."""
    rngs = jax.random.split(jax.random.PRNGKey(seed), k)
    keys = np.zeros((k, epochs, rows), np.float32)
    for i in range(k):
        for e, ek in enumerate(jax.random.split(rngs[i], epochs)):
            keys[i, e] = np.asarray(jax.random.uniform(ek, (rows,)))
    return rngs, keys


@pytest.mark.parametrize("masked", [False, True])
def test_batched_local_sgd_matches_reference(masked):
    k, rows, bs, epochs = 3, 32, 8, 2
    steps = rows // bs
    jt, tt = _tasks("cnn")
    jp = jt.init(jax.random.PRNGKey(1))
    tp = params_from_jax(_np(jp), tt, device="cpu")
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(k, rows) + SHAPE).astype(np.float32)
    ys = rng.integers(0, 4, (k, rows)).astype(np.int32)
    cfg = jclient.ClientConfig(local_epochs=epochs, batch_size=bs)
    if masked:
        n_ex = np.asarray([32, 19, 5], np.int32)
        n_steps = np.maximum(n_ex // bs, 1).astype(np.int32)
    else:
        n_ex = n_steps = None
    rngs, keys = _epoch_keys(k, epochs, rows, seed=4)

    run = jax.jit(partial(jclient.batched_local_sgd, jt.loss_fn, cfg=cfg,
                          steps_per_epoch=steps))
    jd, jl = run(jp, jnp.asarray(xs), jnp.asarray(ys), jnp.float32(0.1),
                 rngs, num_steps=None if n_steps is None else
                 jnp.asarray(n_steps),
                 num_examples=None if n_ex is None else jnp.asarray(n_ex))
    td, tl = batched_local_sgd(
        tt.loss_fn, tp, tt.device_layout(torch.as_tensor(xs)),
        torch.as_tensor(ys.astype(np.int64)), 0.1,
        ClientConfig(local_epochs=epochs, batch_size=bs), steps,
        num_steps=None if n_steps is None else torch.as_tensor(n_steps),
        num_examples=None if n_ex is None else torch.as_tensor(n_ex),
        sort_keys=torch.as_tensor(keys))
    _close(tl, np.asarray(jl))
    want = params_from_jax(_np(jd), tt, device="cpu")
    for name in tp:
        assert td[name].shape == (k,) + tuple(tp[name].shape)
        _close(td[name], want[name].numpy())


def test_full_bucket_mask_equals_unmasked():
    """A mask covering the whole bucket is inert: the masked and unmasked
    paths share the epoch keys and give the same update."""
    k, rows, bs = 2, 16, 4
    _, tt = _tasks("cnn")
    gen = torch.Generator()
    gen.manual_seed(5)
    tp = tt.init(gen)
    rng = np.random.default_rng(6)
    xs = tt.device_layout(torch.as_tensor(
        rng.normal(size=(k, rows) + SHAPE).astype(np.float32)))
    ys = torch.as_tensor(rng.integers(0, 4, (k, rows)))
    keys = torch.rand((k, 2, rows), generator=gen)
    cfg = ClientConfig(local_epochs=2, batch_size=bs)
    d0, l0 = batched_local_sgd(tt.loss_fn, tp, xs, ys, 0.05, cfg, rows // bs,
                               sort_keys=keys)
    d1, l1 = batched_local_sgd(tt.loss_fn, tp, xs, ys, 0.05, cfg, rows // bs,
                               num_steps=torch.full((k,), rows // bs),
                               num_examples=torch.full((k,), rows),
                               sort_keys=keys)
    torch.testing.assert_close(l0, l1, atol=1e-6, rtol=1e-6)
    for name in d0:
        torch.testing.assert_close(d0[name], d1[name], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="sort_keys"):
        batched_local_sgd(tt.loss_fn, tp, xs, ys, 0.05, cfg, rows // bs,
                          sort_keys=keys[:, :1])


def _per_client_case(masked):
    """A width-4 CNN batch of 3 clients with their own starting models."""
    k, rows, bs = 3, 16, 4
    _, tt = _tasks("cnn")
    gen = torch.Generator().manual_seed(8)
    starts = [tt.init(gen) for _ in range(k)]
    rng = np.random.default_rng(9)
    xs = tt.device_layout(torch.as_tensor(
        rng.normal(size=(k, rows) + SHAPE).astype(np.float32)))
    ys = torch.as_tensor(rng.integers(0, 4, (k, rows)))
    keys = torch.rand((k, 2, rows), generator=gen)
    masks = {}
    if masked:
        n_ex = torch.tensor([16, 9, 5])
        masks = dict(num_examples=n_ex,
                     num_steps=torch.clamp(n_ex // bs, min=1))
    return (tt, starts, xs, ys, keys, ClientConfig(local_epochs=2,
                                                   batch_size=bs),
            rows // bs, masks)


@pytest.mark.parametrize("masked", [False, True])
def test_per_client_starts_equal_the_shared_start(masked):
    """Each client starting from a copy of one model (``per_client=True``)
    is bitwise the shared-start call."""
    tt, starts, xs, ys, keys, cfg, steps, masks = _per_client_case(masked)
    shared = starts[0]
    stacked = {n: v.unsqueeze(0).repeat(3, *([1] * v.dim()))
               for n, v in shared.items()}
    d0, l0 = batched_local_sgd(tt.loss_fn, shared, xs, ys, 0.05, cfg, steps,
                               sort_keys=keys, **masks)
    d1, l1 = batched_local_sgd(tt.loss_fn, stacked, xs, ys, 0.05, cfg,
                               steps, sort_keys=keys, per_client=True,
                               **masks)
    assert torch.equal(l0, l1)
    for name in d0:
        assert torch.equal(d0[name], d1[name]), name


@pytest.mark.parametrize("masked", [False, True])
def test_per_client_starts_equal_separate_calls(masked):
    """Clients from different models: each client's delta (against its own
    start) and loss are those of a one-client call from its model."""
    tt, starts, xs, ys, keys, cfg, steps, masks = _per_client_case(masked)
    stacked = {n: torch.stack([s[n] for s in starts]) for n in starts[0]}
    deltas, losses = batched_local_sgd(tt.loss_fn, stacked, xs, ys, 0.05,
                                       cfg, steps, sort_keys=keys,
                                       per_client=True, **masks)
    for i, start in enumerate(starts):
        one = {k: v[i:i + 1] for k, v in masks.items()}
        d_i, l_i = batched_local_sgd(tt.loss_fn, start, xs[i:i + 1],
                                     ys[i:i + 1], 0.05, cfg, steps,
                                     sort_keys=keys[i:i + 1], **one)
        torch.testing.assert_close(losses[i:i + 1], l_i, atol=1e-6,
                                   rtol=1e-6)
        for name in d_i:
            torch.testing.assert_close(deltas[name][i], d_i[name][0],
                                       atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="per_client"):
        batched_local_sgd(tt.loss_fn, starts[0], xs, ys, 0.05, cfg, steps,
                          sort_keys=keys, per_client=True)
