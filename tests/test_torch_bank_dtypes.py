"""The port's data plane keeps the JAX package's dtypes and byte counts:
``ClientBank``, ``TieredClientBank`` and ``BankPool`` store their data's
dtypes (float16 features, int32 labels, int32 masks; a 64-bit dtype at
32 bits, as JAX stores it with x64 off), and so do ``EvalBank`` and the
trainer's test set; the round engine widens the K gathered rows.  Held
against the reference on the CPU:

* ``nbytes`` and every stack's dtype of a float16 bank of each kind
  equal to the reference's bank of the same clients;
  ``estimate_bank_nbytes`` equal to the reference's, called with its
  keywords, for f32, f16 and int8 storage and int32 and int64 labels;
* one ``round_step`` on each float16 bank within the trainer's 1e-4 of
  the reference's round on the same params, selection, coefficients and
  epoch keys (the MLP against the reference's float16 bank; the CNN
  against its bank of the same values in f32, since the reference's
  ``lax.conv`` refuses float16 inputs beside f32 weights), and bitwise
  the port's round on an f32 bank of the same values (widening is
  exact);
* the f32 round bitwise the round over the storage the port used before
  (f32 features, int64 labels and masks);
* an ``EvalBank`` and the trainer's evaluation on a float16 test set
  against the reference's metrics;
* ``BankPool(registry=)`` counting into the caller's registry as the
  reference's does; ``layers.apply_rope`` and ``apply_mrope`` against
  ``repro.models.layers`` in f32 and bf16 at ``tests/test_kernels.py``'s
  tolerances (2e-5, 2e-2).

The sharded round on a float16 ladder is in ``tests/test_torch_sharding.py``
(case ``f16``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.sim as jsim  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402

import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.fl import round_engine as tre  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402

E, BS, K = 2, 16, 4
SHAPE = (8, 8, 1)
TOL = 1e-4                              # tests/test_torch_trainer.py
SKEWED = [64, 10, 33, 64, 100, 17, 48, 12]      # 4 rungs: 16, 32, 64, 128
SEL = np.asarray([1, 4, 0, 5])                  # every rung of the ladder
COEFFS = np.asarray([.2, .3, .1, .4], np.float32)
KINDS = ("single", "tiered", "pool")
ROPE_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # test_kernels.py


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clients(dtype=np.float16, label_dtype=np.int32, sizes=SKEWED, seed=3):
    x, y = synthetic_image_classification(sum(sizes), SHAPE, 4, noise=0.3,
                                          seed=seed)
    offs = np.cumsum([0] + list(sizes))
    return [(x[offs[i]:offs[i + 1]].astype(dtype),
             y[offs[i]:offs[i + 1]].astype(label_dtype))
            for i in range(len(sizes))]


def _widened(clients):
    """The same values with f32 features."""
    return [(x.astype(np.float32), y) for x, y in clients]


def _tasks(kind):
    if kind == "cnn":
        return (jm.CNNTask(image_shape=SHAPE, num_classes=4, width=4),
                tm.CNNTask(image_shape=SHAPE, num_classes=4, width=4))
    return (jm.MLPTask(input_dim=64, num_classes=4, hidden=8),
            tm.MLPTask(input_dim=64, num_classes=4, hidden=8))


def _engines(task="cnn"):
    jtask, ttask = _tasks(task)
    return (jfl.RoundEngine(jtask, jfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS)),
            tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS),
                            device="cpu"))


def _bank(pkg, eng, clients, kind, storage="fp32", registry=None):
    """``kind``'s bank of ``clients`` in package ``pkg`` (a full pool in
    client order for 'pool')."""
    if kind != "pool":
        return eng.make_bank(clients, tiered=kind, storage=storage)
    kw = dict(capacity=len(clients), storage=storage,
              initial_clients=dict(enumerate(clients)))
    if registry is not None:
        kw["registry"] = registry
    if pkg is jfl:
        return jfl.BankPool(eng.cfg, **kw)
    return tfl.BankPool(eng.cfg, device="cpu",
                        x_layout=eng.task.device_layout, **kw)


def _rungs(bank):
    return bank.tiers if hasattr(bank, "tiers") else [bank]


def _stacks(bank):
    return [getattr(r, n) for r in _rungs(bank)
            for n in ("xs", "ys", "num_steps", "num_examples")]


def _port_params(jparams, task):
    return params_from_jax({n: np.asarray(v) for n, v in jparams.items()},
                           task, device="cpu")


def _slot_keys(rngs, rows_of_slot, width):
    """``[K, E, width]``: slot k's reference keys ``uniform(split(rngs[k],
    E)[e], (rows_of_slot[k],))``, zero-padded to ``width`` (the port
    reads the first ``B_t`` columns)."""
    out = np.zeros((len(rows_of_slot), E, width), np.float32)
    for k, rows in enumerate(rows_of_slot):
        for e, ek in enumerate(jax.random.split(rngs[k], E)):
            out[k, e, :rows] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def _keys(bank, rngs):
    if hasattr(bank, "tier_of"):
        rows = [bank.tier_buckets[bank.tier_of[c]] for c in SEL]
    else:
        rows = [bank.bucket_examples] * K
    return _slot_keys(rngs, rows, bank.bucket_examples)


def _slots(bank):
    return bank.slots_for(SEL) if hasattr(bank, "slots_for") else SEL


def _round(eng, bank, params, keys):
    return eng.round_step({n: v.clone() for n, v in params.items()}, bank,
                          _slots(bank), COEFFS, .1, keys)


def _assert_bitwise(a, b):
    for name in a:
        assert torch.equal(a[name], b[name]), name


# -- bytes and dtypes ---------------------------------------------------------


@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", KINDS)
def test_f16_bank_bytes_and_dtypes_match_reference(kind, label_dtype):
    """``nbytes`` equal to the reference's bank of the same clients and
    every stack in the reference's dtype (int64 labels at int32, as JAX
    stores them); the feature stack half the f32 bank's."""
    clients = _clients(label_dtype=label_dtype)
    jeng, teng = _engines()
    jbank = _bank(jfl, jeng, clients, kind)
    tbank = _bank(tfl, teng, clients, kind)
    assert tbank.nbytes == jbank.nbytes
    assert tbank.bytes_per_client == jbank.bytes_per_client
    got = [str(t.dtype).replace("torch.", "") for t in _stacks(tbank)]
    want = [str(a.dtype) for a in _stacks(jbank)]
    assert got == want
    assert got[:4] == ["float16", "int32", "int32", "int32"]
    f32 = _bank(tfl, teng, _widened(clients), kind)
    xs16 = sum(r.xs.numel() * r.xs.element_size() for r in _rungs(tbank))
    xs32 = sum(r.xs.numel() * r.xs.element_size() for r in _rungs(f32))
    assert 2 * xs16 == xs32


def test_single_bucket_and_pool_nbytes_equal_the_estimate():
    """A float16 single bucket and pool hold what the reference's
    ``estimate_bank_nbytes(..., feature_dtype=, label_dtype=)`` says, the
    ladder what it says of each rung's members."""
    clients = _clients()
    _, teng = _engines()
    kw = dict(feature_dtype=np.float16, label_dtype=np.int32)
    single = _bank(tfl, teng, clients, "single")
    assert single.nbytes == tfl.estimate_bank_nbytes(SKEWED, BS, SHAPE, **kw)
    pool = _bank(tfl, teng, clients, "pool")
    assert pool.nbytes == tfl.estimate_bank_nbytes(
        [max(SKEWED)] * len(SKEWED), BS, SHAPE, **kw)
    ladder = _bank(tfl, teng, clients, "tiered")
    assert ladder.nbytes == sum(
        tfl.estimate_bank_nbytes([SKEWED[i] for i in m], BS, SHAPE, **kw)
        for m in ladder.tier_members)


def test_clustered_pool_and_bank_hold_int32_cluster_ids():
    """Cluster routing in int32, as the reference's: a clustered pool's
    ``nbytes`` (which counts its ids) equal to the reference's; the
    hierarchical round bitwise the round over int64 ids."""
    clients = _clients(sizes=[20] * 6)
    jeng, teng = _engines()
    kw = dict(capacity=8, clusters=2,
              initial_clients=dict(enumerate(clients)))
    pool = tfl.BankPool(teng.cfg, device="cpu", **kw)
    assert pool.nbytes == jfl.BankPool(jeng.cfg, **kw).nbytes
    bank = teng.make_bank(clients, tiered="single", clusters=2)
    assert pool.cluster_of_device.dtype == torch.int32
    assert bank.cluster_of_device.dtype == torch.int32
    p0 = teng.task.init(torch.Generator().manual_seed(0))
    keys = torch.rand((K, E, bank.bucket_examples),
                      generator=torch.Generator().manual_seed(1))
    runs = []
    for ids in (bank.cluster_of_device, bank.cluster_of_device.long()):
        bank.cluster_of_device = ids
        runs.append(teng.round_step({n: v.clone() for n, v in p0.items()},
                                    bank, SEL, COEFFS, .1, keys,
                                    hierarchical=True))
    _assert_bitwise(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("feature_dtype", [np.float32, np.float16])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_estimate_bank_nbytes_matches_reference(storage, feature_dtype,
                                                label_dtype):
    """The reference's call, keywords and positions, runs unchanged."""
    args = (SKEWED, BS, SHAPE, (2,))
    kw = dict(feature_dtype=feature_dtype, label_dtype=label_dtype,
              storage=storage)
    assert tfl.estimate_bank_nbytes(*args, **kw) == \
        jfl.estimate_bank_nbytes(*args, **kw)
    assert tfl.estimate_bank_nbytes(*args, feature_dtype, label_dtype,
                                    storage) == \
        jfl.estimate_bank_nbytes(*args, feature_dtype, label_dtype, storage)


def test_int8_f16_bank_matches_reference():
    """int8 codes of float16 data: the codes, scale and zero and
    ``nbytes`` equal to the reference's."""
    clients = _clients()
    jeng, teng = _engines()
    jb = jeng.make_bank(clients, tiered="single", storage="int8")
    tb = teng.make_bank(clients, tiered="single", storage="int8")
    assert tb.nbytes == jb.nbytes == tfl.estimate_bank_nbytes(
        SKEWED, BS, SHAPE, feature_dtype=np.float16, storage="int8")
    np.testing.assert_array_equal(tb.xs.numpy(),
                                  np.moveaxis(np.asarray(jb.xs), -1, -3))
    np.testing.assert_array_equal(tb.x_scale.numpy(), np.asarray(jb.x_scale))


# -- rounds -------------------------------------------------------------------


@pytest.mark.parametrize("task", ["mlp", "cnn"])
@pytest.mark.parametrize("kind", KINDS)
def test_f16_round_matches_reference(kind, task):
    """Within 1e-4 of the reference's round and bitwise the port's round
    on an f32 bank of the same values."""
    clients = _clients()
    jeng, teng = _engines(task)
    ref_clients = clients if task == "mlp" else _widened(clients)
    jbank = _bank(jfl, jeng, ref_clients, kind)
    tbank = _bank(tfl, teng, clients, kind)
    jp0 = jeng.task.init(jax.random.PRNGKey(0))
    rngs = jax.random.split(jax.random.PRNGKey(5), K)
    jp, jl = jeng.round_step(jp0, jbank, _slots(jbank), COEFFS, .1, rngs)
    p0 = _port_params(jp0, teng.task)
    keys = torch.as_tensor(_keys(tbank, rngs))
    tp_, tl = _round(teng, tbank, p0, keys)
    want = _port_params(jp, teng.task)
    for name, v in want.items():
        np.testing.assert_allclose(tp_[name].numpy(), v.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    wp, wl = _round(teng, _bank(tfl, teng, _widened(clients), kind), p0,
                    keys)
    _assert_bitwise(tp_, wp)
    assert torch.equal(tl, wl)


@pytest.mark.parametrize("kind", KINDS)
def test_f32_round_is_bitwise_the_old_storage_round(kind):
    """The f32 bank's round (int32 labels and masks, widened after the
    gather) bitwise the round over the same bank with the storage the
    port used before: int64 labels and masks."""
    clients = _clients(np.float32)
    _, teng = _engines()
    bank = _bank(tfl, teng, clients, kind)
    p0 = teng.task.init(torch.Generator().manual_seed(0))
    rngs = jax.random.split(jax.random.PRNGKey(5), K)
    keys = torch.as_tensor(_keys(bank, rngs))
    p_new, l_new = _round(teng, bank, p0, keys)
    for rung in _rungs(bank):
        assert rung.xs.dtype == torch.float32
        assert rung.ys.dtype == rung.num_steps.dtype == torch.int32
        for name in ("ys", "num_steps", "num_examples"):
            setattr(rung, name, getattr(rung, name).to(torch.int64))
    p_old, l_old = _round(teng, bank, p0, keys)
    _assert_bitwise(p_new, p_old)
    assert torch.equal(l_new, l_old)


def test_gather_widens_rows_exactly():
    """``_gather`` of a float16 bank: f32 rows equal to the f16 values,
    int64 labels and masks equal to the stored ones."""
    clients = _clients()
    _, teng = _engines()
    bank = teng.make_bank(clients, tiered="single")
    idx = torch.as_tensor([7, 2, 2])
    xs, ys, ns, ne = tre._gather(bank, idx)
    assert (xs.dtype, ys.dtype, ns.dtype, ne.dtype) == (
        torch.float32, torch.int64, torch.int64, torch.int64)
    assert torch.equal(xs, bank.xs[idx].to(torch.float32))
    assert torch.equal(ys, bank.ys[idx].to(torch.int64))
    assert torch.equal(ns, bank.num_steps[idx].to(torch.int64))


# -- test sets ----------------------------------------------------------------


@pytest.mark.parametrize("task", ["mlp", "cnn"])
def test_f16_eval_bank_matches_reference(task):
    """The test set on the device in float16 / int32 (the reference's
    bytes), its metrics within 1e-4 of the reference's EvalBank."""
    x, y = synthetic_image_classification(60, SHAPE, 4, noise=0.3, seed=9)
    x = x.astype(np.float16)
    jtask, ttask = _tasks(task)
    jev = jsim.EvalBank(jtask, x if task == "mlp" else x.astype(np.float32),
                        y)
    tev = tsim.EvalBank(ttask, x, y, device="cpu")
    assert (tev.x.dtype, tev.y.dtype) == (torch.float16, torch.int32)
    assert tev.x.numel() * tev.x.element_size() == x.nbytes
    assert np.asarray(jsim.EvalBank(jtask, x, y).x).dtype == np.float16
    stack = jax.tree_util.tree_map(
        lambda *v: jnp.stack(v),
        *[jtask.init(jax.random.PRNGKey(s)) for s in range(3)])
    want = jev.evaluate_stacked(stack)
    got = tev.evaluate_stacked({n: torch.as_tensor(np.asarray(v)) for n, v
                                in _port_stack(stack, ttask).items()})
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)


def _port_stack(stack, ttask):
    """A reference params stack ``[S, ...]`` in the port's layout."""
    s = next(iter(stack.values())).shape[0]
    per = [_port_params({n: v[i] for n, v in stack.items()}, ttask)
           for i in range(s)]
    return {n: torch.stack([p[n] for p in per]) for n in per[0]}


def test_trainer_keeps_a_f16_test_set_and_evaluates_it_as_the_reference():
    n = 6
    clients = _clients(np.float32, sizes=[40] * n)
    sizes = np.full(n, 40, np.float32)
    x, y = synthetic_image_classification(40, SHAPE, 4, seed=9)
    x = x.astype(np.float16)
    task = tm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    tp = tc.paper_default_params(num_devices=n, sample_count=3,
                                 local_epochs=E, data_sizes=sizes,
                                 device="cpu")
    tr = tfl.FederatedTrainer(
        task, tp, tc.LROAController(tp, tc.estimate_hyperparams(tp, 0.1)),
        tfl.ChannelProcess(n), clients,
        tfl.ClientConfig(local_epochs=E, batch_size=BS), topt.constant(0.1),
        test_data=(x, y), seed=1, device="cpu")
    assert [t.dtype for t in tr.test_data] == [torch.float16, torch.int32]
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    want = float(jtask.metrics(
        {n_: jnp.asarray(v.numpy()) for n_, v in tr.global_params.items()},
        {"x": jnp.asarray(x), "y": jnp.asarray(y)})["accuracy"])
    assert tr.evaluate() == pytest.approx(want, abs=TOL)


# -- BankPool(registry=) ------------------------------------------------------


def test_pool_counts_into_the_callers_registry_as_the_reference():
    clients = _clients(sizes=[20] * 6)
    jeng, teng = _engines()
    reg, jreg = MetricsRegistry(), JRegistry()
    pools = []
    for pkg, eng, r in ((tfl, teng, reg), (jfl, jeng, jreg)):
        pool = _bank(pkg, eng, clients[:4], "pool", registry=r)
        pool.evict(1)
        pool.admit(4, *clients[4])
        assert pool.registry is r
        pools.append(pool)
    for name in ("pool.admits", "pool.evicts", "pool.uploads",
                 "pool.resident"):
        assert reg.get(name) == jreg.get(name), name
    assert (reg.get("pool.admits"), reg.get("pool.evicts")) == (5, 1)
    # a second pool on the same registry adds to its counts
    other = tfl.BankPool(teng.cfg, capacity=2, device="cpu",
                         initial_clients={9: clients[5]}, registry=reg)
    assert other.registry is reg and reg.get("pool.admits") == 6
    assert pools[0].admits == other.admits == 6
    assert tfl.BankPool(teng.cfg, capacity=2, device="cpu",
                        initial_clients={0: clients[0]}).registry \
        is not reg


# -- apply_rope / apply_mrope -------------------------------------------------


def _rope_input(dtype, shape=(2, 12, 3, 16), seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(x, jdt), torch.as_tensor(x).to(dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_rope_matches_reference(dtype, theta):
    jx, tx = _rope_input(dtype)
    pos = np.random.default_rng(1).integers(0, 64, (2, 12)).astype(np.int32)
    want = jL.apply_rope(jx, jnp.asarray(pos), theta)
    got = tL.apply_rope(tx, torch.as_tensor(pos), theta)
    assert got.dtype == dtype and got.shape == tx.shape
    tol = ROPE_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("patches", [0, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_matches_reference(dtype, patches):
    """Text-only ids (t = h = w: plain RoPE) and 16 vision patches on a
    4 x 4 grid; sections that do not cover D/2 raise."""
    jx, tx = _rope_input(dtype, (2, 24, 3, 16))
    pos = tvlm.mrope_positions(2, 24, patches, device="cpu")
    sections = (2, 3, 3)
    want = jL.apply_mrope(jx, jnp.asarray(pos.numpy()), 1e6, sections)
    got = tL.apply_mrope(tx, pos, 1e6, sections)
    assert got.dtype == dtype and got.shape == tx.shape
    tol = ROPE_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    if patches == 0:
        rope = tL.apply_rope(tx, pos[0], 1e6)
        assert torch.equal(got, rope)
    with pytest.raises(ValueError, match="sections"):
        tL.apply_mrope(tx, pos, 1e6, (2, 3, 4))
