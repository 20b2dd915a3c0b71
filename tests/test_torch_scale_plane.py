"""The port's scale plane against the JAX package's, case by case with
``tests/test_scale_plane.py``: int8 bank storage (the codes in the
task's layout and the dequantizing gather bitwise the reference's, an int8 round within
1e-4 of the reference's int8 round and within its bound of the fp32
round, the fp32 path untouched), hierarchical cluster aggregation (the
reduce against the flat one and the reference's), the slot-recycled ``BankPool`` (exact admit/evict, no
reallocation across churn, a pool round bitwise a ``ClientBank`` round
of the same clients and within 1e-4 of the reference's pool round), the
``nbytes`` accounting, and the arena over an int8 bank and a pool
against the reference's arena."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.data as td  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)
from repro_torch.fl import round_engine as tre  # noqa: E402

N, M, BS, K, E = 10, 48, 8, 4, 1
SHAPE = (4, 4, 1)
TOL = 1e-4
METRICS = ("loss", "wall_time", "energy_mean", "queue_mean", "queue_norm",
           "q_min", "q_max")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _client_data(n=N, m=M, seed=0, sizes=None):
    sizes = [m] * n if sizes is None else sizes
    x, y = synthetic_image_classification(sum(sizes), SHAPE, num_classes=2,
                                          noise=0.3, seed=seed)
    offs = np.cumsum([0] + list(sizes))
    return [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
            for i in range(len(sizes))]


def _engines():
    jtask = jm.CNNTask(image_shape=SHAPE, num_classes=2, width=4)
    ttask = tm.CNNTask(image_shape=SHAPE, num_classes=2, width=4)
    return (jfl.RoundEngine(jtask, jfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS)),
            tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=E,
                                                    batch_size=BS),
                            device="cpu"))


def _port_params(jparams, task):
    return params_from_jax({n: np.asarray(v) for n, v in jparams.items()},
                           task, device="cpu")


def _keys(rngs, rows):
    """The reference's ``[K, E, rows]`` epoch keys of ``rngs``."""
    return np.stack([np.stack([np.asarray(jax.random.uniform(ek, (rows,)))
                               for ek in jax.random.split(r, E)])
                     for r in rngs])


def _round_pair(jeng, teng, jbank, tbank, sel=None, hierarchical=False):
    """One round of each package from the same params, coefficients and
    epoch keys."""
    sel = np.arange(K, dtype=np.int32) if sel is None else sel
    jp0 = jeng.task.init(jax.random.PRNGKey(0))
    coeffs = np.full(len(sel), 1.0 / len(sel), np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(1), len(sel))
    kw = dict(hierarchical=True) if hierarchical else {}
    jp, jl = jeng.round_step(jp0, jbank, sel, coeffs, 0.1, rngs, **kw)
    tp_, tl = teng.round_step(_port_params(jp0, teng.task), tbank, sel,
                              coeffs, 0.1,
                              _keys(rngs, tbank.bucket_examples), **kw)
    return (jp, np.asarray(jl)), (tp_, tl.numpy())


def _assert_close(tparams, jparams, task, tol=TOL):
    want = _port_params(jparams, task)
    for name, v in want.items():
        np.testing.assert_allclose(tparams[name].numpy(), v.numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def _max_dev(a, b):
    return max(float((a[n] - b[n]).abs().max()) for n in a)


# -- int8 storage ----------------------------------------------------------------


def test_int8_bank_codes_layout_and_gather_match_reference():
    """The codes in the task's layout (NCHW), the ``[N]`` scale and
    zero, and the dequantizing gather bitwise the reference's (one
    fused multiply-add per element, as XLA computes it); within half a
    step of the true rows."""
    cd = _client_data()
    jeng, teng = _engines()
    jb = jeng.make_bank(cd, tiered="single", storage="int8")
    tb = teng.make_bank(cd, tiered="single", storage="int8")
    assert tb.xs.dtype == torch.int8 and tb.storage == "int8"
    np.testing.assert_array_equal(tb.xs.numpy(),
                                  np.moveaxis(np.asarray(jb.xs), -1, -3))
    np.testing.assert_array_equal(tb.x_scale.numpy(), np.asarray(jb.x_scale))
    np.testing.assert_array_equal(tb.x_zero.numpy(), np.asarray(jb.x_zero))
    sel = np.asarray([3, 0, 7, 7])
    xs = tre._gather(tb, torch.as_tensor(sel))[0]
    take = jax.jit(lambda x, s, z, i: (
        jnp.take(x, i, axis=0).astype(jnp.float32)
        * jnp.take(s, i).reshape(-1, 1, 1, 1, 1)
        + jnp.take(z, i).reshape(-1, 1, 1, 1, 1)))
    want = np.asarray(take(jb.xs, jb.x_scale, jb.x_zero, jnp.asarray(sel)))
    np.testing.assert_array_equal(xs.numpy(), np.moveaxis(want, -1, -3))
    true = np.moveaxis(tb.gather_host(sel)[0], -1, -3)
    half = 0.5 * tb.x_scale.numpy()[sel].reshape(-1, 1, 1, 1, 1) + 1e-6
    assert (np.abs(xs.numpy() - true) <= half).all()


def test_int8_round_matches_reference_and_fp32_bound():
    cd = _client_data()
    jeng, teng = _engines()
    (jp, jl), (tp_, tl) = _round_pair(
        jeng, teng, jeng.make_bank(cd, tiered="single", storage="int8"),
        teng.make_bank(cd, tiered="single", storage="int8"))
    _assert_close(tp_, jp, teng.task)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    _, (fp, fl) = _round_pair(jeng, teng, jeng.make_bank(cd, "single"),
                              teng.make_bank(cd, "single"))
    assert _max_dev(fp, tp_) < 5e-3                  # the reference's bound
    np.testing.assert_allclose(fl, tl, atol=0.05)


def test_int8_ladder_round_matches_reference():
    cd = _client_data(sizes=[48, 20, 33, 48, 9, 40, 48, 12, 30, 48])
    jeng, teng = _engines()
    jb = jeng.make_bank(cd, storage="int8")
    tb = teng.make_bank(cd, storage="int8")
    assert isinstance(tb, tfl.TieredClientBank) and tb.num_tiers > 1
    sel = np.asarray([1, 4, 0, 7])
    rngs = jax.random.split(jax.random.PRNGKey(1), K)
    keys = np.zeros((K, E, tb.bucket_examples), np.float32)
    for k, c in enumerate(sel):
        rows = tb.tier_buckets[tb.tier_of[c]]
        keys[k, :, :rows] = _keys(rngs[k:k + 1], rows)[0]
    jp0 = jeng.task.init(jax.random.PRNGKey(0))
    coeffs = np.full(K, 0.25, np.float32)
    jp, jl = jeng.round_step(jp0, jb, sel, coeffs, 0.1, rngs)
    tp_, tl = teng.round_step(_port_params(jp0, teng.task), tb, sel, coeffs,
                              0.1, keys)
    _assert_close(tp_, jp, teng.task)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_fp32_path_bitwise_unaffected_by_int8_sibling():
    cd = _client_data()
    jeng, teng = _engines()
    jb, tb = jeng.make_bank(cd, "single"), teng.make_bank(cd, "single")
    _, (p1, l1) = _round_pair(jeng, teng, jb, tb)
    _round_pair(jeng, teng, jeng.make_bank(cd, "single", storage="int8"),
                teng.make_bank(cd, "single", storage="int8"))
    _, (p2, l2) = _round_pair(jeng, teng, jb, tb)
    for name in p1:
        assert torch.equal(p1[name], p2[name]), name
    np.testing.assert_array_equal(l1, l2)
    assert tb.x_scale is None and tb.quant_args() == (None, None)


def test_gather_host_returns_unquantized_reference():
    cd = _client_data()
    _, teng = _engines()
    bank = teng.make_bank(cd, tiered="single", storage="int8")
    xs, ys, ns, ne = bank.gather_host(np.array([0, 3]))
    assert xs.dtype == np.float32 and xs.shape[1] == bank.bucket_examples
    np.testing.assert_array_equal(ne, [M, M])
    np.testing.assert_array_equal(xs[0, :M], cd[0][0])
    np.testing.assert_array_equal(ys[1, :M], cd[3][1])


# -- hierarchical aggregation ---------------------------------------------------


def test_aggregate_hierarchical_matches_flat_and_reference():
    rng = np.random.default_rng(1)
    gp = {"w": rng.normal(size=(6, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    deltas = {k: rng.normal(size=(K,) + v.shape).astype(np.float32)
              for k, v in gp.items()}
    coeffs = rng.uniform(0.1, 1.0, K).astype(np.float32)
    tgp = {k: torch.as_tensor(v) for k, v in gp.items()}
    tdel = {k: torch.as_tensor(v) for k, v in deltas.items()}
    flat = tfl.aggregate_fused(tgp, tdel, torch.as_tensor(coeffs))
    for csel in ([0, 0, 0, 0], [0, 1, 2, 3], [2, 0, 2, 1]):
        sel = np.asarray(csel, np.int32)
        hier = tfl.aggregate_hierarchical(tgp, tdel, torch.as_tensor(coeffs),
                                          torch.as_tensor(sel), 4)
        want = jfl.aggregate_hierarchical(gp, deltas, coeffs, sel, 4)
        assert _max_dev(flat, hier) < 1e-5
        for name in gp:
            np.testing.assert_allclose(hier[name].numpy(),
                                       np.asarray(want[name]), rtol=2e-5,
                                       atol=2e-5)


def test_hierarchical_round_matches_flat_round_and_reference():
    cd = _client_data()
    jeng, teng = _engines()
    tb = teng.make_bank(cd, tiered="single", clusters=3)
    jb = jeng.make_bank(cd, tiered="single", clusters=3)
    assert tb.num_clusters == 3 and tb.cluster_of.shape == (N,)
    np.testing.assert_array_equal(tb.cluster_of, jb.cluster_of)
    np.testing.assert_array_equal(tb.cluster_of_device.numpy(),
                                  tb.cluster_of)
    (jp, jl), (hp, hl) = _round_pair(jeng, teng, jb, tb, hierarchical=True)
    _, (fp, fl) = _round_pair(jeng, teng, jb, tb)
    np.testing.assert_array_equal(hl, fl)
    assert _max_dev(hp, fp) < 1e-5
    _assert_close(hp, jp, teng.task)
    np.testing.assert_allclose(hl, jl, rtol=TOL, atol=TOL)


def test_hierarchical_needs_single_bucket_clusters():
    cd = _client_data()
    _, teng = _engines()
    bank = teng.make_bank(cd, tiered="single")
    params = teng.task.init(torch.Generator().manual_seed(0))
    keys = torch.zeros(K, E, bank.bucket_examples)
    with pytest.raises(ValueError, match="cluster"):
        teng.round_step(params, bank, np.arange(K), np.ones(K, np.float32),
                        0.1, keys, hierarchical=True)
    skewed = _client_data(sizes=[8, 8, 48, 48, 200, 200])
    ladder = teng.make_bank(skewed, tiered="tiered")
    with pytest.raises(ValueError, match="single-bucket"):
        teng.round_step(params, ladder, np.arange(K),
                        np.ones(K, np.float32), 0.1,
                        torch.zeros(K, E, ladder.bucket_examples),
                        hierarchical=True)
    with pytest.raises(ValueError, match="single-bucket"):
        teng.make_bank(skewed, tiered="tiered", clusters=2)


# -- validation and accounting ----------------------------------------------------


def test_validation_names_offending_client_and_bad_storage():
    good = _client_data(3, 16)
    bad_dtype = good[:2] + [(good[2][0].astype(np.int32), good[2][1])]
    _, eng = _engines()
    with pytest.raises(ValueError, match="client 2.*float"):
        eng.make_bank(bad_dtype)
    with pytest.raises(ValueError, match="client 1.*match"):
        eng.make_bank([good[0], (good[1][0].astype(np.float64),
                                 good[1][1])])
    with pytest.raises(ValueError, match="storage"):
        eng.make_bank(good, tiered="single", storage="int4")
    with pytest.raises(ValueError, match="storage"):
        eng.make_bank(good, tiered="tiered", storage="int4")


def test_nbytes_matches_estimate_and_int8_shrinks():
    cd = _client_data()
    cfg = tfl.ClientConfig(local_epochs=E, batch_size=BS)
    for storage in ("fp32", "int8"):
        bank = tfl.ClientBank(cd, cfg, device="cpu", storage=storage)
        est = tfl.estimate_bank_nbytes([M] * N, BS, SHAPE, storage=storage)
        assert bank.nbytes == est
        assert bank.bytes_per_client == pytest.approx(est / N)
        assert bank.padded_examples == N * bank.bucket_examples
        assert bank.true_examples == N * M
    f32 = tfl.estimate_bank_nbytes([M] * N, BS, SHAPE)
    i8 = tfl.estimate_bank_nbytes([M] * N, BS, SHAPE, storage="int8")
    assert f32 / i8 > 3.3       # features 4x; the int32 labels dilute it


# -- the pool -------------------------------------------------------------------


def _pool(capacity=6, storage="int8", clusters=None, n_init=4, task=None,
          pkg=tfl):
    cd = _client_data(n_init + 4, M, seed=2)
    init = {i: cd[i] for i in range(n_init)}
    if pkg is jfl:
        return jfl.BankPool(jfl.ClientConfig(local_epochs=E, batch_size=BS),
                            capacity=capacity, max_examples=M,
                            storage=storage, clusters=clusters,
                            initial_clients=init), cd
    return tfl.BankPool(tfl.ClientConfig(local_epochs=E, batch_size=BS),
                        capacity=capacity, max_examples=M, storage=storage,
                        clusters=clusters, initial_clients=init,
                        device="cpu",
                        x_layout=None if task is None
                        else task.device_layout), cd


def test_pool_admit_evict_roundtrip_exact_and_never_reallocates():
    pool, cd = _pool(capacity=5, n_init=3)
    ptrs = pool.data_ptrs()
    slot = pool.slot_of[1]
    row = pool.xs[slot].clone()
    sc, zp = float(pool.x_scale[slot]), float(pool.x_zero[slot])
    pool.evict(1)
    assert 1 not in pool.slot_of and pool.sizes[slot] == 0
    new_slot = pool.admit(1, *cd[1])
    assert torch.equal(pool.xs[new_slot], row)
    assert float(pool.x_scale[new_slot]) == sc
    assert float(pool.x_zero[new_slot]) == zp
    np.testing.assert_array_equal(pool.client_view(1)[0], cd[1][0])
    for i in range(3, 7):
        if pool.num_resident == pool.capacity:
            pool.evict(min(pool.slot_of))
        pool.admit(i, *cd[i])
    assert pool.data_ptrs() == ptrs
    assert pool.admits == pool.registry.get("pool.admits") == 8
    assert pool.evicts == pool.registry.get("pool.evicts") == 3
    assert pool.uploads == pool.admits
    assert pool.registry.get("pool.resident") == pool.num_resident == 5
    err = pool.registry.get("pool.quant.abs_err")
    assert err.count == pool.admits and err.mean > 0.0


def test_pool_rows_match_reference_pool():
    task = tm.CNNTask(image_shape=SHAPE, num_classes=2, width=4)
    pool, _ = _pool(task=task)
    ref, _ = _pool(pkg=jfl)
    for name in ("num_steps", "num_examples", "x_scale", "x_zero"):
        np.testing.assert_array_equal(getattr(pool, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(pool.xs.numpy(),
                                  np.moveaxis(np.asarray(ref.xs), -1, -3))
    np.testing.assert_array_equal(pool.ys.numpy(), np.asarray(ref.ys))
    assert pool.slot_of == ref.slot_of
    for seed in range(3):
        np.testing.assert_array_equal(
            pool.sample_slots(np.random.default_rng(seed), 3),
            ref.sample_slots(np.random.default_rng(seed), 3))
    np.testing.assert_array_equal(pool.slots_for([2, 0]),
                                  ref.slots_for([2, 0]))


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_pool_round_equals_bank_round_and_reference(storage):
    """A full pool's round is bitwise a ``ClientBank`` round of the same
    clients (unequal sizes: both take the masked SGD) and within 1e-4 of
    the reference's pool round."""
    sizes = [48, 20, 33, 48]
    cd = _client_data(sizes=sizes, seed=2)
    jeng, teng = _engines()
    cfg = dict(capacity=4, max_examples=48, storage=storage,
               initial_clients=dict(enumerate(cd)))
    pool = tfl.BankPool(teng.cfg, device="cpu",
                        x_layout=teng.task.device_layout, **cfg)
    jpool = jfl.BankPool(jeng.cfg, **cfg)
    bank = teng.make_bank(cd, tiered="single", storage=storage)
    assert bank.bucket_examples == pool.bucket_examples
    sel = np.asarray([3, 1, 0, 1], np.int32)
    slots = pool.slots_for(sel)
    (jp, jl), (pp, pl) = _round_pair(jeng, teng, jpool, pool, sel=slots)
    _, (bp, bl) = _round_pair(jeng, teng, jpool, bank, sel=sel)
    for name in pp:
        assert torch.equal(pp[name], bp[name]), name
    np.testing.assert_array_equal(pl, bl)
    _assert_close(pp, jp, teng.task)
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=TOL)


def test_pool_full_capacity_and_errors():
    pool, cd = _pool(capacity=4, n_init=4)
    with pytest.raises(ValueError, match="full"):
        pool.admit(99, *cd[0])
    with pytest.raises(ValueError, match="resident"):
        pool.evict(99)
    pool.evict(0)
    with pytest.raises(ValueError, match="already resident"):
        pool.admit(1, *cd[1])
    with pytest.raises(ValueError, match="occupied"):
        pool.sample_slots(np.random.default_rng(0), pool.capacity)
    with pytest.raises(ValueError, match="exceed"):
        pool.admit(50, *_client_data(1, M + 20)[0])
    with pytest.raises(ValueError, match="static spec"):
        pool.admit(51, cd[5][0].astype(np.float64), cd[5][1])
    with pytest.raises(ValueError, match="feature_shape"):
        tfl.BankPool(tfl.ClientConfig(batch_size=BS), capacity=2,
                     device="cpu")


def test_pool_clustered_assignment_is_admit_order_free():
    pool, cd = _pool(capacity=8, clusters=2, n_init=6)
    ref, _ = _pool(capacity=8, clusters=2, n_init=6, pkg=jfl)
    np.testing.assert_array_equal(pool.cluster_centroids,
                                  ref.cluster_centroids)
    feats = td.client_cluster_features([cd[6]])
    expect = int(td.assign_clusters(feats, pool.cluster_centroids)[0])
    slot = pool.admit(6, *cd[6])
    assert int(pool.cluster_of_device[slot]) == expect
    assert pool.cluster_of[slot] == expect


def test_pool_nbytes_beats_fp32_oneshot():
    pool, _ = _pool(capacity=8, n_init=4)
    f32 = tfl.estimate_bank_nbytes([M] * 8, BS, SHAPE)
    assert f32 / pool.nbytes > 3.3
    assert pool.bytes_per_client == pytest.approx(pool.nbytes / 8)
    assert pool.nbytes == sum(t.numel() * t.element_size() for t in (
        pool.xs, pool.ys, pool.num_steps, pool.num_examples, pool.x_scale,
        pool.x_zero))


# -- the arena over an int8 bank and a pool -------------------------------------


def _jax_scan_keys(rng, rows, k, rounds):
    out = np.zeros((rounds, k, E, rows), np.float32)
    for t in range(rounds):
        rng, _, k_cli = jax.random.split(rng, 3)
        out[t] = _keys([jax.random.fold_in(k_cli, i) for i in range(k)],
                       rows)
    return out


@pytest.mark.parametrize("kind", ["int8", "pool"])
@pytest.mark.parametrize("k_mode", ["pad", "group"])
def test_arena_over_int8_bank_and_pool_matches_reference(kind, k_mode):
    rounds, sizes = 2, [48, 20, 33, 48, 40, 48]
    cd = _client_data(sizes=sizes, seed=2)
    jeng, teng = _engines()
    if kind == "int8":
        jb = jeng.make_bank(cd, tiered="single", storage="int8")
        tb = teng.make_bank(cd, tiered="single", storage="int8")
    else:
        cfg = dict(capacity=6, max_examples=48,
                   initial_clients=dict(enumerate(cd)))
        jb = jfl.BankPool(jeng.cfg, **cfg)
        tb = tfl.BankPool(teng.cfg, device="cpu",
                          x_layout=teng.task.device_layout, **cfg)
    sp = jc.paper_default_params(num_devices=6, sample_count=3,
                                 local_epochs=E,
                                 data_sizes=np.asarray(sizes, np.float32))
    hp = jc.estimate_hyperparams(sp, 0.1, 1.5)

    def grid(pkg):
        return pkg.ScenarioGrid.create(["lroa", "uni_d", "lroa"],
                                       seeds=[3, 4, 5], V=hp.V, lam=hp.lam,
                                       sample_count=[3, 3, 2],
                                       num_devices=6)

    h = np.random.default_rng(5).uniform(0.05, 0.4, (3, rounds, 6)).astype(
        np.float32)
    lr = np.full(rounds, 0.1, np.float32)
    jp0 = jeng.task.init(jax.random.PRNGKey(0))
    jrep = jsim.Arena(jeng, k_mode=k_mode).run(jp0, sp, jb, grid(jsim),
                                               rounds, lr, h_all=h)
    roll = jsim.scenario_keys(grid(jsim))[1]
    keys = np.stack([_jax_scan_keys(roll[s], tb.bucket_examples, 3, rounds)
                     for s in range(3)])
    rep = tsim.Arena(teng, k_mode=k_mode).run(
        _port_params(jp0, teng.task), system_params_from_numpy(sp, "cpu"),
        tb, grid(tsim), rounds, lr, h_all=h,
        replay_selected=jrep.metrics["selected"], replay_sort_keys=keys)
    np.testing.assert_array_equal(rep.metrics["selected"],
                                  jrep.metrics["selected"])
    for name in METRICS:
        np.testing.assert_allclose(rep.metrics[name], jrep.metrics[name],
                                   rtol=TOL, atol=TOL, err_msg=name)
    for s in range(3):
        _assert_close({n: v[s] for n, v in rep.params.items()},
                      {n: v[s] for n, v in jrep.params.items()}, teng.task)
    assert rep.meta["bank_storage"] == jrep.meta["bank_storage"] == (
        "int8" if kind == "int8" else "fp32")
    assert rep.meta["bank_nbytes"] == tb.nbytes
    assert rep.meta["bank_bytes_per_client"] == tb.bytes_per_client
    assert rep.meta["buckets"][0]["tiers"] is None
