"""Client-axis and lane-axis sharding in the port (``launch.mesh``,
``RoundEngine(mesh=)``, the banks' placement, ``Arena(mesh=)``,
``FederatedTrainer(mesh=)``, ``server.aggregate_*_psum``) over
``torch.distributed``: one world of two gloo ranks on the CPU
(``launch.world.run_world``, a ``file://`` rendezvous under the test's
temporary directory, a deadline on the rendezvous, every collective and
the join) runs every sharded case, and the test process holds each rank's
result against the JAX package's UNSHARDED counterpart on the same
inputs (its draws passed in as data) and against the port's unsharded
run inside the ranks:

* ``round_step`` on the single bucket, on the 4-rung ladder (slots whose
  rows the other rank holds) and hierarchical over 2 clusters: params and
  losses within 1e-6 of the reference's round (its own sharded contract,
  ``tests/test_client_bank.py``); int8 rows, and a float16 ladder (its
  rows exchanged as float16), against the port's unsharded round; the
  float16 ladder's round bitwise the sharded round of an f32 ladder of
  the same values;
* a 2-round LROA ``run_scan`` with the reference's selections and epoch
  keys, and a ladder rollout against the port's own;
* a 4-lane ``Arena.run`` in 'vmap' and 'map': params within 1e-6,
  metrics and queues within rtol 1e-5, atol 1e-4 (the reference's
  arena contract, ``tests/test_arena.py``), eval columns, a mixed-K grid
  in two buckets ('group', dropout, the ladder), a chunked run resumed
  from one store;
* 2 rounds of the LROA ``FederatedTrainer`` (single bucket against the
  JAX trainer, the ladder against the port's unsharded trainer);
* the params on the two ranks bitwise equal after every case, the
  selections equal, each ``ValueError`` of the reference (K or the lane
  count not divisible, an arena over a meshed engine), one flight-
  recorder file per rank that the JAX package's reader takes.

The JAX side runs in the test process only: the ranks import this
module, which imports JAX nowhere at its top level.  The group-of-one
forms run in the test process over ``launch.mesh.make_host_mesh``: each
is bitwise its unsharded form (the same order of arithmetic)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.optim as topt  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.fl import server as tserver  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.world import run_world  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

N, K, E, BS, T = 8, 4, 2, 16, 2
SIZES = [64, 10, 33, 64, 100, 17, 48, 12]      # rungs 16, 32, 64, 128
# slot 0 reads a row rank 1 holds, slot 3 one rank 0 holds
SEL = np.asarray([7, 3, 5, 0])
COEFFS = np.asarray([0.2, 0.3, 0.1, 0.4], np.float32)
LR = 0.1
CONTROLLERS = ["lroa", "uni_d", "uni_s", "round_robin"]
ROUND_TOL = 1e-6                       # tests/test_client_bank.py:214-216
PARAM_TOL, METRIC_RTOL, METRIC_ATOL = 1e-6, 1e-5, 1e-4   # test_arena.py
TRAINER_TOL = 1e-4                     # tests/test_torch_trainer.py
METRICS = ("loss", "wall_time", "energy_mean", "queue_mean", "queue_norm",
           "q_min", "q_max")
WORLD_TIMEOUT = 240.0
ROUND_CASES = {"single": dict(tiered="single"),
               "tiered": dict(tiered="tiered"),
               "hier": dict(tiered="single", clusters=2),
               "int8": dict(tiered="single", storage="int8"),
               "f16": dict(tiered="tiered")}


def _task():
    return tm.MLPTask(input_dim=64, num_classes=4, hidden=8)


def _cfg():
    return tfl.ClientConfig(local_epochs=E, batch_size=BS)


def _tensors(tree):
    return {n: torch.as_tensor(np.array(v)) for n, v in tree.items()}


def _host(params):
    return {n: v.detach().cpu().numpy().copy() for n, v in params.items()}


def _report(rep):
    return dict(params=_host(rep.params), queues=np.asarray(rep.queues),
                metrics={k: np.asarray(v) for k, v in rep.metrics.items()},
                final=dict(rep.final_metrics), meta=rep.meta)


# -- the ranks' side (torch and repro_torch only) ----------------------------


def _half(clients):
    """The clients' features in float16."""
    return [(x.astype(np.float16), y) for x, y in clients]


def _rounds(p, eng, one, clients, p0):
    out = {}
    for case, kw in ROUND_CASES.items():
        data = _half(clients) if case == "f16" else clients
        bank, ref = eng.make_bank(data, **kw), one.make_bank(data, **kw)
        keys = torch.as_tensor(p["keys"]["tiered" if kw["tiered"] == "tiered"
                                         else "single"])
        hier = case == "hier"
        ps, ls = eng.round_step(_tensors(p0), bank, SEL, COEFFS, LR, keys,
                                hierarchical=hier)
        p1, l1 = one.round_step(_tensors(p0), ref, SEL, COEFFS, LR, keys,
                                hierarchical=hier)
        rungs = bank.tiers if isinstance(bank, tfl.TieredClientBank) \
            else [bank]
        out[case] = dict(
            params=_host(ps), losses=ls.numpy(), one_params=_host(p1),
            one_losses=l1.numpy(), nbytes=bank.nbytes, one_nbytes=ref.nbytes,
            placement=[(r.num_clients, r.row_sharded, r.row_start,
                        r.rows_held) for r in rungs])
    wide = [(x.astype(np.float32), y) for x, y in _half(clients)]
    pw, lw = eng.round_step(_tensors(p0), eng.make_bank(wide, "tiered"), SEL,
                            COEFFS, LR, torch.as_tensor(p["keys"]["tiered"]))
    out["f16"].update(widened_params=_host(pw), widened_losses=lw.numpy(),
                      xs_dtypes=[str(r.xs.dtype) for r in
                                 eng.make_bank(_half(clients),
                                               "tiered").tiers])
    try:
        eng.round_step(_tensors(p0), eng.make_bank(clients, "single"),
                       SEL[:3], COEFFS[:3], LR,
                       torch.as_tensor(p["keys"]["single"][:3]))
    except ValueError as err:
        out["k_error"] = str(err)
    return out


def _scans(p, eng, one, clients, p0, sp):
    kw = dict(policy="lroa", V=p["V"], lam=p["lam"],
              replay_selected=p["scan_selected"],
              replay_sort_keys=p["scan_keys"])
    out = {}
    for name, e in (("sharded", eng), ("one", one)):
        bank = e.make_bank(clients, "single")
        pr, q, met = e.run_scan(_tensors(p0), sp, bank, p["h"], p["lr"],
                                torch.Generator().manual_seed(0), **kw)
        out[name] = dict(params=_host(pr), queues=q.numpy(), metrics=met)
    for name, e in (("ladder", eng), ("ladder_one", one)):
        bank = e.make_bank(clients, "tiered")
        pr, q, met = e.run_scan(_tensors(p0), sp, bank, p["h"], p["lr"],
                                torch.Generator().manual_seed(4),
                                policy="uni_d", V=p["V"], lam=p["lam"])
        out[name] = dict(params=_host(pr), queues=q.numpy(), metrics=met)
    return out


def _arenas(p, mesh, one, clients, p0, sp, workdir):
    grid = tsim.ScenarioGrid.create(CONTROLLERS, seeds=np.arange(4) + 3,
                                    V=p["V"], lam=p["lam"], sample_count=K,
                                    num_devices=N)
    bank = one.make_bank(clients, "single")
    run = dict(h_all=p["arena_h"], replay_selected=p["arena_selected"],
               replay_sort_keys=p["arena_keys"])
    out = {}
    for batch in ("vmap", "map"):
        out[batch] = _report(tsim.Arena(one, mesh=mesh, batch=batch).run(
            _tensors(p0), sp, bank, grid, T, p["lr"], **run))
    mixed = tsim.ScenarioGrid.create(
        CONTROLLERS, seeds=np.arange(4) + 3, V=p["V"], lam=p["lam"],
        sample_count=[4, 2, 4, 2], dropout=[0.0, 0.2, 0.0, 0.1],
        num_devices=N)
    ladder = one.make_bank(clients, "tiered")
    for name, m in (("group", mesh), ("group_one", None)):
        out[name] = _report(tsim.Arena(one, mesh=m, k_mode="group").run(
            _tensors(p0), sp, ladder, mixed, T, p["lr"]))
    ev = tsim.EvalBank(one.task, p["xt"], p["yt"], device="cpu")
    out["eval"] = _report(tsim.Arena(one, mesh=mesh).run(
        _tensors(p0), sp, bank, grid, T, p["lr"], eval_bank=ev,
        eval_every=1, **run))
    out["eval_one"] = _report(tsim.Arena(one).run(
        _tensors(p0), sp, bank, grid, T, p["lr"], eval_bank=ev,
        eval_every=1, **run))

    def like(s):
        return {"params": {n: torch.empty((s,) + tuple(v.shape))
                           for n, v in p0.items()},
                "queues": torch.empty((s, N))}

    store_dir = os.path.join(workdir, "store")
    kept = tsim.NpzChunkStore(store_dir, like)
    kept.finish = lambda tag: None          # leave the t = 1 checkpoint
    arena = tsim.Arena(one, mesh=mesh, chunk_size=1)
    out["chunked"] = _report(arena.run(_tensors(p0), sp, bank, grid, T,
                                       p["lr"], chunk_store=kept, **run))
    store = tsim.NpzChunkStore(store_dir, like)
    out["resumed"] = _report(arena.run(_tensors(p0), sp, bank, grid, T,
                                       p["lr"], chunk_store=store, **run))
    out["resumed_loads"] = store.loads
    out["saves"] = kept.saves
    try:
        tsim.Arena(one, mesh=mesh).run(_tensors(p0), sp, bank,
                                       grid.take(np.arange(3)), T, p["lr"])
    except ValueError as err:
        out["lane_error"] = str(err)
    try:
        tsim.Arena(tfl.RoundEngine(one.task, one.cfg, device="cpu",
                                   mesh=mesh))
    except ValueError as err:
        out["engine_error"] = str(err)
    return out


def _trainers(p, mesh, clients, sp):
    out = {}

    def build(bank_mode, mesh_, keys):
        feed = iter(keys) if keys is not None else None
        tr = tfl.FederatedTrainer(
            _task(), sp, tc.LROAController(sp, tc.estimate_hyperparams(
                sp, 0.1, 1.5)),
            tfl.ChannelProcess(N, tfl.ChannelConfig(seed=0)), clients,
            _cfg(), topt.paper_step_decay(0.1, T), seed=0,
            bank_mode=bank_mode, device="cpu", mesh=mesh_,
            sort_keys_fn=None if feed is None else (lambda k: next(feed)))
        if keys is not None:
            tr.global_params = _tensors(p["trainer_p0"])
        return tr

    for name, bank_mode, mesh_, keys in (
            ("single", "single", mesh, p["trainer_keys"]),
            ("ladder", "auto", mesh, None), ("ladder_one", "auto", None,
                                             None)):
        tr = build(bank_mode, mesh_, keys)
        recs = [tr.run_round(t) for t in range(T)]
        out[name] = dict(
            params=_host(tr.global_params),
            selected=[r.selected for r in recs],
            loss=[r.mean_loss for r in recs],
            queues=tr.controller.queues.numpy().copy(),
            tiered=isinstance(tr.bank, tfl.TieredClientBank))
    return out


def _shard_job(p, rank, world_size):
    """Every sharded case on this rank (see the module docstring)."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_fl_mesh(device_type="cpu")
    sink = ttrace.install_sink(ttrace.JsonlSink(
        os.path.join(p["dir"], f"rank{rank}.jsonl")))
    task, cfg = _task(), _cfg()
    eng = tfl.RoundEngine(task, cfg, device="cpu", mesh=mesh)
    one = tfl.RoundEngine(task, cfg, device="cpu")
    clients, p0, sp = p["clients"], p["p0"], p["sp"]
    out = dict(axis=(mesh_lib.axis_size(mesh), mesh_lib.axis_rank(mesh)),
               rounds=_rounds(p, eng, one, clients, p0),
               scans=_scans(p, eng, one, clients, p0, sp),
               arenas=_arenas(p, mesh, one, clients, p0, sp, p["dir"]),
               trainers=_trainers(p, mesh, clients, sp))
    ttrace.remove_sink(sink)
    sink.close()
    out["jax_loaded"] = sorted(m for m in __import__("sys").modules
                               if m.split(".")[0] in ("jax", "repro"))
    return out


# -- the test process's side: the JAX reference, then the world ---------------


def _jax():
    jax = pytest.importorskip("jax")
    import repro.core as jc
    import repro.fl as jfl
    import repro.models as jm
    import repro.optim as jopt
    import repro.sim as jsim
    return jax, jc, jfl, jm, jopt, jsim


def _slot_keys(jax, rngs, rows_of_slot, width):
    """``[K, E, width]``: slot k's reference keys ``uniform(split(rngs[k],
    E)[e], (rows_of_slot[k],))``, zero-padded to ``width``."""
    out = np.zeros((len(rows_of_slot), E, width), np.float32)
    for k, rows in enumerate(rows_of_slot):
        for e, ek in enumerate(jax.random.split(rngs[k], E)):
            out[k, e, :rows] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def _scan_keys(jax, rng, rows):
    """The reference scan's ``[T, K, E, B]`` epoch keys."""
    out = np.zeros((T, K, E, rows), np.float32)
    for t in range(T):
        rng, _, k_cli = jax.random.split(rng, 3)
        for i in range(K):
            for e, ek in enumerate(jax.random.split(
                    jax.random.fold_in(k_cli, i), E)):
                out[t, i, e] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def _jax_params(tree, task):
    from repro_torch.convert import params_from_jax
    return _host(params_from_jax({n: np.asarray(v) for n, v in tree.items()},
                                 task, device="cpu"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's unsharded results and every rank's."""
    jax, jc, jfl, jm, jopt, jsim = _jax()
    from repro.data import synthetic_image_classification
    from repro_torch.convert import system_params_from_numpy

    x, y = synthetic_image_classification(sum(SIZES), (8, 8, 1), 4,
                                          noise=0.3, seed=3)
    offs = np.cumsum([0] + SIZES)
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(N)]
    ttask = _task()
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    jcfg = jfl.ClientConfig(local_epochs=E, batch_size=BS)
    jeng = jfl.RoundEngine(jtask, jcfg)
    jp0 = jtask.init(jax.random.PRNGKey(0))
    rngs = jax.random.split(jax.random.PRNGKey(5), K)
    ref, keys = {}, {}
    for case in ("single", "tiered", "hier"):
        kw = dict(ROUND_CASES[case])
        bank = jeng.make_bank(clients, kw.pop("tiered"), **kw)
        if case == "tiered":
            width = int(bank.tier_buckets[-1])
            rows = [bank.tier_buckets[bank.tier_of[c]] for c in SEL]
            keys["tiered"] = _slot_keys(jax, rngs, rows, width)
        else:
            width = bank.bucket_examples
            keys["single"] = _slot_keys(jax, rngs, [width] * K, width)
        jp, jl = jeng.round_step(jp0, bank, SEL, COEFFS, LR, rngs,
                                 hierarchical=case == "hier")
        ref[case] = dict(params=_jax_params(jp, ttask),
                         losses=np.asarray(jl))
    sp = jc.paper_default_params(num_devices=N, sample_count=K,
                                 local_epochs=E,
                                 data_sizes=np.asarray(SIZES, np.float32))
    hp = jc.estimate_hyperparams(sp, 0.1, 1.5)
    h = np.random.default_rng(5).uniform(0.05, 0.4, (T, N)).astype(
        np.float32)
    lr = np.asarray([0.1, 0.05], np.float32)
    single = jeng.make_bank(clients, "single")
    rows = single.bucket_examples
    jp, jq, jmet = jeng.run_scan(jp0, sp, single, h, lr,
                                 jax.random.PRNGKey(2), policy="lroa",
                                 V=hp.V, lam=hp.lam)
    ref["scan"] = dict(params=_jax_params(jp, ttask), queues=np.asarray(jq),
                       metrics={k: np.asarray(v) for k, v in jmet.items()})
    jgrid = jsim.ScenarioGrid.create(CONTROLLERS, seeds=np.arange(4) + 3,
                                     V=hp.V, lam=hp.lam, sample_count=K,
                                     num_devices=N)
    arena_h = np.random.default_rng(7).uniform(0.05, 0.4, (4, T, N)).astype(
        np.float32)
    jrep = jsim.Arena(jeng).run(jp0, sp, single, jgrid, T, lr,
                                h_all=arena_h)
    roll = jsim.scenario_keys(jgrid)[1]
    ref["arena"] = dict(params=_jax_params(jrep.params, ttask),
                        queues=np.asarray(jrep.queues),
                        metrics={k: np.asarray(v)
                                 for k, v in jrep.metrics.items()})
    jtr = jfl.FederatedTrainer(
        jtask, sp, jc.LROAController(sp, hp),
        jfl.ChannelProcess(N, jfl.ChannelConfig(seed=0)), clients, jcfg,
        jopt.paper_step_decay(0.1, T), seed=0, bank_mode="single")
    trainer_p0 = _jax_params(jtr.global_params, ttask)
    krng, trainer_keys = jax.random.PRNGKey(0), []
    for _ in range(T):
        step = np.zeros((K, E, rows), np.float32)
        for i in range(K):
            krng, sub = jax.random.split(krng)
            for e, ek in enumerate(jax.random.split(sub, E)):
                step[i, e] = np.asarray(jax.random.uniform(ek, (rows,)))
        trainer_keys.append(step)
    recs = [jtr.run_round(t) for t in range(T)]
    ref["trainer"] = dict(params=_jax_params(jtr.global_params, ttask),
                          selected=[r.selected for r in recs],
                          loss=[r.mean_loss for r in recs],
                          queues=np.asarray(jtr.controller.queues))
    from repro.data import synthetic_image_classification as synth
    xt, yt = synth(40, (8, 8, 1), 4, noise=0.3, seed=9)
    workdir = tmp_path_factory.mktemp("shard_world")
    payload = dict(
        dir=str(workdir), clients=clients, p0=_jax_params(jp0, ttask),
        sp=system_params_from_numpy(sp, "cpu"), keys=keys, V=float(hp.V),
        lam=float(hp.lam), h=h, lr=lr,
        scan_selected=np.asarray(jmet["selected"]),
        scan_keys=_scan_keys(jax, jax.random.PRNGKey(2), rows),
        arena_h=arena_h,
        arena_selected=np.asarray(jrep.metrics["selected"]),
        arena_keys=np.stack([_scan_keys(jax, roll[s], rows)
                             for s in range(4)]),
        trainer_p0=trainer_p0, trainer_keys=trainer_keys, xt=xt, yt=yt)
    ranks = run_world(_shard_job, 2, backend="gloo", workdir=workdir,
                      payload=payload, timeout=WORLD_TIMEOUT)
    return dict(ref=ref, ranks=ranks, dir=workdir)


def _close(got, want, atol, rtol=0.0, what=""):
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=atol,
                                   rtol=rtol, err_msg=f"{what} {name}")


def _bitwise(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for name in a:
        assert np.array_equal(a[name], b[name]), f"{what} {name}"


def test_ranks_see_the_data_axis_and_import_no_jax(world):
    for rank, out in enumerate(world["ranks"]):
        assert out["axis"] == (2, rank)
        assert out["jax_loaded"] == []


@pytest.mark.parametrize("case", ["single", "tiered", "hier"])
def test_sharded_round_matches_reference(world, case):
    want = world["ref"][case]
    for out in world["ranks"]:
        got = out["rounds"][case]
        _close(got["params"], want["params"], ROUND_TOL, what=case)
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   atol=ROUND_TOL)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_sharded_round_matches_unsharded_port(world, case):
    for out in world["ranks"]:
        got = out["rounds"][case]
        _close(got["params"], got["one_params"], ROUND_TOL, what=case)
        np.testing.assert_allclose(got["losses"], got["one_losses"],
                                   atol=ROUND_TOL)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_round_params_are_bitwise_across_ranks(world, case):
    a, b = (out["rounds"][case] for out in world["ranks"])
    _bitwise(a["params"], b["params"], case)
    assert np.array_equal(a["losses"], b["losses"])


def test_sharded_f16_round_is_bitwise_the_widened_round(world):
    """The float16 ladder keeps float16 rows on every rank and its
    sharded round (float16 rows exchanged, widened after the exchange)
    is bitwise the sharded round of an f32 ladder of the same values."""
    for out in world["ranks"]:
        got = out["rounds"]["f16"]
        assert set(got["xs_dtypes"]) == {"torch.float16"}
        _bitwise(got["params"], got["widened_params"], "f16")
        assert np.array_equal(got["losses"], got["widened_losses"])


def test_banks_place_rows_by_the_reference_rule(world):
    r0, r1 = (out["rounds"] for out in world["ranks"])
    # single bucket: N = 8 over 2 ranks, 4 rows each
    assert r0["single"]["placement"] == [(8, True, 0, 4)]
    assert r1["single"]["placement"] == [(8, True, 4, 4)]
    assert 2 * r0["single"]["nbytes"] == r0["single"]["one_nbytes"]
    assert 2 * r0["int8"]["nbytes"] == r0["int8"]["one_nbytes"]
    # the ladder, rung by rung: an odd rung is held whole on both ranks
    for got0, got1 in zip(r0["tiered"]["placement"],
                          r1["tiered"]["placement"]):
        n, sharded, start, held = got0
        assert sharded == (n % 2 == 0) == got1[1]
        assert (start, held) == ((0, n // 2) if sharded else (0, n))
        assert got1[2:] == ((n // 2, n // 2) if sharded else (0, n))
    assert r0["tiered"]["nbytes"] < r0["tiered"]["one_nbytes"]


def test_indivisible_sample_count_raises_as_the_reference(world):
    for out in world["ranks"]:
        assert out["rounds"]["k_error"] == (
            "sample_count 3 not divisible by mesh axis 'data' size 2")


def test_sharded_run_scan_matches_reference(world):
    want = world["ref"]["scan"]
    for out in world["ranks"]:
        got = out["scans"]["sharded"]
        np.testing.assert_array_equal(got["metrics"]["selected"],
                                      want["metrics"]["selected"])
        _close(got["params"], want["params"], PARAM_TOL, what="scan")
        _close(got["metrics"], {m: want["metrics"][m] for m in METRICS},
               METRIC_ATOL, METRIC_RTOL, "scan")
        np.testing.assert_allclose(got["queues"], want["queues"],
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL)


@pytest.mark.parametrize("case", [("sharded", "one"),
                                  ("ladder", "ladder_one")])
def test_sharded_run_scan_matches_unsharded_port(world, case):
    a, b = case
    for out in world["ranks"]:
        got, want = out["scans"][a], out["scans"][b]
        np.testing.assert_array_equal(got["metrics"]["selected"],
                                      want["metrics"]["selected"])
        _close(got["params"], want["params"], PARAM_TOL, what=a)
        _close(got["metrics"], {m: want["metrics"][m] for m in METRICS},
               METRIC_ATOL, METRIC_RTOL, a)
    p0, p1 = (out["scans"][a] for out in world["ranks"])
    _bitwise(p0["params"], p1["params"], a)


@pytest.mark.parametrize("batch", ["vmap", "map"])
def test_sharded_arena_matches_reference(world, batch):
    want = world["ref"]["arena"]
    for out in world["ranks"]:
        got = out["arenas"][batch]
        assert got["meta"]["shards"] == 2
        np.testing.assert_array_equal(got["metrics"]["selected"],
                                      want["metrics"]["selected"])
        _close(got["params"], want["params"], PARAM_TOL, what=batch)
        _close(got["metrics"], {m: want["metrics"][m] for m in METRICS},
               METRIC_ATOL, METRIC_RTOL, batch)
        np.testing.assert_allclose(got["queues"], want["queues"],
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL)
    a, b = (out["arenas"][batch] for out in world["ranks"])
    _bitwise(a["params"], b["params"], batch)
    _bitwise(a["metrics"], b["metrics"], batch)


def test_sharded_grouped_arena_matches_unsharded_port(world):
    """A mixed-K grid with dropout on the ladder under k_mode='group': two
    buckets of two lanes, each split over the ranks."""
    for out in world["ranks"]:
        got, want = out["arenas"]["group"], out["arenas"]["group_one"]
        assert len(got["meta"]["buckets"]) == 2
        np.testing.assert_array_equal(got["metrics"]["selected"],
                                      want["metrics"]["selected"])
        _close(got["params"], want["params"], PARAM_TOL, what="group")
        _close(got["metrics"], {m: want["metrics"][m] for m in METRICS},
               METRIC_ATOL, METRIC_RTOL, "group")
        np.testing.assert_allclose(got["queues"], want["queues"],
                                   rtol=METRIC_RTOL, atol=METRIC_ATOL)


def test_sharded_arena_gathers_eval_columns(world):
    for out in world["ranks"]:
        got, want = out["arenas"]["eval"], out["arenas"]["eval_one"]
        cols = [k for k in want["metrics"] if k.startswith("test_")]
        assert cols and sorted(got["final"]) == sorted(want["final"])
        _close(got["metrics"], {k: want["metrics"][k] for k in cols},
               METRIC_ATOL, METRIC_RTOL, "eval")
        _close(got["final"], want["final"], METRIC_ATOL, METRIC_RTOL,
               "final")
        _close(got["params"], want["params"], PARAM_TOL, what="eval")


def test_sharded_chunked_arena_resumes_from_one_store(world):
    for rank, out in enumerate(world["ranks"]):
        arenas = out["arenas"]
        # rank 0 alone writes the gathered carry; every rank resumes
        assert arenas["saves"] == (1 if rank == 0 else 0)
        assert arenas["resumed_loads"] == 1
        for run in ("chunked", "resumed"):
            _bitwise(arenas[run]["params"], arenas["vmap"]["params"], run)
            _bitwise(arenas[run]["metrics"], arenas["vmap"]["metrics"], run)
            assert np.array_equal(arenas[run]["queues"],
                                  arenas["vmap"]["queues"])


def test_sharded_arena_raises_as_the_reference(world):
    for out in world["ranks"]:
        arenas = out["arenas"]
        assert arenas["lane_error"].startswith(
            "scenario count 3 not divisible by mesh axis 'data' size 2")
        assert "build the RoundEngine without a mesh" in \
            arenas["engine_error"]


def test_sharded_trainer_matches_reference(world):
    want = world["ref"]["trainer"]
    for out in world["ranks"]:
        got = out["trainers"]["single"]
        assert got["selected"] == want["selected"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   atol=TRAINER_TOL, rtol=TRAINER_TOL)
        _close(got["params"], want["params"], TRAINER_TOL, TRAINER_TOL,
               "trainer")
        np.testing.assert_allclose(got["queues"], want["queues"],
                                   atol=TRAINER_TOL, rtol=TRAINER_TOL)


def test_sharded_trainer_on_the_ladder_matches_unsharded_port(world):
    for out in world["ranks"]:
        got, want = out["trainers"]["ladder"], out["trainers"]["ladder_one"]
        assert got["tiered"] and want["tiered"]
        assert got["selected"] == want["selected"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   atol=ROUND_TOL)
        _close(got["params"], want["params"], ROUND_TOL, what="ladder")
        assert np.array_equal(got["queues"], want["queues"])
    for case in ("single", "ladder"):
        a, b = (out["trainers"][case] for out in world["ranks"])
        _bitwise(a["params"], b["params"], case)


def test_every_rank_leaves_a_flight_recorder_file(world):
    pytest.importorskip("jax")
    from repro.obs import trace as jtrace
    for rank in range(2):
        path = os.path.join(world["dir"], f"rank{rank}.jsonl")
        records = jtrace.load_jsonl(path)
        assert records == ttrace.load_jsonl(path)
        names = {r["name"] for r in records}
        assert {"engine.round", "arena.run", "arena.gather",
                "trainer.round"} <= names
        events = jtrace.to_chrome_trace(records)["traceEvents"]
        assert len(events) == len(records) + 1


# -- one rank in the test process -------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    import torch.distributed as dist
    owned = not dist.is_initialized()
    mesh = mesh_lib.make_host_mesh()
    yield mesh
    if owned:
        dist.destroy_process_group()


def _leaves(gen, dtype, k=3):
    params = {"w": torch.randn(5, 3, generator=gen).to(dtype),
              "b": torch.randn(3, generator=gen).to(dtype),
              "s": torch.randn((), generator=gen).to(dtype)}
    deltas = {n: torch.randn((k,) + tuple(v.shape), generator=gen)
              for n, v in params.items()}
    return params, deltas, torch.softmax(torch.randn(k, generator=gen), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["fused", "hierarchical"])
def test_psum_forms_of_one_rank_are_bitwise_unsharded(host_mesh, form,
                                                      dtype):
    params, deltas, coeffs = _leaves(torch.Generator().manual_seed(1), dtype)
    if form == "fused":
        got = tserver.aggregate_fused_psum(params, deltas, coeffs, host_mesh)
        want = tserver.aggregate_fused(params, deltas, coeffs)
    else:
        sel = torch.as_tensor([1, 0, 1])
        got = tserver.aggregate_hierarchical_psum(params, deltas, coeffs,
                                                  sel, 2, host_mesh)
        want = tserver.aggregate_hierarchical(params, deltas, coeffs, sel, 2)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == dtype
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("mode", ["single", "tiered"])
def test_one_rank_mesh_round_and_scan_are_bitwise_unsharded(host_mesh, mode):
    from repro_torch.core import paper_default_params
    from repro_torch.data import synthetic_image_classification
    x, y = synthetic_image_classification(sum(SIZES), (8, 8, 1), 4,
                                          noise=0.3, seed=3)
    offs = np.cumsum([0] + SIZES)
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(N)]
    task, cfg = _task(), _cfg()
    eng = tfl.RoundEngine(task, cfg, device="cpu", mesh=host_mesh)
    one = tfl.RoundEngine(task, cfg, device="cpu")
    bank, ref = eng.make_bank(clients, mode), one.make_bank(clients, mode)
    p0 = task.init(torch.Generator().manual_seed(0))
    keys = torch.rand((K, E, bank.bucket_examples),
                      generator=torch.Generator().manual_seed(3))
    got = eng.round_step(_tensors(_host(p0)), bank, SEL, COEFFS, LR, keys)
    want = one.round_step(_tensors(_host(p0)), ref, SEL, COEFFS, LR, keys)
    for name in want[0]:
        assert torch.equal(got[0][name], want[0][name]), name
    assert torch.equal(got[1], want[1])
    sp = paper_default_params(num_devices=N, sample_count=K, local_epochs=E,
                              data_sizes=np.asarray(SIZES, np.float32),
                              device="cpu")
    h = np.random.default_rng(5).uniform(0.05, 0.4, (T, N)).astype(
        np.float32)
    runs = [e.run_scan(_tensors(_host(p0)), sp, b, h, [0.1, 0.05],
                       torch.Generator().manual_seed(1), policy="uni_s")
            for e, b in ((eng, bank), (one, ref))]
    for name in runs[1][0]:
        assert torch.equal(runs[0][0][name], runs[1][0][name]), name
    for name, v in runs[1][2].items():
        assert np.array_equal(runs[0][2][name], v), name


def test_mesh_helpers_refuse_what_is_not_a_data_mesh(host_mesh,
                                                     monkeypatch):
    from torch.distributed.device_mesh import DeviceMesh
    assert (mesh_lib.axis_size(host_mesh), mesh_lib.axis_rank(host_mesh)) \
        == (1, 0)
    assert host_mesh.mesh_dim_names == ("data",)
    with pytest.raises(TypeError, match="DeviceMesh"):
        mesh_lib.axis_size(object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tfl.RoundEngine(_task(), _cfg(), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="no axis 'data'"):
        mesh_lib.check_mesh(DeviceMesh("cpu", [0],
                                       mesh_dim_names=("model",)))
    with pytest.raises(ValueError, match="differs from the process group"):
        mesh_lib.make_fl_mesh(num_shards=2, device_type="cpu")
    assert mesh_lib.make_fl_mesh(device_type="cpu").mesh_dim_names == \
        ("data",)
    with pytest.raises(ValueError, match="build the RoundEngine without"):
        tsim.Arena(tfl.RoundEngine(_task(), _cfg(), device="cpu",
                                   mesh=host_mesh))
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="initialised process group"):
        mesh_lib.make_fl_mesh(device_type="cpu")


def _failing_job(payload, rank, world_size):
    import torch.distributed as dist
    if rank == payload["bad"]:
        raise ValueError(f"rank {rank} fails")
    dist.barrier()
    return rank


def _hanging_job(payload, rank, world_size):
    import time
    if rank == payload["bad"]:
        time.sleep(3600)
    return rank


def test_a_failing_rank_fails_the_world_at_once(tmp_path):
    """The failing rank's error is raised as soon as it fails: the rank
    waiting in a barrier is killed long before the deadline."""
    import time
    import torch.multiprocessing as mp
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException, match="rank 1 fails"):
        run_world(_failing_job, 2, backend="gloo", workdir=tmp_path,
                  payload={"bad": 1}, timeout=WORLD_TIMEOUT)
    assert time.monotonic() - t0 < WORLD_TIMEOUT / 2
    assert mp.active_children() == []


def test_a_hung_rank_fails_the_world_at_its_deadline(tmp_path):
    import torch.multiprocessing as mp
    with pytest.raises(TimeoutError, match="deadline"):
        run_world(_hanging_job, 2, backend="gloo", workdir=tmp_path,
                  payload={"bad": 1}, timeout=20.0)
    assert mp.active_children() == []
