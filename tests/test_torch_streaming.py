"""The port's streaming sweep layer, mirroring ``tests/test_streaming.py``:
chunked arena runs (``Arena(chunk_size=)``, ``run(chunk_size=,
chunk_store=)``) bitwise the one-shot rollout at every chunking, across
``eval_every`` boundaries, for mixed K under pad, group and auto, on the
tier ladder and under ``batch='map'``; kill and resume through the
``SweepService`` bitwise, also where the kill falls between the files of
one save; the chunk tag covering the learning rates, a caller's
``drop_all``, the params, the bank's content (a pool through churn too)
and every SystemParams field (which the JAX package's tag leaves out,
ROADMAP section C); the service's coalescing against the JAX package's;
the ``k_mode='auto'`` planner (by K, against
``repro.sim.dispatch.plan_dispatch``); ``batch='map'`` lanes bitwise
``run_scan``; ``CostModel.calibrate``; and a chunked port
arena against the JAX ``Arena(chunk_size=2)`` with the reference's
selections and epoch keys replayed.  N = 6 (or the 12-client 3-rung
ladder), a tiny MLP, one CPU thread."""

import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.fl as jfl  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.data import synthetic_image_classification  # noqa: E402
from repro.sim.cost_model import CostModel as JCostModel  # noqa: E402
from repro.sim.dispatch import plan_dispatch as jplan_dispatch  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)
from repro_torch.fl.round_engine import bank_layout_key  # noqa: E402
from repro_torch.sim.dispatch import (DispatchPlan,  # noqa: E402
                                      lane_footprints)

E, BS = 2, 8
SIZES = [40, 24, 33, 17, 48, 30]
# chip_smoke.TIERED's clients: 3 tiers of 16, 32 and 64 rows at batch 8
LADDER = [12, 20, 9, 30, 40, 28, 60, 15, 64, 33, 14, 50]
TOL = 1e-4
MODELLED = ("wall_time", "energy_mean", "queue_mean", "queue_norm", "q_min",
            "q_max", "q_sum")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _clients(sizes, seed=3):
    x, y = synthetic_image_classification(sum(sizes), (8, 8, 1), 4,
                                          noise=0.3, seed=seed)
    offs = np.cumsum([0] + list(sizes))
    return [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
            for i in range(len(sizes))]


def _testbed(sizes, tiered):
    task = tm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    eng = tfl.RoundEngine(task, tfl.ClientConfig(local_epochs=E,
                                                 batch_size=BS),
                          device="cpu")
    clients = _clients(sizes)
    sp = tc.paper_default_params(num_devices=len(sizes), sample_count=3,
                                 local_epochs=E, device="cpu",
                                 data_sizes=np.asarray(sizes, np.float32))
    xt, yt = synthetic_image_classification(40, (8, 8, 1), 4, noise=0.3,
                                            seed=9)
    return dict(task=task, eng=eng, clients=clients, sp=sp,
                bank=eng.make_bank(clients, tiered),
                p0=task.init(torch.Generator().manual_seed(0)),
                hp=tc.estimate_hyperparams(sp, 0.1, loss_scale=1.5),
                n=len(sizes),
                evals=tsim.EvalBank(task, xt, yt, device="cpu"))


@pytest.fixture(scope="module")
def single():
    return _testbed(SIZES, "single")


@pytest.fixture(scope="module")
def ladder():
    b = _testbed(LADDER, "tiered")
    assert b["bank"].num_tiers == 3
    return b


def _grid(b, ks=(3, 3, 3, 3), controllers=("lroa", "uni_d", "divfl",
                                           "round_robin"), dropout=0.0):
    s = len(ks)
    return tsim.ScenarioGrid.create(
        list(controllers)[:s], seeds=np.arange(s) + 1,
        V=b["hp"].V, lam=b["hp"].lam, sample_count=list(ks),
        energy_scale=([1.0, 0.5, 2.0, 1.0] * 3)[:s],
        mean_gain=([0.1, 0.2, 0.05, 0.1] * 3)[:s], dropout=dropout,
        num_devices=b["n"])


MIXED_K = dict(ks=(2, 3, 2, 4, 3), controllers=("lroa", "uni_d", "lroa",
                                                "channel_aware", "uni_s"))


def _lr(t):
    return np.linspace(0.1, 0.05, t).astype(np.float32)


def _run(b, grid, t, arena=None, **kw):
    arena = arena if arena is not None else tsim.Arena(b["eng"])
    return arena.run(b["p0"], b["sp"], b["bank"], grid, t, _lr(t), **kw)


def _assert_bitwise(a, b, what=""):
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), (what, name)
    assert sorted(a.metrics) == sorted(b.metrics)
    for name in a.metrics:
        np.testing.assert_array_equal(a.metrics[name], b.metrics[name],
                                      err_msg=f"{what} {name}")
    np.testing.assert_array_equal(a.queues, b.queues, err_msg=what)
    assert sorted(a.final_metrics) == sorted(b.final_metrics)
    for name in a.final_metrics:
        np.testing.assert_array_equal(a.final_metrics[name],
                                      b.final_metrics[name], err_msg=name)


# -- chunked == one-shot ------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5, 6])
def test_chunked_is_bitwise_the_one_shot_run(single, chunk):
    """T = 5 in chunks of 1, 2, 3, T-1, T and T+1: ceil(T/chunk)
    dispatches, the ragged tail included, and the rollout bit for bit."""
    t = 5
    grid = _grid(single)
    mono = _run(single, grid, t)
    assert mono.meta["dispatches"] == 1 and mono.meta["chunk_size"] is None
    arena = tsim.Arena(single["eng"], chunk_size=chunk)
    rep = _run(single, grid, t, arena=arena)
    assert rep.meta["dispatches"] == math.ceil(t / chunk)
    assert rep.meta["chunk_size"] == chunk
    assert rep.dispatch_accounting()["dispatches"] == rep.meta["dispatches"]
    _assert_bitwise(mono, rep, f"chunk {chunk}")
    assert len(arena.metrics.histogram("arena.chunk.dispatch_s").values) \
        == math.ceil(t / chunk)


def test_chunked_eval_every_crosses_chunk_boundaries(single):
    """eval_every=3 in chunks of 2 over T = 7: the evaluations after
    rounds 2 and 5 fire inside chunks, and the step curve's value crosses
    the boundaries in the carry; test columns and final metrics bitwise."""
    t = 7
    grid = _grid(single, **MIXED_K)
    kw = dict(eval_bank=single["evals"], eval_every=3)
    mono = _run(single, grid, t, **kw)
    rep = _run(single, grid, t, chunk_size=2, **kw)
    assert rep.metrics["test_accuracy"].shape == (len(grid), t)
    assert rep.meta["dispatches"] == 4
    _assert_bitwise(mono, rep)
    acc = rep.metrics["test_accuracy"]
    np.testing.assert_array_equal(acc[:, 3], acc[:, 2])      # carried
    np.testing.assert_array_equal(acc[:, 4], acc[:, 2])


@pytest.mark.parametrize("k_mode", ["pad", "group", "auto"])
def test_chunked_mixed_k_every_mode(single, k_mode):
    t = 4
    grid = _grid(single, **MIXED_K)
    arena = tsim.Arena(single["eng"], k_mode=k_mode,
                       **(SPLIT if k_mode == "auto" else {}))
    mono = _run(single, grid, t, arena=arena)
    rep = _run(single, grid, t, arena=arena, chunk_size=3)
    assert len(mono.meta["buckets"]) == (1 if k_mode == "pad" else 3)
    _assert_bitwise(mono, rep, k_mode)
    assert rep.meta["plan"] == mono.meta["plan"]
    assert rep.meta["dispatches"] == 2 * mono.meta["dispatches"]
    assert rep.dispatch_accounting()["dispatches"] == rep.meta["dispatches"]


def test_chunked_ladder_is_bitwise(ladder):
    t = 5
    grid = _grid(ladder, ks=(4, 2, 4, 3), dropout=0.2)
    mono = _run(ladder, grid, t)
    rep = _run(ladder, grid, t, chunk_size=2)
    _assert_bitwise(mono, rep, "ladder")
    assert rep.meta["dispatches"] == 3


def test_chunked_map_is_bitwise(single):
    t = 5
    grid = _grid(single, **MIXED_K)
    arena = tsim.Arena(single["eng"], batch="map")
    mono = _run(single, grid, t, arena=arena)
    rep = _run(single, grid, t, arena=arena, chunk_size=2)
    _assert_bitwise(mono, rep, "map")
    assert rep.meta["batch"] == "map" and rep.meta["dispatches"] == 3


# -- kill and resume ----------------------------------------------------------


class _Kill(Exception):
    pass


def _kill_after_first_save(store):
    orig = store.save

    def save(tag, t_next, carry, metrics):
        orig(tag, t_next, carry, metrics)
        raise _Kill()
    store.save = save


def _kill_and_resume(b, grid, t, ckdir, **kw):
    """A service that dies at its first chunk checkpoint, then a fresh
    arena and service over the same directory; returns the resumed
    report and the second service."""
    def service():
        return tsim.SweepService(
            tsim.Arena(b["eng"], chunk_size=2), b["p0"], b["sp"],
            b["bank"], checkpoint_dir=str(ckdir), max_lanes=len(grid), **kw)

    first = service()
    _kill_after_first_save(first.store)
    first.submit(grid, t, _lr(t))
    with pytest.raises(_Kill):
        first.run_pending()
    assert first.store.saves == 1
    files = sorted(f.rsplit("_", 1)[1] for f in os.listdir(ckdir))
    assert files == ["carry.json", "carry.npz", "metrics.json",
                     "metrics.npz"]
    second = service()
    ticket = second.submit(grid, t, _lr(t))
    assert second.run_pending() == [ticket]
    rep = second.result(ticket)
    assert second.store.loads == 1
    assert os.listdir(ckdir) == []          # finish() removed the pair
    assert rep.meta["dispatches"] == math.ceil((t - 2) / 2)
    return rep, second


def test_kill_and_resume_is_bitwise_mixed_k_with_eval(single, tmp_path):
    t = 6
    grid = _grid(single, **MIXED_K)
    kw = dict(eval_bank=single["evals"], eval_every=2)
    ref = _run(single, grid, t, **kw)
    rep, svc = _kill_and_resume(single, grid, t, tmp_path, **kw)
    _assert_bitwise(ref, rep, "resumed")
    assert svc.metrics.get("store.loads") == 1


def test_kill_and_resume_is_bitwise_on_the_ladder(ladder, tmp_path):
    t = 6
    grid = _grid(ladder, ks=(4, 2, 4, 3), dropout=0.1)
    ref = _run(ladder, grid, t)
    rep, _ = _kill_and_resume(ladder, grid, t, tmp_path)
    _assert_bitwise(ref, rep, "resumed ladder")


@pytest.mark.parametrize("before", ["metrics.json", "carry.npz",
                                    "carry.json"])
def test_kill_inside_a_save_resumes_bitwise(single, tmp_path, monkeypatch,
                                            before):
    """A kill inside the second save (round 4), just before one of its
    file renames: the resume starts from the carry on disk at the round
    the carry itself records (round 4 where the carry's npz landed under
    round 2's manifest, else round 2) and is bitwise the uninterrupted
    run."""
    t = 6
    grid = _grid(single, **MIXED_K)
    ref = _run(single, grid, t)
    real, seen = os.replace, []

    def replace(src, dst):
        if str(dst).endswith("_" + before):
            seen.append(dst)
            if len(seen) == 2:
                raise _Kill()
        return real(src, dst)

    def service():
        return tsim.SweepService(
            tsim.Arena(single["eng"], chunk_size=2), single["p0"],
            single["sp"], single["bank"], checkpoint_dir=str(tmp_path),
            max_lanes=len(grid))

    first = service()
    first.submit(grid, t, _lr(t))
    with monkeypatch.context() as m:
        m.setattr(os, "replace", replace)
        with pytest.raises(_Kill):
            first.run_pending()
    assert first.store.saves == 1 and len(seen) == 2
    assert len(os.listdir(tmp_path)) == 4       # no temporary file left
    second = service()
    ticket = second.submit(grid, t, _lr(t))
    assert second.run_pending() == [ticket]
    rep = second.result(ticket)
    assert second.store.loads == 1 and os.listdir(tmp_path) == []
    resumed_at = 4 if before == "carry.json" else 2
    assert rep.meta["dispatches"] == (t - resumed_at) // 2
    _assert_bitwise(ref, rep, before)


# -- the chunk tag ------------------------------------------------------------


def _carry_like(b, s, evals=None):
    like = {"params": {n: torch.empty((s,) + tuple(v.shape))
                       for n, v in b["p0"].items()},
            "queues": torch.empty((s, b["n"]))}
    if evals is not None:
        like["last_ev"] = {n: torch.empty(v.shape, dtype=v.dtype) for n, v
                           in evals.carry_struct(b["p0"], s).items()}
    return like


@pytest.mark.parametrize("change", ["lr", "drop_all", "params", "bank",
                                    "bank_data", "system_params",
                                    "test_set"])
def test_chunk_tag_covers_what_the_reference_tag_leaves_out(single, tmp_path,
                                                            change):
    """A run killed after its first checkpoint, then a run of the same
    grid in the same directory with one input changed: the learning
    rates, a caller's alive mask, the initial params, the bank (int8, or
    fp32 of the same layout and bytes but other data), the SystemParams
    (the bandwidth) or the in-rollout evaluation's test set.  The second
    run must find no checkpoint and give its own inputs' rollout (the JAX
    package's tag would resume the first run's carry: ROADMAP section
    C)."""
    t = 4
    grid = _grid(single)
    rng = np.random.default_rng(4)
    base = dict(lr=_lr(t), params=single["p0"], bank=single["bank"],
                drop_all=(rng.uniform(size=(len(grid), t, single["n"]))
                          > 0.2).astype(np.float32),
                sp=single["sp"], test_set=single["evals"])
    other = dict(base)
    key = "bank" if change == "bank_data" else (
        "sp" if change == "system_params" else change)
    other[key] = {
        "lr": lambda: _lr(t)[::-1].copy(),
        "drop_all": lambda: np.ones_like(base["drop_all"]),
        "params": lambda: single["task"].init(
            torch.Generator().manual_seed(1)),
        "bank": lambda: single["eng"].make_bank(single["clients"], "single",
                                                storage="int8"),
        "bank_data": lambda: single["eng"].make_bank(_clients(SIZES, seed=4),
                                                     "single"),
        "system_params": lambda: dataclasses.replace(
            single["sp"], bandwidth_hz=2.0 * single["sp"].bandwidth_hz),
        "test_set": lambda: tsim.EvalBank(
            single["task"], *synthetic_image_classification(
                40, (8, 8, 1), 4, noise=0.3, seed=10), device="cpu"),
    }[change]()
    if change == "bank_data":
        assert bank_layout_key(other["bank"]) == bank_layout_key(base["bank"])
        assert other["bank"].nbytes == base["bank"].nbytes

    def run(inputs, store=None):
        return tsim.Arena(single["eng"], chunk_size=2).run(
            inputs["params"], inputs["sp"], inputs["bank"], grid, t,
            inputs["lr"], drop_all=inputs["drop_all"],
            eval_bank=inputs["test_set"], eval_every=1, chunk_store=store)

    def store():
        return tsim.NpzChunkStore(str(tmp_path), lambda s: _carry_like(
            single, s, single["evals"]))

    killed = store()
    _kill_after_first_save(killed)
    with pytest.raises(_Kill):
        run(base, killed)
    assert len(os.listdir(tmp_path)) == 4
    fresh = store()
    rep = run(other, fresh)
    assert fresh.loads == 0
    _assert_bitwise(run(other), rep, change)
    assert len(os.listdir(tmp_path)) == 4   # the killed run's pair stays
    resumed = store()
    _assert_bitwise(run(base), run(base, resumed), "same inputs")
    assert resumed.loads == 1 and os.listdir(tmp_path) == []


def test_chunk_tag_follows_a_bank_pool_through_churn(single, tmp_path):
    """One arena over one ``BankPool``: a run killed after its first
    checkpoint, then a client evicted and another of the same size
    admitted into its slot (the pool's tensors, layout and bytes stay).
    The run on the churned pool finds no checkpoint and gives the churned
    pool's rollout; the same arena's digest follows the churn."""
    t = 4
    grid = _grid(single)
    pool = tfl.BankPool(single["eng"].cfg, capacity=single["n"],
                        max_examples=max(SIZES),
                        initial_clients=dict(enumerate(single["clients"])),
                        device="cpu", x_layout=single["task"].device_layout)
    arena = tsim.Arena(single["eng"], chunk_size=2)

    def run(store=None):
        return arena.run(single["p0"], single["sp"], pool, grid, t, _lr(t),
                         chunk_store=store)

    def store():
        return tsim.NpzChunkStore(str(tmp_path),
                                  lambda s: _carry_like(single, s))

    killed = store()
    _kill_after_first_save(killed)
    with pytest.raises(_Kill):
        run(killed)
    ptrs, layout, nbytes = pool.data_ptrs(), bank_layout_key(pool), \
        pool.nbytes
    pool.evict(0)
    assert pool.admit("other", *_clients(SIZES, seed=5)[0]) == 0
    assert (pool.data_ptrs(), bank_layout_key(pool), pool.nbytes) == \
        (ptrs, layout, nbytes)
    fresh = store()
    rep = run(fresh)
    assert fresh.loads == 0
    _assert_bitwise(run(), rep, "churned pool")
    assert len(os.listdir(tmp_path)) == 4   # the killed run's pair stays


# -- the sweep service --------------------------------------------------------


def test_service_coalesces_and_splits_back(single):
    """Two 2-lane submissions with the same (T, lr) run as one 4-lane
    batch and split back: selections exact, the rest within 1e-5 of each
    submission's own run; a submission of another T waits its turn."""
    t = 4
    grid = _grid(single)
    svc = tsim.SweepService(tsim.Arena(single["eng"], chunk_size=2),
                            single["p0"], single["sp"], single["bank"],
                            max_lanes=8)
    ta = svc.submit(grid.take(np.array([0, 1])), t, _lr(t))
    tb = svc.submit(grid.take(np.array([2, 3])), t, _lr(t))
    tc_ = svc.submit(grid.take(np.array([0, 1])), t + 1, _lr(t + 1))
    assert sorted(svc.process_once()) == [ta, tb]
    assert svc.pending() == 1 and svc.stats["coalesced_lanes"] == [4]
    for ticket, idx in ((ta, [0, 1]), (tb, [2, 3])):
        rep = svc.result(ticket)
        own = _run(single, grid.take(np.array(idx)), t)
        assert rep.meta["split_from"] == 4 and len(rep.grid) == 2
        np.testing.assert_array_equal(rep.metrics["selected"],
                                      own.metrics["selected"])
        for name in own.metrics:
            np.testing.assert_allclose(rep.metrics[name], own.metrics[name],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(rep.queues, own.queues, rtol=1e-5,
                                   atol=1e-5)
        for name in own.params:
            np.testing.assert_allclose(rep.params[name].numpy(),
                                       own.params[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert svc.run_pending() == [tc_]
    assert svc.result(tc_).num_scenarios == 2
    assert svc.stats["batches"] == 2 and svc.stats["scenarios"] == 6
    with pytest.raises(KeyError):
        svc.result(tc_)
    # warmup runs the arena's bucket at its first chunk and its
    # continuation, both run by the batches above already: nothing new,
    # and a same-shape submission then runs no new signature either
    warm = svc.warmup(grid.take(np.array([0, 1])), t, _lr(t))
    assert warm["aot"] is False and warm["traces"] == 0
    assert warm["executables_built"] == 0
    assert warm["executables_cached"] == 2
    td = svc.submit(grid.take(np.array([2, 3])), t, _lr(t))
    assert svc.run_pending() == [td]
    assert svc.result(td).meta["executables_built"] == 0


def test_service_batch_is_the_arena_run_of_the_concatenated_grid(single):
    """Coalesced submissions run as the arena runs their concatenated
    grid, every lane on the channels its own seed draws: each split-back
    report is bitwise its lanes of that run; a submission of another lr
    schedule waits its turn."""
    t = 3
    grid = _grid(single)
    svc = tsim.SweepService(tsim.Arena(single["eng"]), single["p0"],
                            single["sp"], single["bank"])
    ta = svc.submit(grid.take(np.array([0, 1])), t, _lr(t))
    tb = svc.submit(grid.take(np.array([0])), t, _lr(t)[::-1].copy())
    tc_ = svc.submit(grid.take(np.array([2, 3])), t, _lr(t))
    assert svc.process_once() == [ta, tc_] and svc.pending() == 1
    assert svc.run_pending() == [tb]
    whole = _run(single, grid, t)
    for ticket, idx in ((ta, [0, 1]), (tc_, [2, 3])):
        rep = svc.result(ticket)
        for name in whole.metrics:
            np.testing.assert_array_equal(rep.metrics[name],
                                          whole.metrics[name][idx])
        np.testing.assert_array_equal(rep.queues, whole.queues[idx])
        for name in whole.params:
            assert torch.equal(rep.params[name], whole.params[name][idx])


class _QueueOnlyArena:
    """An arena stand-in that runs nothing: a report of zeros of the
    grid's shape, so two packages' services can be fed one submission
    sequence cheaply."""

    def __init__(self, pkg, registry):
        self.pkg, self.metrics = pkg, registry
        self.chunk_size, self.device = None, torch.device("cpu")

    def run(self, params, sp, bank, grid, num_rounds, lr_seq, **kw):
        s = len(grid)
        w = np.zeros((s, 1), np.float32)
        return self.pkg.RolloutReport(
            grid=grid, num_rounds=num_rounds,
            params={"w": torch.as_tensor(w) if self.pkg is tsim else w},
            queues=np.zeros((s, 1), np.float32),
            metrics={"loss": np.zeros((s, num_rounds), np.float32)},
            meta={"buckets": []})


def test_service_batches_as_the_reference_service():
    from repro.obs.metrics import MetricsRegistry as JMetrics
    from repro_torch.obs.metrics import MetricsRegistry as TMetrics

    subs = [(2, 3, 0.1), (3, 3, 0.1), (2, 4, 0.1), (1, 3, 0.2), (4, 3, 0.1),
            (1, 3, 0.1), (2, 4, 0.1), (5, 3, 0.2), (1, 4, 0.1)]
    out = {}
    for pkg, registry in ((jsim, JMetrics), (tsim, TMetrics)):
        svc = pkg.SweepService(_QueueOnlyArena(pkg, registry()), None,
                               jc.paper_default_params(num_devices=6),
                               None, max_lanes=6)
        tickets = [svc.submit(pkg.ScenarioGrid.create(
            "lroa", np.arange(s), 1.0, 0.1), t, np.full(t, lr, np.float32))
            for s, t, lr in subs]
        batches = []
        while svc.pending():
            batches.append(svc.process_once())
        for ticket in tickets:
            assert len(svc.result(ticket).grid) == subs[ticket][0]
        out[pkg.__name__] = (batches, svc.stats["coalesced_lanes"],
                             svc.stats["batches"], svc.stats["scenarios"])
    assert out["repro_torch.sim"] == out["repro.sim"]
    assert len(out["repro.sim"][0]) < len(subs)


# -- k_mode='auto' ------------------------------------------------------------


def _ladder_grid(ladder):
    return _grid(ladder, ks=(2, 4, 2, 4, 3, 3),
                 controllers=("lroa", "uni_d", "lroa", "uni_s", "divfl",
                              "round_robin"))


#: prices under which the ladder grid's K groups each get a bucket: the
#: JAX package's, without its compile
SPLIT = dict(cost_model=tsim.CostModel(compile_cost=0.0))


def test_auto_plans_by_k_alone(ladder):
    """Lanes of one K share a bucket whatever tiers their selections
    touch, and every bucket covers every rung: the port's training routes
    each slot by tier, so a bucket's tier subset would save nothing."""
    t = 1
    grid = _ladder_grid(ladder)
    arena = tsim.Arena(ladder["eng"], k_mode="auto", **SPLIT)
    rep = _run(ladder, grid, t, arena=arena)
    ks = grid.sample_count
    assert sorted((b["k_pad"], b["lanes"]) for b in rep.meta["buckets"]) \
        == [(int(k), np.flatnonzero(ks == k).tolist())
            for k in np.unique(ks)]
    assert all(b["tiers"] == [0, 1, 2] for b in rep.meta["buckets"])
    fps = lane_footprints(rep.metrics["selected"], ladder["bank"].tier_of)
    # a bucket holds lanes whose selections touched other tiers
    assert any(len({fps[s] for s in np.flatnonzero(ks == k)}) > 1
               for k in np.unique(ks)), fps


@pytest.mark.parametrize("prices", [dict(), dict(compile_cost=0.0,
                                                 dispatch_cost=0.0)],
                         ids=["default", "free_compile"])
@pytest.mark.parametrize("runs", [1.0, math.inf], ids=["cold", "steady"])
def test_plan_matches_the_reference_planner(ladder, prices, runs):
    """The port's plan equals ``repro.sim.dispatch.plan_dispatch`` on the
    same prices and tier work, with every lane on every tier."""
    t = 4
    grid = _ladder_grid(ladder)
    arena = tsim.Arena(ladder["eng"], k_mode="auto",
                       cost_model=tsim.CostModel(**prices))
    plan = arena._plan(ladder["bank"], grid, t, runs=runs)
    want = jplan_dispatch(
        grid.sample_count, rounds=t,
        tier_work=arena._tier_work(ladder["bank"]),
        cost_model=JCostModel(**prices), max_executables=4, runs=runs)
    assert plan.describe() == want.describe()


def test_default_prices_keep_a_small_grid_in_one_bucket(ladder):
    """The default prices charge a bucket round more than the padded
    slots of this grid cost, so ``auto`` runs it as the padded plan."""
    from repro_torch.sim.arena import DEFAULT_COST_MODEL

    t = 3
    grid = _ladder_grid(ladder)
    arena = tsim.Arena(ladder["eng"], k_mode="auto")
    assert arena.cost_model is DEFAULT_COST_MODEL
    assert DEFAULT_COST_MODEL.compile_cost == 0.0
    assert DEFAULT_COST_MODEL.round_cost > 0.0
    (bucket,) = _run(ladder, grid, t, arena=arena).meta["plan"]
    assert (bucket["lanes"], bucket["k_pad"]) == (list(range(len(grid))),
                                                  int(grid.sample_count
                                                      .max()))
    # a bucket's round is priced once per round, whatever its lanes
    assert tsim.CostModel(round_cost=0.5).bucket_seconds(
        2, t, 4, 8.0, cached=True, runs=1.0) == \
        tsim.CostModel().bucket_seconds(2, t, 4, 8.0, cached=True,
                                        runs=1.0) + 0.5 * t


def test_one_executable_gives_the_padded_plan(ladder):
    t = 3
    grid = _ladder_grid(ladder)
    rep = _run(ladder, grid, t, arena=tsim.Arena(
        ladder["eng"], k_mode="auto", max_executables=1))
    padded = DispatchPlan.padded(grid.sample_count).describe()[0]
    (bucket,) = rep.meta["plan"]
    assert (bucket["lanes"], bucket["k_pad"]) == (padded["lanes"],
                                                  padded["k_pad"])
    assert bucket["tiers"] == [0, 1, 2]
    assert rep.meta["dispatches"] == 1
    with pytest.raises(ValueError, match="max_executables"):
        tsim.Arena(ladder["eng"], max_executables=0)


def test_repeated_auto_grid_plans_and_runs_the_same(ladder):
    """The arena keeps no state across runs that a plan reads: a repeated
    grid plans the same buckets and runs bit for bit."""
    t = 3
    grid = _ladder_grid(ladder)
    arena = tsim.Arena(ladder["eng"], k_mode="auto", **SPLIT)
    first = _run(ladder, grid, t, arena=arena)
    second = _run(ladder, grid, t, arena=arena)
    assert len(first.meta["buckets"]) > 1
    assert second.meta["plan"] == first.meta["plan"]
    assert first.meta["executables_built"] == len(first.meta["buckets"])
    assert second.meta["executables_built"] == 0
    _assert_bitwise(first, second, "repeat")


def test_auto_selects_and_models_as_pad(ladder):
    """A bucketed run's selections, modelled metrics and queues are the
    padded run's bit for bit; each bucket's lanes train at its own
    ``k_pad``, so the losses agree within float32 rounding."""
    t = 4
    grid = _ladder_grid(ladder)
    auto = _run(ladder, grid, t, arena=tsim.Arena(ladder["eng"],
                                                  k_mode="auto", **SPLIT))
    pad = _run(ladder, grid, t)
    assert len(auto.meta["buckets"]) > 1
    assert auto.dispatch_accounting()["lanes_covered"] == len(grid)
    np.testing.assert_array_equal(auto.metrics["selected"],
                                  pad.metrics["selected"])
    for name in MODELLED:
        np.testing.assert_array_equal(auto.metrics[name], pad.metrics[name],
                                      err_msg=name)
    np.testing.assert_array_equal(auto.queues, pad.queues)
    np.testing.assert_allclose(auto.metrics["loss"], pad.metrics["loss"],
                               rtol=1e-5, atol=1e-6)


def test_calibrate_gives_finite_positive_costs(single):
    cm = tsim.CostModel.calibrate(single["eng"], single["sp"],
                                  single["bank"], rounds=2)
    for value in (cm.unit_cost, cm.compile_cost, cm.dispatch_cost):
        assert np.isfinite(value) and value > 0.0
    assert np.isfinite(cm.round_cost) and cm.round_cost >= 0.0
    assert tsim.CostModel.calibrate(single["eng"], single["sp"],
                                    single["bank"], rounds=1,
                                    dispatch_cost=0.5).dispatch_cost == 0.5


# -- batch='map' --------------------------------------------------------------


@pytest.mark.parametrize("k_mode", ["pad", "group", "auto"])
def test_map_lanes_are_bitwise_run_scan(single, k_mode):
    """Under ``batch='map'`` lane s makes the calls ``run_scan`` makes on
    its scenario (at its bucket's slot count): everything bitwise."""
    t = 3
    grid = _grid(single, ks=(2, 3, 2, 3), dropout=0.2)
    arena = tsim.Arena(single["eng"], batch="map", k_mode=k_mode,
                       **SPLIT)
    rep = _run(single, grid, t, arena=arena)
    h_all = arena.sample_channels(grid, t, single["n"])
    drop = arena.sample_dropout(grid, t, single["n"])
    k_of = {s: b["k_pad"] for b in rep.meta["buckets"] for s in b["lanes"]}
    for s in range(len(grid)):
        params, queues, met = single["eng"].run_scan(
            single["p0"], grid.scenario_system_params(single["sp"], s),
            single["bank"], h_all[s].numpy(), _lr(t),
            torch.Generator().manual_seed(int(grid.seed[s])),
            policy=grid.controller_names()[s], V=grid.V[s], lam=grid.lam[s],
            drop_seq=drop[s].numpy(), k_max=k_of[s])
        np.testing.assert_array_equal(
            rep.metrics["selected"][s][:, :k_of[s]], met["selected"])
        for name in met:
            if name != "selected":
                np.testing.assert_array_equal(rep.metrics[name][s],
                                              met[name], err_msg=name)
        np.testing.assert_array_equal(rep.queues[s], queues.numpy())
        for name in params:
            assert torch.equal(rep.params[name][s], params[name]), (s, name)


# -- against the JAX package --------------------------------------------------


def _jax_epoch_keys(rng, rows, k, t):
    """The reference scan's ``[T, k, E, B]`` epoch keys (per round ``rng,
    k_sel, k_cli = split(rng, 3)``, per slot ``fold_in(k_cli, i)``, then
    ``split(., E)`` and ``uniform``)."""
    out = np.zeros((t, k, E, rows), np.float32)
    for r in range(t):
        rng, _, k_cli = jax.random.split(rng, 3)
        for i in range(k):
            for e, ek in enumerate(jax.random.split(
                    jax.random.fold_in(k_cli, i), E)):
                out[r, i, e] = np.asarray(jax.random.uniform(ek, (rows,)))
    return out


def test_chunked_arena_matches_the_reference_chunked_arena():
    """A mixed-K grid with dropout and ``eval_every=2``, T = 5 in chunks
    of 2 through both packages' arenas (the reference's selections and
    epoch keys replayed): params, queues, every metric, the test columns
    and the final evaluation within 1e-4."""
    t, n = 5, len(SIZES)
    clients = _clients(SIZES)
    sp = jc.paper_default_params(num_devices=n, sample_count=3,
                                 local_epochs=E,
                                 data_sizes=np.asarray(SIZES, np.float32))
    jtask = jm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    ttask = tm.MLPTask(input_dim=64, num_classes=4, hidden=8)
    jeng = jfl.RoundEngine(jtask, jfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS))
    teng = tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=E,
                                                   batch_size=BS),
                           device="cpu")
    jbank, tbank = jeng.make_bank(clients, "single"), teng.make_bank(
        clients, "single")
    p0 = jtask.init(jax.random.PRNGKey(0))
    hp = jc.estimate_hyperparams(sp, 0.1, 1.5)
    xt, yt = synthetic_image_classification(40, (8, 8, 1), 4, noise=0.3,
                                            seed=9)
    controllers = ["lroa", "uni_d", "round_robin", "lroa", "uni_s"]
    ks = [3, 3, 2, 2, 3]

    def grid(pkg):
        return pkg.ScenarioGrid.create(controllers, seeds=np.arange(5) + 3,
                                       V=hp.V, lam=hp.lam, sample_count=ks)
    rng = np.random.default_rng(5)
    h = rng.uniform(0.05, 0.4, (5, t, n)).astype(np.float32)
    drop = (rng.uniform(size=(5, t, n)) >= 0.25).astype(np.float32)
    lr = _lr(t)
    jrep = jsim.Arena(jeng, chunk_size=2).run(
        p0, sp, jbank, grid(jsim), t, lr, h_all=h, drop_all=drop,
        eval_bank=jsim.EvalBank(jtask, xt, yt), eval_every=2)
    assert jrep.meta["dispatches"] == 3
    roll = jsim.scenario_keys(grid(jsim))[1]
    keys = np.stack([_jax_epoch_keys(roll[s], tbank.bucket_examples, 3, t)
                     for s in range(5)])
    rep = tsim.Arena(teng, chunk_size=2).run(
        params_from_jax({k: np.asarray(v) for k, v in p0.items()}, ttask,
                        device="cpu"),
        system_params_from_numpy(sp, "cpu"), tbank, grid(tsim), t, lr,
        h_all=h, drop_all=drop,
        eval_bank=tsim.EvalBank(ttask, xt, yt, device="cpu"), eval_every=2,
        replay_selected=jrep.metrics["selected"], replay_sort_keys=keys)
    assert rep.meta["dispatches"] == 3
    np.testing.assert_array_equal(rep.metrics["selected"],
                                  jrep.metrics["selected"])
    for name in jrep.metrics:
        if name != "selected":
            np.testing.assert_allclose(rep.metrics[name], jrep.metrics[name],
                                       rtol=TOL, atol=TOL, err_msg=name)
    for name in jrep.final_metrics:
        np.testing.assert_allclose(rep.final_metrics[name],
                                   jrep.final_metrics[name], rtol=TOL,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(rep.queues, np.asarray(jrep.queues),
                               rtol=TOL, atol=TOL)
    for s in range(5):
        want = params_from_jax({k: np.asarray(v[s])
                                for k, v in jrep.params.items()}, ttask,
                               device="cpu")
        for name, v in want.items():
            np.testing.assert_allclose(rep.params[name][s].numpy(),
                                       v.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"lane {s} {name}")
