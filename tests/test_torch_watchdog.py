"""The port's warmup and retrace watchdog (``repro_torch.obs.Watchdog``,
``Arena.warmup``, ``SweepService.warmup``, ``BankPool.warmup``) against
the JAX package's on the CPU, at the reference's own test bed
(``tests/test_arena.py``'s ``_setup``: N = 6, an ``MLPTask``, K = 4):

* warmup then same-shape runs with other V, lam and seeds: no violation
  in either package;
* a K_max drift: one violation in each, with the same cache-key
  components; a run at T + 1: a violation in the JAX package (its scan
  retraces) and none in the port (a pinned divergence: eager PyTorch
  shapes no per-round tensor by T);
* strict raises, non-strict warns once and advances its baseline;
* ``stall_report`` bitwise the reference's on the same histograms;
* warmup's ``executables_built`` and plan equal the reference's under
  ``'pad'``, ``'group'`` and ``'auto'`` with a compile price above 0, and
  so does the cold run after it (the planner sees the warm buckets);
* a run after warmup bitwise a fresh arena's run; the sweep service's
  warmup leaves no violation; ``EvalBank.aot_warm`` is True in both;
  ``BankPool.warmup`` and churn give the reference's slots, free list
  and counters;
* the JAX package's ``tools/obs_report.py`` reads a port-written flight
  log with one violation as one violation."""

import dataclasses
import importlib.util
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fl as jfl  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs.watchdog import Watchdog as JWatchdog  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 system_params_from_numpy)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.obs import (RetraceError, Watchdog,  # noqa: E402
                             trace)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from test_arena import (N, _client_data, _mixed_grid,  # noqa: E402
                        _setup)

T = 3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_grid(grid):
    return tsim.ScenarioGrid(**{f.name: getattr(grid, f.name)
                                for f in dataclasses.fields(grid)})


def _values(seed: int, k: int = 4):
    """A same-shape grid of other V, lam and seeds (K = ``k``)."""
    g = _mixed_grid(s=4, k=k)
    return dataclasses.replace(g, V=g.V * (1.0 + seed),
                               lam=g.lam * (1.0 + seed), seed=g.seed + seed)


def _lr(t):
    return np.full(t, 0.1, np.float32)


@pytest.fixture(scope="module")
def bed():
    task, jeng, jbank, sp, p0 = _setup()
    ttask = tm.MLPTask(input_dim=64, num_classes=4, hidden=32)
    teng = tfl.RoundEngine(ttask, tfl.ClientConfig(local_epochs=2,
                                                   batch_size=16),
                           device="cpu")
    return dict(
        jeng=jeng, jbank=jbank, sp=sp, jp0=p0, teng=teng,
        tbank=teng.make_bank(_client_data([64] * N), "single"),
        tsp=system_params_from_numpy(sp, "cpu"),
        tp0=params_from_jax({n: np.asarray(v) for n, v in p0.items()},
                            ttask, device="cpu"))


def _watched(run, arena, dog, to_grid=lambda g: g):
    """Warm at T, then run: same shape with other values, a K_max drift,
    the drifted shape again, T + 1.  Returns the violation count after
    each run and the violation records."""
    warm = arena.warmup(*run["warm"], to_grid(_mixed_grid(s=4)), T)
    counts, metas = [], []
    for g, t in ((_values(1), T), (_values(2, k=3), T), (_values(3, k=3), T),
                 (_values(4, k=3), T + 1)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            metas.append(run["run"](to_grid(g), t).meta)
        counts.append(len(dog.violations))
    first = (warm["executables_built"], warm["plan"],
             metas[0]["executables_built"], metas[0]["plan"])
    return counts, list(dog.violations), first


@pytest.fixture(scope="module")
def watched(bed):
    """The same run sequence in both packages, under non-strict
    watchdogs."""
    out = {}
    ja = jsim.Arena(bed["jeng"])
    jdog = JWatchdog(strict=False).attach(ja)
    out["jax"] = _watched(dict(
        warm=(bed["jp0"], bed["sp"], bed["jbank"]),
        run=lambda g, t: ja.run(bed["jp0"], bed["sp"], bed["jbank"], g, t,
                                _lr(t))), ja, jdog)
    ta = tsim.Arena(bed["teng"])
    tdog = Watchdog(strict=False).attach(ta)
    loaded = len(_build.LOADED)
    out["torch"] = _watched(dict(
        warm=(bed["tp0"], bed["tsp"], bed["tbank"]),
        run=lambda g, t: ta.run(bed["tp0"], bed["tsp"], bed["tbank"], g, t,
                                _lr(t))), ta, tdog, _port_grid)
    out["kernel_builds"] = len(_build.LOADED) - loaded
    return out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_same_shape_runs_after_warmup_are_clean(watched, pkg):
    counts = watched[pkg][0]
    assert counts[0] == 0
    if pkg == "torch":
        assert watched["kernel_builds"] == 0


def test_k_max_drift_is_one_violation_with_the_same_key(watched):
    for pkg in ("jax", "torch"):
        counts, records, _ = watched[pkg]
        # the drift fires once; the drifted shape again is clean
        assert counts[1:3] == [1, 1], pkg
        assert records[0]["retraces"] == 1
        assert records[0]["run_meta"]["k_max"] == 3
    (jkey,), (tkey,) = (watched[p][1][0]["new_executables"]
                        for p in ("jax", "torch"))
    # (bank layout, K_max, shards, eval, dropout): numpy ints print
    # their type in the reference's repr
    assert jkey.replace("np.int64(", "").replace(")", "") == \
        tkey.replace(")", "")


def test_round_count_retraces_in_jax_only(watched):
    """The pinned divergence: a run at T + 1 retraces the reference's scan
    (a violation) and runs no new signature in the port."""
    assert watched["jax"][0][3] == 2
    assert watched["jax"][1][1]["retraces"] >= 1
    assert watched["jax"][1][1]["new_executables"] == []
    assert watched["torch"][0][3] == 1


def test_strict_raises_and_nonstrict_warns_once(bed):
    grid = _port_grid(_mixed_grid(s=4))
    args = (bed["tp0"], bed["tsp"], bed["tbank"])
    strict = tsim.Arena(bed["teng"])
    dog = Watchdog(strict=True).attach(strict)
    assert not dog.armed
    strict.warmup(*args, grid, T)
    assert dog.armed and dog.violations == []
    with pytest.raises(RetraceError, match="post-warmup retrace"):
        strict.run(*args, _port_grid(_values(1, k=3)), T, _lr(T))
    assert len(dog.violations) == 1

    loose = tsim.Arena(bed["teng"])
    dog = Watchdog(strict=False).attach(loose)
    loose.warmup(*args, grid, T)
    with pytest.warns(RuntimeWarning, match="post-warmup retrace"):
        loose.run(*args, _port_grid(_values(1, k=3)), T, _lr(T))
    # the baseline advanced: the drifted shape again is clean
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        loose.run(*args, _port_grid(_values(2, k=3)), T, _lr(T))
    assert len(dog.violations) == 1


def test_kernel_build_after_arming_is_a_violation(bed):
    """A kernel library loaded after warmup is cold work of its own,
    listed as ``kernel:<name>``."""
    arena = tsim.Arena(bed["teng"])
    dog = Watchdog(strict=True).attach(arena)
    grid = _port_grid(_mixed_grid(s=4))
    arena.warmup(bed["tp0"], bed["tsp"], bed["tbank"], grid, T)
    _build.LOADED.append("fl_aggregate")
    try:
        with pytest.raises(RetraceError, match="kernel:fl_aggregate"):
            arena.run(bed["tp0"], bed["tsp"], bed["tbank"], grid, T, _lr(T))
    finally:
        _build.LOADED.pop()
    assert dog.violations[0]["retraces"] == 0


def test_stall_report_matches_reference():
    rng = np.random.default_rng(4)
    regs = (JRegistry(), MetricsRegistry())
    for name in ("arena.chunk.dispatch_s", "arena.chunk.reduce_s"):
        for v in rng.exponential(0.01, 37):
            for reg in regs:
                reg.histogram(name).observe(float(v))
    want = JWatchdog.stall_report(regs[0])
    got = Watchdog.stall_report(regs[1])
    assert got == want and set(got) == {"dispatch", "reduce"}
    assert Watchdog.stall_report(MetricsRegistry()) == {}


def _two_k_grid():
    return jsim.ScenarioGrid.create(
        controllers=["lroa", "uni_d", "lroa", "uni_s"], seeds=[0, 1, 2, 3],
        V=100.0, lam=0.5, sample_count=[2, 4, 2, 4])


@pytest.mark.parametrize("k_mode", ["pad", "group", "auto"])
def test_warmup_builds_and_plans_as_the_reference(bed, watched, k_mode):
    """``executables_built`` and the plan of warmup, and of the cold run
    after it, equal the reference's (``'pad'``: the watched arenas' warmup
    and first run); under ``'auto'`` with a compile price above 0 the
    warmed split plan is what the run takes, since the planner sees the
    warm buckets as cached (a cold arena would pay the price per bucket
    and pad)."""
    if k_mode == "pad":
        assert watched["jax"][2] == watched["torch"][2]
        assert watched["torch"][2][0] == 1 and watched["torch"][2][2] == 0
        return
    prices = dict(unit_cost=1e-3, compile_cost=5.0, dispatch_cost=1e-3)
    grid = _two_k_grid()
    out = []
    for pkg, arena, args, g in (
            ("jax", jsim.Arena(bed["jeng"], k_mode=k_mode,
                               cost_model=jsim.CostModel(**prices)),
             (bed["jp0"], bed["sp"], bed["jbank"]), grid),
            ("torch", tsim.Arena(bed["teng"], k_mode=k_mode,
                                 cost_model=tsim.CostModel(**prices)),
             (bed["tp0"], bed["tsp"], bed["tbank"]), _port_grid(grid))):
        warm = arena.warmup(*args, g, T)
        rep = arena.run(*args, g, T, _lr(T))
        out.append((warm["executables_built"], warm["plan"],
                    rep.meta["executables_built"], rep.meta["plan"],
                    rep.dispatch_accounting()["executables_built"]))
        assert warm["executables_cached"] == warm["executables_built"]
    assert out[0] == out[1]
    built, plan = out[1][0], out[1][1]
    assert built == 2
    assert len(plan) == built and out[1][2] == 0
    if k_mode == "auto":
        cold = tsim.Arena(bed["teng"], k_mode="auto",
                          cost_model=tsim.CostModel(**prices))
        assert len(cold._plan(bed["tbank"], _port_grid(grid), T)
                   .buckets) == 1


def test_run_after_warmup_is_bitwise_a_fresh_run(bed):
    grid = _port_grid(_values(5))
    args = (bed["tp0"], bed["tsp"], bed["tbank"], grid, T, _lr(T))
    warmed = tsim.Arena(bed["teng"])
    warmed.warmup(*args[:4], T)
    assert warmed.metrics.get("arena.runs") == 0
    got = warmed.run(*args)
    want = tsim.Arena(bed["teng"]).run(*args)
    for name in want.metrics:
        np.testing.assert_array_equal(got.metrics[name], want.metrics[name])
    np.testing.assert_array_equal(got.queues, want.queues)
    for name in want.params:
        assert torch.equal(got.params[name], want.params[name]), name
    assert got.meta["executables_built"] == 0
    assert want.meta["executables_built"] == 1


def test_sweep_service_warmup_leaves_no_violation(bed, tmp_path):
    """Warm the service's shape (chunks of 2 over T = 4, an in-rollout
    evaluation every 2 rounds), then two submissions of other values
    under a strict watchdog."""
    from repro.data import synthetic_image_classification
    x, y = synthetic_image_classification(40, (8, 8, 1), 4, noise=0.3,
                                          seed=9)
    ev = tsim.EvalBank(bed["teng"].task, x, y, device="cpu")
    arena = tsim.Arena(bed["teng"], chunk_size=2)
    svc = tsim.SweepService(arena, bed["tp0"], bed["tsp"], bed["tbank"],
                            eval_bank=ev, eval_every=2,
                            checkpoint_dir=str(tmp_path))
    dog = Watchdog(strict=True).attach(arena)
    warm = svc.warmup(_port_grid(_values(0)), 4, _lr(4))
    assert warm["executables_built"] == 2     # start and resume
    tickets = [svc.submit(_port_grid(_values(s)), 4, _lr(4))
               for s in (6, 7)]
    assert svc.run_pending() == tickets
    assert dog.violations == [] and arena.metrics.get("arena.runs") == 1


def test_eval_bank_aot_warm_matches_reference(bed):
    """``aot_warm`` is True in both packages (the port runs one discarded
    stacked evaluation, the reference compiles it), and the port's bank
    evaluates as before after it, lane by lane as its one-model path."""
    from repro.data import synthetic_image_classification
    x, y = synthetic_image_classification(40, (8, 8, 1), 4, noise=0.3,
                                          seed=9)
    jev = jsim.EvalBank(bed["jeng"].task, x, y)
    tev = tsim.EvalBank(bed["teng"].task, x, y, device="cpu")
    assert jev.aot_warm(3, bed["jp0"]) is True
    assert tev.aot_warm(3, bed["tp0"]) is True
    stack = {n: torch.stack([v, 2 * v, -v]) for n, v in bed["tp0"].items()}
    got = tev.evaluate_stacked(stack)
    for s in range(3):
        one = tev.evaluate_one({n: v[s] for n, v in stack.items()})
        for name, v in one.items():
            assert got[name][s] == pytest.approx(v, rel=1e-6), name


def _pool(pkg, init: bool):
    cd = _client_data([40] * 6)
    kw = dict(capacity=5, max_examples=40)
    if init:
        kw["initial_clients"] = {i: cd[i] for i in range(2)}
    else:
        kw.update(feature_shape=cd[0][0].shape[1:],
                  feature_dtype=cd[0][0].dtype, label_dtype=cd[0][1].dtype)
    if pkg is jfl:
        return jfl.BankPool(jfl.ClientConfig(local_epochs=2, batch_size=16),
                            **kw), cd
    return tfl.BankPool(tfl.ClientConfig(local_epochs=2, batch_size=16),
                        device="cpu", **kw), cd


@pytest.mark.parametrize("init", [False, True], ids=["empty", "seeded"])
def test_bank_pool_warmup_and_churn_match_reference(init):
    states = []
    for pkg in (jfl, tfl):
        pool, cd = _pool(pkg, init)
        pool.warmup()
        trace_after_warmup = pool.traces
        for i in range(2, 5):
            pool.admit(f"c{i}", *cd[i])
        pool.evict("c3")
        pool.admit("c5", *cd[5])
        pool.warmup()
        states.append((dict(pool.slot_of), list(pool._free), pool.admits,
                       pool.evicts, pool.uploads, trace_after_warmup,
                       pool.traces, pool.sizes.tolist()))
    assert states[0] == states[1]
    assert states[1][5] == states[1][6] == 1


def test_obs_report_reads_a_port_violation(bed, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(ROOT, "tools", "obs_report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    log = str(tmp_path / "port.jsonl")
    arena = tsim.Arena(bed["teng"])
    dog = Watchdog(strict=False).attach(arena)
    args = (bed["tp0"], bed["tsp"], bed["tbank"])
    with trace.installed(trace.JsonlSink(log, flush_every=1)):
        arena.warmup(*args, _port_grid(_mixed_grid(s=4)), T)
        with pytest.warns(RuntimeWarning):
            arena.run(*args, _port_grid(_values(1, k=3)), T, _lr(T))
    health = report.health_summary(report.trace.load_jsonl(log))
    assert len(health["watchdog_violations"]) == 1 == len(dog.violations)
    assert health["watchdog_violations"][0]["new_executables"] == \
        dog.violations[0]["new_executables"]
