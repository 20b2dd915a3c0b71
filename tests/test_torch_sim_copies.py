"""The port's copies of the JAX package's numpy-only modules give the
originals' results: ``sim.dispatch`` (plans, permutations, the planner
over a set of inputs, footprints), ``sim.cost_model``, ``obs.metrics``,
``RolloutReport``'s reducers on the same metric arrays (params as torch
tensors in the port), and the scale plane's part of ``data.pipeline``
(the int8 codes, the k-means cluster routing), bitwise."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.data.pipeline as jpipe  # noqa: E402
import repro.obs.metrics as jmetrics  # noqa: E402
import repro.sim as jsim  # noqa: E402
import repro_torch.data as td  # noqa: E402
import repro_torch.obs.metrics as tmetrics  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

PLANS = {
    "one_k": dict(sample_counts=[3, 3, 3], rounds=10),
    "mixed_k": dict(sample_counts=[2, 8, 2, 4, 8], rounds=50),
    "capped": dict(sample_counts=[1, 2, 3, 4, 5, 6], rounds=100,
                   max_executables=2),
    "steady": dict(sample_counts=[2, 8, 2, 4, 8], rounds=1000,
                   runs=math.inf),
    "tiers": dict(sample_counts=[2, 2, 4, 4], rounds=20,
                  tier_work={0: 32.0, 1: 512.0},
                  footprints=[(0,), (0, 1), (1,), (0,)]),
    "one_exec": dict(sample_counts=[2, 4, 8], rounds=5, max_executables=1),
    "cached": dict(sample_counts=[2, 4], rounds=5, runs=3.0,
                   cached_k=(4,)),
}


def _plan(pkg, case):
    kw = dict(PLANS[case])
    ks = kw.pop("sample_counts")
    cached = kw.pop("cached_k", None)
    if cached is not None:
        kw["is_cached"] = lambda b: b.k_pad in cached
    return pkg.plan_dispatch(ks, cost_model=pkg.CostModel(unit_cost=1e-4),
                             **kw)


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_dispatch_matches_reference(case):
    got, want = _plan(tsim, case), _plan(jsim, case)
    assert got.describe() == want.describe()
    np.testing.assert_array_equal(got.permutation(), want.permutation())
    np.testing.assert_array_equal(got.inverse_permutation(),
                                  want.inverse_permutation())
    np.testing.assert_array_equal(got.bucket_of(), want.bucket_of())
    assert got.k_max == want.k_max and got.num_buckets == want.num_buckets


def test_plan_decision_event_reaches_the_port_trace():
    with trace.installed(trace.MemorySink()) as sink:
        tsim.plan_dispatch([2, 3], rounds=4)
    (rec,) = sink.by_name("plan.decision")
    assert rec["dur"] == 0.0 and rec["attrs"]["lanes"] == 2


@pytest.mark.parametrize("ks", [[2], [3, 1, 3, 2], [5, 5, 4]])
def test_degenerate_plans_match_reference(ks):
    for ctor in ("padded", "grouped"):
        got = getattr(tsim.DispatchPlan, ctor)(ks)
        want = getattr(jsim.DispatchPlan, ctor)(ks)
        assert got.describe() == want.describe(), ctor
    with pytest.raises(ValueError):
        tsim.DispatchBucket(lanes=(), k_pad=2)


def test_lane_footprints_match_reference():
    rng = np.random.default_rng(0)
    sel = rng.integers(-1, 12, size=(5, 7, 4))
    tier_of = rng.integers(0, 3, size=12)
    assert tsim.lane_footprints(sel, tier_of) == \
        jsim.lane_footprints(sel, tier_of)


@pytest.mark.parametrize("args", [(1, 10, 8, 64.0), (7, 2000, 8, 256.0),
                                  (3, 5, 2, 1.0)])
def test_cost_model_matches_reference(args, tmp_path):
    got, want = tsim.CostModel(), jsim.CostModel()
    assert got == tsim.CostModel(**{f: getattr(want, f) for f in (
        "unit_cost", "compile_cost", "dispatch_cost")})
    lanes, rounds, k, work = args
    assert got.lane_seconds(rounds, k, work) == \
        want.lane_seconds(rounds, k, work)
    for cached in (False, True):
        for runs in (1.0, 4.0, math.inf):
            assert got.bucket_seconds(lanes, rounds, k, work, cached=cached,
                                      runs=runs) == want.bucket_seconds(
                lanes, rounds, k, work, cached=cached, runs=runs)
    # the tracked bench record, and a missing file (the defaults)
    for path in ("BENCH_round_engine.json", str(tmp_path / "none.json")):
        assert tsim.CostModel.from_bench_json(path).unit_cost == \
            jsim.CostModel.from_bench_json(path).unit_cost
    with pytest.raises(ValueError):
        tsim.CostModel(unit_cost=-1.0)


def _exercise(mod):
    reg = mod.MetricsRegistry()
    reg.counter("arena.runs").inc()
    reg.counter("arena.runs").inc(3)
    reg.gauge("pool.resident").set(7.5)
    reg.gauge("pool.resident").add(-1.0)
    hist = reg.histogram("arena.chunk.reduce_s", capacity=4)
    for v in (0.5, 0.1, 0.9, 0.3, 0.7, 0.2):
        hist.observe(v)
    return reg


def test_metrics_registry_matches_reference():
    got, want = _exercise(tmetrics), _exercise(jmetrics)
    assert got.snapshot() == want.snapshot()
    assert got.names() == want.names()
    assert got.get("arena.runs") == want.get("arena.runs") == 4
    h_got = got.histogram("arena.chunk.reduce_s")
    h_want = want.histogram("arena.chunk.reduce_s")
    assert h_got.percentiles() == h_want.percentiles()
    assert h_got.mean == h_want.mean


S, T, K, NDEV = 6, 5, 3, 8


@pytest.fixture(scope="module")
def reports():
    """The same metric arrays in a JAX and a port ``RolloutReport``."""
    rng = np.random.default_rng(1)
    args = (["lroa", "uni_d", "lroa"], [0, 1], [1.0], [0.1])
    kw = dict(sample_count=(3,), dropout=(0.0,))
    grids = (jsim.ScenarioGrid.product(*args, **kw),
             tsim.ScenarioGrid.product(*args, **kw))
    assert len(grids[0]) == S
    metrics = {name: rng.uniform(0.1, 2.0, (S, T)).astype(np.float32)
               for name in ("loss", "wall_time", "energy_mean",
                            "queue_mean", "queue_norm", "q_min", "q_max",
                            "test_accuracy", "test_loss")}
    metrics["selected"] = rng.integers(0, NDEV, (S, T, K))
    metrics["selected"][2, :, 2] = -1
    final = {"test_accuracy": rng.uniform(size=S).astype(np.float32),
             "test_loss": rng.uniform(size=S).astype(np.float32)}
    queues = rng.uniform(size=(S, NDEV)).astype(np.float32)
    params = {"w": rng.normal(size=(S, 4, 3)).astype(np.float32)}
    meta = dict(dispatches=1, executables_built=1, buckets=[dict(
        lanes=list(range(S)), k_pad=K, tiers=None, dispatches=1,
        executables_built=1)])
    out = []
    for grid, to in zip(grids, (np.asarray, torch.as_tensor)):
        out.append((jsim if to is np.asarray else tsim).RolloutReport(
            grid=grid, num_rounds=T,
            params={n: to(v) for n, v in params.items()}, queues=queues,
            metrics={n: v.copy() for n, v in metrics.items()},
            meta=dict(meta), final_metrics=dict(final)))
    return out


REDUCERS = ("latency_curve", "loss_curve", "queue_norm_curve",
            "accuracy_curve", "total_latency", "final_loss", "mean_energy",
            "final_queue_norm", "final_accuracy")


@pytest.mark.parametrize("name", REDUCERS)
def test_report_reducers_match_reference(reports, name):
    want, got = reports
    np.testing.assert_array_equal(getattr(got, name)(),
                                  getattr(want, name)())


def test_report_tables_match_reference(reports):
    want, got = reports
    np.testing.assert_array_equal(got.selection_counts(NDEV),
                                  want.selection_counts(NDEV))
    assert got.summary() == want.summary()
    assert got.tradeoff_table() == want.tradeoff_table()
    assert got.num_scenarios == want.num_scenarios == S
    assert got.dispatch_accounting()["dispatches"] == 1
    np.testing.assert_array_equal(got.scenario_params(3)["w"].numpy(),
                                  np.asarray(want.scenario_params(3)["w"]))


def test_report_take_and_chunk_concat_match_reference(reports):
    want, got = reports
    idx = [4, 1, 1]
    sub_w, sub_g = want.take(idx), got.take(idx)
    assert isinstance(sub_g.params["w"], torch.Tensor)
    np.testing.assert_array_equal(sub_g.params["w"].numpy(),
                                  np.asarray(sub_w.params["w"]))
    for name in want.metrics:
        np.testing.assert_array_equal(sub_g.metrics[name],
                                      sub_w.metrics[name])
    assert sub_g.meta["split_from"] == S and sub_g.meta["buckets"] == []
    assert got.meta["buckets"], "take must not mutate its parent's meta"
    chunks = [{n: v[:, :2] for n, v in want.metrics.items()},
              {n: v[:, 2:] for n, v in want.metrics.items()}]
    for n, v in tsim.concat_chunk_metrics(chunks).items():
        np.testing.assert_array_equal(
            v, jsim.concat_chunk_metrics(chunks)[n])
    with pytest.raises(ValueError):
        tsim.concat_chunk_metrics([])


def test_quantize_copies_match_reference_and_half_step_bound():
    rng = np.random.default_rng(0)
    stack = rng.normal(size=(6, 16, 4)).astype(np.float32) * \
        rng.uniform(0.1, 10.0, size=(6, 1, 1)).astype(np.float32)
    stack[2] = 2.5                                  # a constant row
    got, want = td.quantize_stack(stack), jpipe.quantize_stack(stack)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    q, scale, zero = got
    assert q.dtype == np.int8 and scale.shape == zero.shape == (6,)
    deq = td.dequantize_stack(q, scale, zero)
    np.testing.assert_array_equal(deq, jpipe.dequantize_stack(q, scale,
                                                              zero))
    assert (np.abs(deq - stack) <= 0.5 * scale[:, None, None] + 1e-7).all()
    np.testing.assert_array_equal(deq[2], stack[2])


def test_cluster_copies_match_reference():
    from repro.data import synthetic_image_classification
    sizes = [48, 20, 33, 48, 9, 40, 48, 12, 30, 48]
    x, y = synthetic_image_classification(sum(sizes), (4, 4, 1), 2,
                                          noise=0.3, seed=0)
    offs = np.cumsum([0] + sizes)
    cd = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
          for i in range(len(sizes))]
    feats = td.client_cluster_features(cd)
    np.testing.assert_array_equal(feats,
                                  jpipe.client_cluster_features(cd))
    for k in (1, 3, 20):
        (la, ca), (lb, cb) = (td.kmeans_clusters(feats, k),
                              jpipe.kmeans_clusters(feats, k))
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ca, cb)
        np.testing.assert_array_equal(td.assign_clusters(feats, ca),
                                      jpipe.assign_clusters(feats, cb))
    labels, cents = td.kmeans_clusters(feats, 3)
    np.testing.assert_array_equal(td.kmeans_clusters(feats, 3)[0], labels)
    assert set(np.unique(labels)) <= set(range(3))
