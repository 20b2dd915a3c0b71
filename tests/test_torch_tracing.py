"""The port's tracer beyond the flight recorder (``repro_torch.obs.trace``):
the shared no-op without a sink (``span``, ``device=True`` too, and
``count``), the counters and their per-name ``totals``, the device spans
held back until ``resolve_device``, ``ts_ns`` on ``torch.profiler``'s
clock and the Chrome export on it; and the spans and counter the round
engine, the solver and the arena emit (``scan.select``, ``scan.outputs``,
``engine.route``, ``engine.train_tier``, ``engine.eval``,
``solver.loop_tests``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import estimate_hyperparams  # noqa: E402
from repro_torch.core import paper_default_params  # noqa: E402
from repro_torch.core import solver  # noqa: E402
from repro_torch.data import synthetic_image_classification  # noqa: E402
from repro_torch.fl import ClientConfig, RoundEngine  # noqa: E402
from repro_torch.models import MLPTask  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.sim import Arena, EvalBank, ScenarioGrid  # noqa: E402

N, K, E, BS = 6, 3, 2, 8
# two size tiers at batch 8: a ladder of two rungs
SIZES = [16, 16, 16, 60, 60, 60]


@pytest.fixture(autouse=True)
def _clean():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear_sinks()
    yield
    trace.clear_sinks()
    trace.profiler_bridge(False)
    torch.set_num_threads(prev)


class _Forbidden:
    """Stands in for the ``time`` module: any clock read fails."""

    def __getattr__(self, name):
        raise AssertionError(f"clock read without a sink: time.{name}")


def test_without_a_sink_span_and_count_are_the_shared_no_op(monkeypatch):
    def no_cuda():
        raise AssertionError("CUDA call without a sink")

    monkeypatch.setattr(trace, "time", _Forbidden())
    monkeypatch.setattr(trace, "_device_events", no_cuda)
    before = trace.totals()
    a = trace.span("engine.lanes_round", device=True, t=0)
    assert a is trace.span("x") is trace._NOOP
    with a as live:
        assert live is trace._NOOP
        assert trace.count("solver.loop_tests") is None
    trace.resolve_device()
    assert trace.totals() == before
    assert not trace._PENDING


def test_totals_restart_on_the_first_sink_and_sum_counters_innermost():
    with trace.installed(trace.MemorySink()) as sink:
        with trace.span("old"):
            trace.count("c")
    assert trace.totals()["old"]["counters"] == {"c": 1}
    # nothing is kept while no sink is installed
    with trace.span("between"):
        trace.count("c")
    assert "between" not in trace.totals()
    first, second = trace.MemorySink(), trace.MemorySink()
    trace.install_sink(first)
    trace.install_sink(second)          # not the first: no restart
    try:
        trace.count("c", 2)             # no span live
        with trace.span("outer"):
            trace.count("c")
            for _ in range(3):
                with trace.span("inner", k=1):
                    trace.count("c")
                    trace.count("d", 5)
        trace.event("e")
    finally:
        trace.remove_sink(second)
        trace.remove_sink(first)
    tot = trace.totals()
    assert set(tot) == {"outer", "inner", "e", trace.OUTSIDE}
    assert tot["inner"]["calls"] == 3 and tot["outer"]["calls"] == 1
    assert tot["inner"]["counters"] == {"c": 3, "d": 15}
    assert tot["outer"]["counters"] == {"c": 1}
    assert tot[trace.OUTSIDE]["counters"] == {"c": 2}
    assert tot["outer"]["host_s"] >= tot["inner"]["host_s"] > 0.0
    assert tot["inner"]["device_s"] is None
    # each record carries its own counts; one sink got each record once
    inner = first.by_name("inner")
    assert [r["attrs"] for r in inner] == [{"k": 1, "c": 1, "d": 5}] * 3
    assert len(second.by_name("inner")) == 3
    assert not sink.by_name("inner")
    # a copy: changing it leaves the table alone
    tot["inner"]["counters"]["c"] = 0
    assert trace.totals()["inner"]["counters"]["c"] == 3


class _FakeEvent:
    """A CUDA timing event's interface over a shared fake stream clock."""

    clock = {"now": 0.0, "done": 0.0}

    def record(self):
        self.at = _FakeEvent.clock["now"]

    def query(self):
        return self.at <= _FakeEvent.clock["done"]

    def elapsed_time(self, other):
        return other.at - self.at       # milliseconds


def test_device_spans_wait_for_resolve_and_keep_their_parent(monkeypatch):
    clock = _FakeEvent.clock
    clock.update(now=0.0, done=0.0)
    monkeypatch.setattr(trace, "_device_events",
                        lambda: (_FakeEvent(), _FakeEvent()))
    with trace.installed(trace.MemorySink()) as sink:
        with trace.span("arena.dispatch") as parent:
            with trace.span("engine.lanes_round", device=True, t=4):
                trace.count("n", 2)
                clock["now"] = 250.0        # the stream's work: 250 ms
        assert [r["name"] for r in sink.records] == ["arena.dispatch"]
        trace.resolve_device()             # the stream has not got there
        assert len(sink.records) == 1 and len(trace._PENDING) == 1
        clock["done"] = 250.0              # a read-back drained it
        trace.resolve_device()
        rec = sink.by_name("engine.lanes_round")[0]
        assert rec["parent"] == parent.id and rec["depth"] == 1
        assert rec["attrs"] == {"t": 4, "n": 2, "device_s": 0.25}
        assert not trace._PENDING
        tot = trace.totals()["engine.lanes_round"]
        assert tot["device_s"] == 0.25 and tot["counters"] == {"n": 2}
        # one left pending when the last sink goes is dropped
        with trace.span("engine.lanes_round", device=True):
            clock["now"] = 300.0
    clock["done"] = 300.0
    trace.resolve_device()
    assert not trace._PENDING
    assert len(sink.by_name("engine.lanes_round")) == 1


def test_a_device_span_without_cuda_is_emitted_at_once():
    with trace.installed(trace.MemorySink()) as sink:
        with trace.span("engine.lanes_round", device=True):
            pass
    (rec,) = sink.records
    assert "device_s" not in rec["attrs"] and not trace._PENDING
    assert trace.totals()["engine.lanes_round"]["device_s"] is None


def test_ts_ns_lies_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    trace.profiler_bridge(True)
    with trace.installed(trace.MemorySink()):
        with trace.span("warm"):        # the bridge's first-call imports
            pass
    with trace.installed(trace.MemorySink()) as sink, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("scan.select"):
                torch.ones(4).sum()
    starts = sorted(ev.start_ns() for ev in
                    prof.profiler.kineto_results.events()
                    if ev.name() == "scan.select")
    mine = sorted(r["ts_ns"] for r in sink.records)
    assert len(starts) == len(mine) == 3
    for a, b in zip(mine, starts):
        assert abs(a - b) < 1_000_000, (a, b)


def test_chrome_export_on_the_profilers_clock():
    with trace.installed(trace.MemorySink()) as sink:
        with trace.span("arena.run"):
            trace.event("plan.decision")
    records = list(sink.records)
    base = records[0]["ts_ns"] - 5_000
    got = trace.to_chrome_trace(records, "x", base_ns=base)["traceEvents"]
    assert [e["ph"] for e in got] == ["M", "i", "X"]
    for e, r in zip(got[1:], records):
        assert e["ts"] == round((r["ts_ns"] - base) / 1e3, 3)
    assert got[1]["ts"] == 5.0
    # without base_ns: the module epoch, as before
    plain = trace.to_chrome_trace(records, "x")["traceEvents"]
    assert plain[2]["ts"] == round(records[1]["ts"] * 1e6, 3)


# -- the program's spans and counter ------------------------------------------


@pytest.fixture(scope="module")
def bed():
    x, y = synthetic_image_classification(sum(SIZES) + 60, (8, 8, 1), 4,
                                          noise=0.3, seed=3)
    offs = np.cumsum([0] + SIZES)
    clients = [(x[offs[i]:offs[i + 1]], y[offs[i]:offs[i + 1]])
               for i in range(N)]
    task = MLPTask(input_dim=64, num_classes=4, hidden=8)
    engine = RoundEngine(task, ClientConfig(local_epochs=E, batch_size=BS),
                         device="cpu")
    sp = paper_default_params(num_devices=N, sample_count=K, local_epochs=E,
                              data_sizes=np.asarray(SIZES, np.float32),
                              device="cpu")
    hp = estimate_hyperparams(sp, 0.1, loss_scale=1.5)
    return dict(engine=engine, bank=engine.make_bank(clients), sp=sp,
                params=task.init(torch.Generator().manual_seed(0)), hp=hp,
                test=(x[offs[-1]:], y[offs[-1]:]))


def test_solver_loop_tests_count_every_read_back(bed, monkeypatch):
    calls = [0]
    above = solver._above

    def counted(value, tol):
        calls[0] += 1
        return above(value, tol)

    monkeypatch.setattr(solver, "_above", counted)
    h = np.random.default_rng(5).uniform(0.05, 0.4, (3, N)).astype(
        np.float32)
    with trace.installed(trace.MemorySink()) as sink:
        bed["engine"].run_scan(bed["params"], bed["sp"], bed["bank"], h,
                               np.full(3, 0.1, np.float32),
                               torch.Generator().manual_seed(1),
                               policy="lroa", V=bed["hp"].V,
                               lam=bed["hp"].lam)
    tot = trace.totals()
    counted_by_tracer = sum(row["counters"].get("solver.loop_tests", 0)
                            for row in tot.values())
    assert calls[0] > 3 and counted_by_tracer == calls[0]
    # every test ran inside a decide
    assert tot["scan.decide"]["counters"]["solver.loop_tests"] == calls[0]
    per_round = [r["attrs"]["solver.loop_tests"]
                 for r in sink.by_name("scan.decide")]
    assert len(per_round) == 3 and sum(per_round) == calls[0]


def test_the_arena_emits_its_spans(bed):
    bank = bed["bank"]
    assert bank.num_tiers == 2
    grid = ScenarioGrid.create(["lroa", "uni_d"], seeds=[1, 2],
                               V=bed["hp"].V, lam=bed["hp"].lam,
                               sample_count=K)
    rounds, every = 4, 2
    with trace.installed(trace.MemorySink(capacity=65536)) as sink:
        Arena(bed["engine"]).run(
            bed["params"], bed["sp"], bank, grid, rounds,
            np.full(rounds, 0.1, np.float32),
            eval_bank=EvalBank(bed["engine"].task, *bed["test"],
                               device="cpu"),
            eval_every=every, chunk_size=2)
    names = {r["name"] for r in sink.records}
    assert not names & {"engine.round_stacked", "arena.bank_digest"}
    tot = trace.totals()
    lanes = len(grid)
    for name in ("scan.decide", "scan.select", "scan.outputs"):
        recs = sink.by_name(name)
        assert len(recs) == rounds * lanes == tot[name]["calls"]
        assert {(r["attrs"]["t"], r["attrs"]["lane"]) for r in recs} == {
            (t, s) for t in range(rounds) for s in range(lanes)}
    rounds_ = sink.by_name("engine.lanes_round")
    assert [r["attrs"]["t"] for r in rounds_] == list(range(rounds))
    ids = {r["id"] for r in rounds_}
    route = sink.by_name("engine.route")
    assert len(route) == rounds
    assert all(r["parent"] in ids and r["attrs"] == {"slots": lanes * K}
               for r in route)
    tiers = sink.by_name("engine.train_tier")
    assert tiers and all(r["parent"] in ids for r in tiers)
    for r in tiers:
        rung = bank.tiers[r["attrs"]["tier"]]
        assert r["attrs"]["width"] == rung.bucket_examples
        assert r["attrs"]["steps"] == E * rung.steps_per_epoch
    by_round = {}
    for r in tiers:
        by_round.setdefault(r["parent"], 0)
        by_round[r["parent"]] += r["attrs"]["slots"]
    assert set(by_round.values()) == {lanes * K}
    evals = sink.by_name("engine.eval")
    assert [(r["attrs"]["t"], r["attrs"]["lanes"]) for r in evals] == [
        (t, lanes) for t in range(rounds) if (t + 1) % every == 0]
    # the LROA lanes' tests are counted under their decides
    assert tot["scan.decide"]["counters"]["solver.loop_tests"] > 0
    assert all("device_s" not in r["attrs"] for r in rounds_)
