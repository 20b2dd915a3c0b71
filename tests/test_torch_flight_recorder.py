"""The port's flight recorder (``obs.trace.JsonlSink``, ``load_jsonl``,
``to_chrome_trace``, ``export_chrome_trace``, ``clear_sinks``,
``profiler_bridge``) against the JAX package's ``repro.obs.trace``: a
file either package writes is read by the other's ``load_jsonl`` into
the same records and turned by either ``to_chrome_trace`` into the same
events; ``_jsonable`` coerces tensors and numpy values.  Also the device
channel draws of ``ChannelProcess`` (``sample_device``,
``dropout_device``, the reference's ``sample_jax`` / ``dropout_jax``):
bitwise the scenario arena's pregenerated lane for the same key, in both
channel modes."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402


@pytest.fixture
def jtrace():
    pytest.importorskip("jax")
    from repro.obs import trace
    return trace


def _spans(trace, path, **attrs):
    """A nested span tree, an event and a numpy attribute written through
    ``trace``'s own JsonlSink."""
    with trace.installed(trace.JsonlSink(path, flush_every=1)):
        with trace.span("arena.run", lanes=4, **attrs):
            with trace.span("arena.dispatch", chunk=0, k=np.int64(3)):
                trace.event("plan.decision", buckets=2)
            with trace.span("arena.reduce", ratio=np.float32(0.5)):
                pass


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_file_reads_the_same_in_both_packages(tmp_path, jtrace, writer):
    path = str(tmp_path / "run.jsonl")
    _spans(ttrace if writer == "port" else jtrace, path)
    mine, theirs = ttrace.load_jsonl(path), jtrace.load_jsonl(path)
    assert mine == theirs
    assert [r["name"] for r in mine] == ["plan.decision", "arena.dispatch",
                                         "arena.reduce", "arena.run"]
    # the port's records carry their start on the profiler's clock too
    keys = ("attrs", "depth", "dur", "id", "name", "parent", "ts")
    if writer == "port":
        keys = tuple(sorted(keys + ("ts_ns",)))
        assert all(isinstance(r["ts_ns"], int) for r in mine)
    assert {tuple(sorted(r)) for r in mine} == {keys}
    run = mine[-1]
    assert all(r["parent"] == run["id"] for r in mine[1:3])
    assert mine[0]["parent"] == mine[1]["id"] and mine[0]["dur"] == 0.0
    assert mine[1]["attrs"] == {"chunk": 0, "k": 3}
    assert mine[2]["attrs"] == {"ratio": 0.5}
    assert ttrace.to_chrome_trace(mine, "x") == jtrace.to_chrome_trace(
        mine, "x")


def test_chrome_export_matches_the_reference(tmp_path, jtrace):
    path = str(tmp_path / "run.jsonl")
    _spans(ttrace, path)
    records = ttrace.load_jsonl(path)
    a = ttrace.export_chrome_trace(records, str(tmp_path / "a" / "t.json"),
                                   "rank0")
    b = jtrace.export_chrome_trace(records, str(tmp_path / "b" / "t.json"),
                                   "rank0")
    with open(a) as fa, open(b) as fb:
        got, want = json.load(fa), json.load(fb)
    assert got == want
    phases = [e["ph"] for e in got["traceEvents"]]
    assert phases == ["M", "i", "X", "X", "X"]


@pytest.mark.parametrize("value,want", [
    (torch.tensor(2.5), 2.5), (torch.tensor([1, 2]), [1, 2]),
    (torch.tensor([[1.5], [0.25]]), [[1.5], [0.25]]),
    (np.float32(0.5), 0.5), (np.int64(7), 7), (np.arange(3), [0, 1, 2]),
    ({"k": (np.int32(1), torch.tensor(True))}, {"k": [1, True]}),
    ("text", "text"), (None, None)])
def test_jsonable_coerces_tensors_and_numpy(value, want):
    got = ttrace.JsonlSink._jsonable(value)
    assert got == want and type(got) is type(want)
    json.dumps(got)


def test_jsonable_agrees_with_the_reference_on_numpy_scalars(jtrace):
    values = {"a": np.float32(0.25), "b": np.int64(4), "c": [np.bool_(1)],
              "d": {"e": 3}}
    assert ttrace.JsonlSink._jsonable(values) == \
        jtrace.JsonlSink._jsonable(values)


def test_tensor_attributes_reach_the_file(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with ttrace.installed(ttrace.JsonlSink(path)):
        with ttrace.span("engine.round", k=torch.tensor(8),
                         loss=torch.tensor([0.5, 0.25])):
            pass
    (rec,) = ttrace.load_jsonl(path)
    assert rec["attrs"] == {"k": 8, "loss": [0.5, 0.25]}


def test_clear_sinks_removes_every_sink():
    a, b = ttrace.MemorySink(), ttrace.MemorySink()
    ttrace.install_sink(a)
    ttrace.install_sink(b)
    ttrace.clear_sinks()
    with ttrace.span("x"):
        pass
    assert not a.records and not b.records
    assert ttrace.span("x") is ttrace.span("y")          # the no-op again


def test_profiler_bridge_mirrors_spans_as_profiler_ranges():
    from torch.profiler import ProfilerActivity, profile

    def names(bridge):
        ttrace.profiler_bridge(bridge)
        try:
            with ttrace.installed(ttrace.MemorySink()), \
                    profile(activities=[ProfilerActivity.CPU]) as prof:
                with ttrace.span("engine.round"):
                    with ttrace.span("scan.decide"):
                        torch.ones(4).sum()
        finally:
            ttrace.profiler_bridge(False)
        return {e.key for e in prof.key_averages()}

    assert {"engine.round", "scan.decide"} <= names(True)
    assert not {"engine.round", "scan.decide"} & names(False)


# -- device channel draws ---------------------------------------------------


GRID = dict(controllers=["lroa", "uni_d", "lroa"], seeds=[3, 11, 4], V=1.0,
            lam=0.1, mean_gain=[0.1, 0.2, 0.1], chan_mode=["iid", "markov",
                                                           "markov"],
            p_gb=[0.0, 0.3, 0.5], p_bg=[0.0, 0.4, 0.2], bad_gain=0.02,
            dropout=[0.2, 0.1, 0.0])


@pytest.fixture(scope="module")
def lanes():
    kw = dict(GRID)
    grid = tsim.ScenarioGrid.create(kw.pop("controllers"), kw.pop("seeds"),
                                    kw.pop("V"), kw.pop("lam"), **kw)
    engine = tfl.RoundEngine(tm.MLPTask(input_dim=4, num_classes=2),
                             tfl.ClientConfig(), device="cpu")
    arena = tsim.Arena(engine)
    keys = tsim.scenario_keys(grid)[0]
    return grid, keys, arena.sample_channels(grid, 5, 7), \
        arena.sample_dropout(grid, 5, 7)


@pytest.mark.parametrize("s", [0, 1, 2], ids=["iid", "markov", "markov2"])
def test_device_draws_are_the_arena_lane_bitwise(lanes, s):
    grid, keys, h_all, drop_all = lanes
    proc = tfl.ChannelProcess(7, grid.channel_config(s))
    assert proc.cfg.mode == grid.channel_mode_names()[s]
    h = proc.sample_device(keys[s], 5)
    assert h.shape == (5, 7) and h.dtype == torch.float32
    assert torch.equal(h, h_all[s])
    assert torch.equal(proc.sample_device(keys[s]), h_all[s][0])
    mask = proc.dropout_device(keys[s], 5)
    assert torch.equal(mask, drop_all[s])
    assert torch.all((h >= proc.cfg.min_gain) & (h <= proc.cfg.max_gain))


def test_device_draws_leave_the_host_stream_alone(lanes):
    grid, keys, _, _ = lanes
    a = tfl.ChannelProcess(7, grid.channel_config(1))
    b = tfl.ChannelProcess(7, grid.channel_config(1))
    a.sample_device(keys[1], 3)
    a.dropout_device(keys[1], 3)
    np.testing.assert_array_equal(a.sample_sequence(4), b.sample_sequence(4))
    assert not torch.equal(a.sample_device(keys[1], 3),
                           a.sample_device(keys[0], 3))
