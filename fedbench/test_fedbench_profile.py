"""The trace reduction's interval arithmetic: unions, containment and the
host span a device gap falls in."""

import numpy as np

from fedbench.harness import profile


def _loop_union(starts, durs):
    out = []
    for s, e in sorted(zip(starts, np.asarray(starts) + durs)):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.int64).reshape(-1, 2)


def test_union_merges_overlaps_and_keeps_gaps():
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 10_000, 500)
    durs = rng.integers(1, 40, 500)
    assert np.array_equal(profile.union(starts, durs),
                          _loop_union(starts, durs))
    got = profile.union(np.asarray([0, 5, 20]), np.asarray([10, 2, 5]))
    assert got.tolist() == [[0, 10], [20, 25]]
    assert profile.union(np.asarray([]), np.asarray([])).shape == (0, 2)


def test_within_sorted_ranges():
    ranges = np.asarray([[10, 20], [30, 40]])
    pts = np.asarray([5, 10, 15, 20, 25, 35, 41])
    assert profile.within(pts, ranges).tolist() == [
        False, True, True, True, False, True, False]


def test_innermost_span_of_nested_ranges():
    d = profile.Digest(
        window_ns=(0, 100), dev_name=[], dev_start=np.zeros(0, np.int64),
        dev_dur=np.zeros(0, np.int64), dev_launch=np.zeros(0, np.int64),
        spans={},
        host_ranges=np.asarray([[0, 50], [10, 20], [30, 40], [60, 70]]),
        host_names=["arena.dispatch", "scan.decide", "engine.lanes_round",
                    "arena.reduce"],
        rt_name=[], rt_start=np.zeros(0, np.int64),
        rt_dur=np.zeros(0, np.int64), stats={})
    got = profile.innermost_spans(d, [5, 15, 25, 35, 55, 65, 90])
    assert got == ["arena.dispatch", "scan.decide", "arena.dispatch",
                   "engine.lanes_round", "outside spans", "arena.reduce",
                   "outside spans"]
