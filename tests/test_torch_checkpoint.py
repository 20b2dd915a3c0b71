"""The port's checkpoints (``repro_torch.checkpoint``) and chunk store
(``repro_torch.sim.NpzChunkStore``), mirroring the store tests of
``tests/test_obs.py`` and ``tests/test_streaming.py``: nested dicts of
tensors and arrays round-trip with their dtypes (int64, uint8, bool,
bfloat16 widened to float32 on disk) onto the ``like`` tree's device;
the file format is the JAX package's, so a flat dict written by either
package is read by the other's ``restore_arrays`` (and a nested tree
written by the JAX package restores into a port ``like`` tree); a
``None`` is an empty subtree in both packages, so trees with ``None``
parts round-trip in the port and each package reads the other's file;
the store trims metrics that run ahead of the carry, resumes at the round
the carry records when a kill left its manifest a save behind, refuses
metrics behind the carry and a schema mismatch, records its provenance
and shares the arena's registry."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.checkpoint as jck  # noqa: E402
import repro_torch.checkpoint as tck  # noqa: E402
import repro_torch.fl as tfl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.sim as tsim  # noqa: E402
from repro_torch.sim import service as service_mod  # noqa: E402


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "params": {"w": torch.randn(3, 4, generator=g),
                   "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "queues": torch.rand(2, 5, generator=g),
        "steps": torch.arange(6, dtype=torch.int64).reshape(2, 3) * 2 ** 40,
        "codes": torch.randint(0, 256, (7,), generator=g,
                               dtype=torch.uint8),
        "alive": torch.tensor([True, False, True]),
        "host": np.arange(4, dtype=np.int32),
        "pair": [torch.ones(2), np.zeros(3, np.float64)],
    }


def _like(tree):
    def empty(v):
        if isinstance(v, torch.Tensor):
            return torch.empty_like(v)
        return np.empty_like(v)
    return {k: ({n: empty(x) for n, x in v.items()} if isinstance(v, dict)
                else [empty(x) for x in v] if isinstance(v, list)
                else empty(v)) for k, v in tree.items()}


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype and got.device == want.device
        assert torch.equal(got, want)
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_nested_tree_round_trips_with_dtypes(tmp_path):
    tree = _tree()
    path = tck.save_checkpoint(str(tmp_path), "step_3", tree,
                               metadata={"t": 3, "note": "x"})
    assert path.endswith("step_3.npz") and tck.checkpoint_exists(
        str(tmp_path), "step_3")
    assert sorted(os.listdir(tmp_path)) == ["step_3.json", "step_3.npz"]
    with open(tmp_path / "step_3.json") as f:
        manifest = json.load(f)
    assert manifest["keys"] == sorted(
        ["params/w", "params/b", "queues", "steps", "codes", "alive",
         "host", "pair/0", "pair/1"])
    assert manifest["metadata"] == {"t": 3, "note": "x"}
    got, md = tck.restore_checkpoint(str(tmp_path), "step_3", _like(tree))
    assert md == {"t": 3, "note": "x"}
    _assert_same(got, tree)
    flat, _ = tck.restore_arrays(str(tmp_path), "step_3")
    assert flat["params/b"].dtype == np.float32        # bf16 widened
    assert flat["steps"].dtype == np.int64 and flat["codes"].dtype == np.uint8


def test_restore_checks_keys_and_shapes(tmp_path):
    tree = {"a": torch.zeros(2, 3), "b": torch.zeros(4)}
    tck.save_checkpoint(str(tmp_path), "c", tree)
    with pytest.raises(ValueError, match="missing=\\['c'\\]"):
        tck.restore_checkpoint(str(tmp_path), "c",
                               {**tree, "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        tck.restore_checkpoint(str(tmp_path), "c",
                               {"a": torch.zeros(3, 2), "b": torch.zeros(4)})


def test_exists_delete_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert tck.latest_step(str(tmp_path / "none")) is None
    for step in (2, 10, 7):
        tck.save_checkpoint(d, f"step_{step}", {"x": np.zeros(1)})
    tck.save_checkpoint(d, "step_last", {"x": np.zeros(1)})
    assert tck.latest_step(d) == 10
    tck.delete_checkpoint(d, "step_10")
    tck.delete_checkpoint(d, "step_10")                # idempotent
    assert not tck.checkpoint_exists(d, "step_10")
    assert tck.latest_step(d) == 7
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


FLAT = {"loss": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3),
        "selected": np.arange(8, dtype=np.int64).reshape(2, 4) - 1,
        "codes": np.arange(5, dtype=np.uint8)}


@pytest.mark.parametrize("writer,reader", [(jck, tck), (tck, jck)],
                         ids=["jax_writes", "port_writes"])
def test_flat_dict_crosses_packages(tmp_path, writer, reader):
    writer.save_checkpoint(str(tmp_path), "cols", FLAT,
                           metadata={"t": 3, "s": 2})
    assert reader.checkpoint_exists(str(tmp_path), "cols")
    got, md = reader.restore_arrays(str(tmp_path), "cols")
    assert md == {"t": 3, "s": 2} and sorted(got) == sorted(FLAT)
    for k, v in FLAT.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_jax_nested_tree_restores_into_a_port_like_tree(tmp_path):
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": np.ones(3, np.float32)},
            "queues": np.full((2, 4), 0.5, np.float32)}
    jck.save_checkpoint(str(tmp_path), "carry", tree, metadata={"t": 2})
    like = {"params": {"w": torch.empty(2, 3), "b": torch.empty(3)},
            "queues": torch.empty(2, 4)}
    got, md = tck.restore_checkpoint(str(tmp_path), "carry", like)
    assert md == {"t": 2}
    for name in ("w", "b"):
        np.testing.assert_array_equal(got["params"][name].numpy(),
                                      tree["params"][name])
    np.testing.assert_array_equal(got["queues"].numpy(), tree["queues"])


# -- None is an empty subtree, in both packages ----------------------------

def _none_trees():
    """(name, numpy tree) pairs with ``None`` parts: a flat dict, and an
    optimizer-like state whose second moment and one list slot are off."""
    return [
        ("flat", {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "b": None}),
        ("optimizer", {
            # int32: JAX without x64 restores an int64 leaf as int32
            "step": np.asarray(7, np.int32),
            "mu": {"w": np.linspace(-1, 1, 12, dtype=np.float32)
                   .reshape(3, 4), "b": np.ones(4, np.float32)},
            "nu": None,
            "extra": [np.arange(3, dtype=np.int32), None],
            "opt": {"clip": None, "count": np.zeros(2, np.int32)}}),
    ]


def _to_port(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_port(v) for v in tree]
    return torch.as_tensor(tree)


def _numpy_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _assert_none_tree(got, want):
    if want is None:
        assert got is None
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_none_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_none_tree(a, b)
    else:
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [0, 1], ids=["flat", "optimizer"])
def test_none_leaf_round_trips_in_the_port(tmp_path, case):
    _, tree = _none_trees()[case]
    tck.save_checkpoint(str(tmp_path), "s", _to_port(tree))
    keys, _ = tck.restore_arrays(str(tmp_path), "s")
    assert not any(k == "b" or k.startswith(("nu", "opt/clip", "extra/1"))
                   for k in keys)
    got, _ = tck.restore_checkpoint(str(tmp_path), "s", _to_port(tree))
    _assert_none_tree(got, tree)


@pytest.mark.parametrize("case", [0, 1], ids=["flat", "optimizer"])
@pytest.mark.parametrize("direction", ["jax_reads_port", "port_reads_jax"])
def test_none_leaf_crosses_packages(tmp_path, case, direction):
    _, tree = _none_trees()[case]
    if direction == "jax_reads_port":
        tck.save_checkpoint(str(tmp_path), "s", _to_port(tree))
        got, _ = jck.restore_checkpoint(str(tmp_path), "s", tree)
        got = _numpy_tree(got)
    else:
        jck.save_checkpoint(str(tmp_path), "s", tree)
        got, _ = tck.restore_checkpoint(str(tmp_path), "s", _to_port(tree))
    _assert_none_tree(got, tree)
    w_keys = sorted(jck.restore_arrays(str(tmp_path), "s")[0])
    assert w_keys == sorted(tck.restore_arrays(str(tmp_path), "s")[0])


# -- the chunk store ----------------------------------------------------------


def _store(tmp_path, **kw):
    def carry_like(s):
        return {"params": {"w": torch.empty(s, 2)},
                "queues": torch.empty(s, 3),
                "last_ev": {"accuracy": torch.empty(s)}}
    return tsim.NpzChunkStore(str(tmp_path), carry_like, **kw)


def _carry():
    return {"params": {"w": np.arange(4, dtype=np.float32).reshape(2, 2)},
            "queues": np.ones((2, 3), np.float32),
            "last_ev": {"accuracy": np.asarray([0.25, 0.5], np.float32)}}


def test_store_trims_metrics_ahead_of_carry(tmp_path):
    """A crash between the metrics save and the carry save leaves the
    metrics a checkpoint ahead: load trims them to the carry's round."""
    store = _store(tmp_path)
    carry = _carry()
    store.save("chunk_x", 4, carry,
               {"loss": np.arange(8, dtype=np.float32).reshape(2, 4),
                "selected": np.zeros((2, 4, 3), np.int64)})
    tck.save_checkpoint(str(tmp_path), "chunk_x_metrics",
                        {"loss": np.zeros((2, 6), np.float32),
                         "selected": np.ones((2, 6, 3), np.int64)},
                        metadata={"t": 6, "s": 2})
    t, got, metrics = store.load("chunk_x")
    assert t == 4 and store.loads == 1
    assert metrics["loss"].shape == (2, 4)
    assert metrics["selected"].shape == (2, 4, 3)
    for name in ("queues",):
        np.testing.assert_array_equal(got[name].numpy(), carry[name])
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  carry["params"]["w"])
    np.testing.assert_array_equal(got["last_ev"]["accuracy"].numpy(),
                                  carry["last_ev"]["accuracy"])
    store.finish("chunk_x")
    assert store.load("chunk_x") is None and os.listdir(tmp_path) == []


def test_store_resumes_at_the_carrys_own_round(tmp_path, monkeypatch):
    """A kill between the carry's npz and its manifest at a second save
    leaves round 4's carry under round 2's manifest: load resumes at the
    round the carry records, with round 4's carry and four columns."""
    store = _store(tmp_path)
    store.save("chunk_x", 2, _carry(),
               {"loss": np.zeros((2, 2), np.float32)})
    newer = _carry()
    newer["queues"] = newer["queues"] + 1.0
    real = os.replace

    def replace(src, dst):
        if str(dst).endswith("chunk_x_carry.json"):
            raise KeyboardInterrupt
        return real(src, dst)

    with monkeypatch.context() as m:
        m.setattr(os, "replace", replace)
        with pytest.raises(KeyboardInterrupt):
            store.save("chunk_x", 4, newer,
                       {"loss": np.ones((2, 4), np.float32)})
    with open(tmp_path / "chunk_x_carry.json") as f:
        assert json.load(f)["metadata"]["t"] == 2
    assert sorted(os.listdir(tmp_path)) == [
        "chunk_x_carry.json", "chunk_x_carry.npz", "chunk_x_metrics.json",
        "chunk_x_metrics.npz"]
    t, got, metrics = store.load("chunk_x")
    assert t == 4 and "t" not in got
    np.testing.assert_array_equal(got["queues"].numpy(), newer["queues"])
    np.testing.assert_array_equal(metrics["loss"], np.ones((2, 4)))


def test_store_refuses_metrics_behind_the_carry(tmp_path):
    store = _store(tmp_path)
    store.save("chunk_x", 4, _carry(),
               {"loss": np.zeros((2, 4), np.float32)})
    tck.save_checkpoint(str(tmp_path), "chunk_x_metrics",
                        {"loss": np.zeros((2, 2), np.float32)},
                        metadata={"t": 2, "s": 2})
    with pytest.raises(ValueError, match="refusing to resume"):
        store.load("chunk_x")
    assert store.loads == 0


def test_store_manifest_records_schema_and_provenance(tmp_path):
    store = _store(tmp_path, every=3)
    assert store.every == 3
    store.save("tag1", 4, _carry(), {"loss": np.zeros((2, 4), np.float32)})
    assert store.saves == 1
    with open(tmp_path / "tag1_carry.json") as f:
        md = json.load(f)["metadata"]
    assert md["schema_version"] == service_mod.CHUNK_STORE_SCHEMA_VERSION
    assert tsim.CHUNK_STORE_SCHEMA_VERSION == md["schema_version"]
    assert md["t"] == 4 and md["s"] == 2
    assert md["host"] and md["torch_version"] == torch.__version__
    assert md["grid_digest"] == "tag1" and md["saved_at"].endswith("Z")
    assert "jax_version" not in md


def test_store_refuses_resume_on_schema_mismatch(tmp_path):
    store = _store(tmp_path)
    store.save("tag1", 4, _carry(), {"loss": np.zeros((2, 4), np.float32)})
    mpath = tmp_path / "tag1_carry.json"
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["metadata"]["schema_version"] = 0
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="schema_version 0"):
        store.load("tag1")
    # no version field at all (a file from before the field) is version 0
    del manifest["metadata"]["schema_version"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="refuses to resume"):
        store.load("tag1")
    assert store.loads == 0


def test_store_counters_share_the_arena_registry(tmp_path):
    task = tm.MLPTask(input_dim=4, num_classes=2, hidden=2)
    eng = tfl.RoundEngine(task, tfl.ClientConfig(), device="cpu")
    arena = tsim.Arena(eng)
    svc = tsim.SweepService(arena, task.init(torch.Generator()), None, None,
                            checkpoint_dir=str(tmp_path))
    assert svc.store.metrics is arena.metrics and svc.metrics is arena.metrics
    svc.store.save("t", 2, _carry(), {"loss": np.zeros((2, 2), np.float32)})
    assert arena.metrics.get("store.saves") == 1
    standalone = _store(tmp_path / "solo")
    assert standalone.metrics is not arena.metrics
    assert standalone.saves == 0
