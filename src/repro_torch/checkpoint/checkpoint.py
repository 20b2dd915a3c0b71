"""Dependency-free checkpointing of nested dicts of tensors or numpy
arrays (npz + json manifest): the port of ``repro.checkpoint``.

A tree is a nested dict (lists and tuples index by position) whose leaves
are ``torch.Tensor`` or numpy arrays; a ``None`` is an empty subtree, as
``jax.tree_util`` treats it: it writes no entry and restores as ``None``
where the ``like`` tree has one.  It is flattened into npz entries
keyed by the ``/``-joined path of dict keys and positions — the JAX
package's key format, so a flat dict written by either package is read by
the other's :func:`restore_arrays`.  The key list and caller metadata (the
step, the round, queue states) go into a sidecar ``<name>.json``
manifest.  Writes are atomic (tmp + rename), so an interrupted run never
leaves a corrupt latest checkpoint.

Dtypes survive the round trip: float, int (int64 included), uint and
bool leaves are written as they are; bfloat16 (which npz cannot hold) is
widened losslessly to float32 on disk and cast back by
:func:`restore_checkpoint`, which also places every tensor on the device
of the matching leaf of its ``like`` tree.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Any

_SEP = "/"


def _items(tree: Tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict / list / tuple tree, dict
    keys in sorted order (the JAX package's flattening order); ``None``
    yields nothing."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], f"{prefix}{key}{_SEP}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, f"{prefix}{i}{_SEP}")
    else:
        yield prefix[:-len(_SEP)], tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            # npz cannot serialise bfloat16; widen losslessly to f32
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fiub" or arr.dtype.itemsize == 0:
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _items(tree)}


def _rebuild(like: Tree, leaf_fn, prefix: str = ""):
    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _rebuild(like[key], leaf_fn, f"{prefix}{key}{_SEP}")
                for key in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, leaf_fn, f"{prefix}{i}{_SEP}")
                          for i, sub in enumerate(like))
    return leaf_fn(prefix[:-len(_SEP)], like)


def _write_atomic(path: str, mode: str, write) -> None:
    """``write(file)`` into a temporary file beside ``path``, then rename
    it over ``path``; the temporary file never outlives the call."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, mode) as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(directory: str, name: str, tree: Tree,
                    metadata: Optional[Dict] = None) -> str:
    """Write ``tree`` to ``<directory>/<name>.npz`` and its manifest
    (``keys``, ``metadata``) to ``<name>.json``, each atomically (the
    pair is not: a caller whose state must agree across the two keeps it
    in the npz)."""
    os.makedirs(directory, exist_ok=True)
    arrays = _flatten(tree)
    path = os.path.join(directory, f"{name}.npz")
    _write_atomic(path, "wb", lambda f: np.savez(f, **arrays))
    manifest = {"keys": sorted(arrays), "metadata": metadata or {}}
    _write_atomic(os.path.join(directory, f"{name}.json"), "w",
                  lambda f: json.dump(manifest, f, indent=1))
    return path


def _metadata(directory: str, name: str) -> Dict:
    mpath = os.path.join(directory, f"{name}.json")
    if not os.path.exists(mpath):
        return {}
    with open(mpath) as f:
        return json.load(f).get("metadata", {})


def restore_arrays(directory: str, name: str
                   ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Flat ``{key: array}`` view of a checkpoint plus its metadata, for
    consumers whose tree IS a flat dict (per-round metric columns) or
    who rebuild structure themselves: no ``like`` tree is needed."""
    with np.load(os.path.join(directory, f"{name}.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, _metadata(directory, name)


def restore_checkpoint(directory: str, name: str, like: Tree
                       ) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``like``: the key sets and every
    leaf's shape must match.  A tensor leaf of ``like`` gives a tensor of
    its dtype on its device; a numpy leaf gives an array of its dtype."""
    arrays, metadata = restore_arrays(directory, name)
    ref = dict(_items(like))
    if set(arrays) != set(ref):
        missing = set(ref) - set(arrays)
        extra = set(arrays) - set(ref)
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")

    def leaf(key, like_leaf):
        arr = arrays[key]
        if arr.shape != tuple(np.shape(like_leaf)):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(np.shape(like_leaf))}")
        if isinstance(like_leaf, torch.Tensor):
            return torch.as_tensor(arr).to(device=like_leaf.device,
                                           dtype=like_leaf.dtype)
        return arr.astype(np.asarray(like_leaf).dtype)

    return _rebuild(like, leaf), metadata


def checkpoint_exists(directory: str, name: str) -> bool:
    """Whether a complete ``save_checkpoint(directory, name, ...)`` pair
    (npz + manifest) is present."""
    return (os.path.exists(os.path.join(directory, f"{name}.npz")) and
            os.path.exists(os.path.join(directory, f"{name}.json")))


def delete_checkpoint(directory: str, name: str) -> None:
    """Remove a checkpoint's npz + manifest if present (idempotent)."""
    for suffix in (".npz", ".json"):
        path = os.path.join(directory, f"{name}{suffix}")
        if os.path.exists(path):
            os.unlink(path)


def latest_step(directory: str, prefix: str = "step_") -> Optional[int]:
    """The largest N of the ``<prefix>N.npz`` files in ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for fn in os.listdir(directory):
        if fn.startswith(prefix) and fn.endswith(".npz"):
            try:
                steps.append(int(fn[len(prefix):-4]))
            except ValueError:
                pass
    return max(steps) if steps else None
