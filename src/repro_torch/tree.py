"""Nested parameter trees: dicts, NamedTuples and tensor leaves, the
port's counterpart of ``jax.tree_util`` for what the LM and optimizer
code needs.  As in JAX, ``None`` is an empty subtree (no leaf) and a
dict's leaves come in sorted-key order."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Tree = Any
_LEAF = object()   # a leaf's place in a structure from tree_flatten


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> Iterator:
    """The leaves in ``jax.tree_util``'s order (dict keys sorted)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif _is_namedtuple(tree):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def tree_flatten(tree: Tree) -> Tuple[List, Tree]:
    """(the leaves in :func:`tree_leaves` order, a structure for
    :func:`tree_unflatten`)."""
    return list(tree_leaves(tree)), tree_map(lambda _: _LEAF, tree)


def tree_unflatten(structure: Tree, leaves) -> Tree:
    """The tree of ``structure`` (from :func:`tree_flatten`) holding
    ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if node is not _LEAF:
            raise ValueError(f"not a structure from tree_flatten: {node!r}")
        return next(it)

    out = build(structure)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out
