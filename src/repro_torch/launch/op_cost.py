"""Op-count cost analysis of a PyTorch step: the port's counterpart of
``repro.launch.hlo_cost``.

The JAX package reads its costs off the optimized HLO text, multiplying
each ``while`` body by its ``known_trip_count``.  The port has no HLO, so
this module has a name of its own: :class:`OpCounter`, a
``TorchDispatchMode``, sees every aten op a step dispatches, under the
reference's rules:

* ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (and ``mv``, ``addmv``,
  ``dot``): ``2 * prod(result) * contracted``;
* ``convolution``: ``2 * prod(result) * kernel * C_in`` (per group), and
  its backward the same for each of the input and weight gradients;
* elementwise ops, reductions, fills and ``arange``: 1 flop per result
  element; transcendentals (``exp``, ``log``, ``tanh``, ``rsqrt``,
  ``sqrt``, ``pow``, ``sigmoid``, ``sin``, ``cos``, ``erf``, ... as
  ``hlo_cost._TRANSCENDENTAL``) also count 1 each;
* bytes: operand bytes plus result bytes; views and allocations move
  none; a gather-like read (``index_select``, ``gather``, ``index``,
  ``embedding``) twice its result and a scatter-like write twice its
  update, as the reference costs slices and scatters.

Eager dispatch sees every iteration of every Python loop (microbatches,
layers, flash backward blocks, SSD chunks), the counterpart of the
trip-count multiplier, and the recompute of ``torch.utils.checkpoint``
once per microbatch, as the reference's remat.

On ``meta`` a loop's repeated trips of one shape (the flash backward's
blocks, flash decode's cache blocks) are counted once and added again
(:func:`trip`): the same numbers, without dispatching ops that compute
nothing.

A dispatch mode cannot see a ctypes launch, so every kernel wrapper
(``kernels.ops``) reports its own work to the active counter through
:func:`kernel`, by the formulas PERF.md's kernel table uses, and keeps
the aten ops of a plain version run in its place out of the count: the
count is the same on ``cuda``, ``cpu`` and ``meta``.  On ``meta`` the
wrappers return empty outputs of the kernel's shapes, only while a
counter is active.  The collectives of ``launch.mesh`` record a
``roofline.CollectiveOp`` (:func:`record_collective`).

:meth:`OpCounter.analyze` returns the reference's keys (``flops``,
``bytes``, ``transcendentals``, ``collective_*``);
:meth:`OpCounter.analyze_by_opcode` the same rows by aten op, each
kernel as ``kernel:<name>``.  This is an estimate of the same kind as
the reference's: matmul and convolution flops are exact, and eager
PyTorch really moves the bytes counted for each unfused op.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.roofline import CollectiveOp, collective_op

__all__ = ["OpCounter", "active", "kernel", "trip", "record_collective",
           "count"]

# -- op classes (aten overload packet names, in-place ``_`` stripped) ------

_MATMUL = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
           "addmv": 1, "addbmm": 1}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum",
    "where", "clamp", "clamp_min", "clamp_max", "eq", "ne", "lt", "le",
    "gt", "ge", "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "sign",
    "floor", "ceil", "round", "trunc", "remainder", "fmod", "reciprocal",
    "square", "masked_fill", "lerp", "addcmul", "addcdiv", "relu",
    "threshold_backward", "cumsum", "cumprod", "fill", "zero", "zeros",
    "ones", "full", "zeros_like", "ones_like", "full_like", "arange",
    "scalar_tensor", "isnan", "isinf", "nan_to_num", "hardtanh"}
_TRANSCENDENTAL = {
    "exp", "exp2", "log", "log2", "log1p", "expm1", "tanh", "rsqrt",
    "sqrt", "pow", "sigmoid", "sin", "cos", "erf", "atan2", "gelu",
    "silu", "softplus", "_softmax", "_log_softmax", "tanh_backward",
    "sigmoid_backward", "silu_backward", "gelu_backward",
    "_softmax_backward_data", "_log_softmax_backward_data"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
           "all", "var", "std", "norm", "linalg_vector_norm", "argmax",
           "argmin", "logsumexp", "var_mean", "std_mean"}
_NO_BYTES = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "as_strided",
    "expand", "permute", "transpose", "t", "select", "slice", "unsqueeze",
    "squeeze", "alias", "detach", "unbind", "split", "split_with_sizes",
    "chunk", "narrow", "diagonal", "unfold", "view_as_real",
    "view_as_complex", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "lift_fresh", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "is_same_size", "set",
    "resize", "_has_compatible_shallow_copy_type", "_to_dense", "conj",
    "resolve_conj", "resolve_neg", "expand_as", "view_as", "movedim",
    "flatten", "unflatten", "_unsafe_index_put"}
#: reads only their result's elements
_GATHER = {"index_select", "gather", "index", "embedding", "take",
           "masked_select"}
#: write an update window in place: operand index of the update
_SCATTER = {"index_put": 2, "scatter": 3, "scatter_add": 3,
            "index_add": 3, "index_copy": 3, "slice_scatter": 1,
            "select_scatter": 1, "masked_scatter": 2,
            "embedding_dense_backward": 0}

_ACTIVE: List["OpCounter"] = []


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    return name


def _cost(name: str, args, kwargs, out) -> Tuple[float, float, float]:
    """``(flops, bytes, transcendentals)`` of one aten op."""
    if name in _NO_BYTES:
        return 0.0, 0.0, 0.0
    res_elems, res_bytes = _numel(out), _nbytes(out)
    operands = _nbytes(args) + _nbytes(kwargs)
    if name in _MATMUL:
        lhs = args[_MATMUL[name]]
        return 2.0 * res_elems * int(lhs.shape[-1]), operands + res_bytes, 0.0
    if name == "convolution":
        weight = args[1]
        return (2.0 * res_elems * _prod(weight.shape[1:]),
                operands + res_bytes, 0.0)
    if name == "convolution_backward":
        grad_out, weight, mask = args[0], args[2], args[-1]
        per = 2.0 * grad_out.numel() * _prod(weight.shape[1:])
        return per * (int(mask[0]) + int(mask[1])), operands + res_bytes, 0.0
    if name in _TRANSCENDENTAL:
        return float(res_elems), operands + res_bytes, float(res_elems)
    if name in _ELEMENTWISE or name in _REDUCE:
        return float(res_elems), operands + res_bytes, 0.0
    if name in _GATHER:
        return 0.0, 2.0 * res_bytes, 0.0
    if name in _SCATTER:
        return 0.0, 2.0 * _nbytes(args[_SCATTER[name]]), 0.0
    # data movement (copy, cast, cat, clone, pad, random fills, ...)
    return 0.0, operands + res_bytes, 0.0


class OpCounter(TorchDispatchMode):
    """Counts the work of everything dispatched while it is entered (see
    the module docstring).  ``rows[op] = [flops, bytes,
    transcendentals]``, ``kernels[name] = {"calls", "flops", "bytes",
    "transcendentals"}``, ``collectives``: the recorded
    :class:`~repro_torch.launch.roofline.CollectiveOp` s."""

    def __init__(self):
        super().__init__()
        self.rows: Dict[str, List[float]] = defaultdict(
            lambda: [0.0, 0.0, 0.0])
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives: List[CollectiveOp] = []
        self._paused = 0
        # trip key -> the rows its first trip added (:func:`trip`)
        self._trips: Dict[object, Dict[str, List[float]]] = {}

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            name = _op_name(func)
            row = self.rows[name]
            for i, v in enumerate(_cost(name, args, kwargs, out)):
                row[i] += v
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float,
                   transcendentals: float = 0.0) -> None:
        """One launch of kernel ``name`` doing this work."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0,
                                           "transcendentals": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)
        k["transcendentals"] += float(transcendentals)
        row = self.rows["kernel:" + name]
        row[0] += float(flops)
        row[1] += float(nbytes)
        row[2] += float(transcendentals)

    def analyze(self) -> Dict:
        """The totals in ``hlo_cost.analyze``'s keys."""
        out = {"flops": 0.0, "bytes": 0.0, "transcendentals": 0.0,
               "collective_operand_bytes": 0.0,
               "collective_traffic_bytes": 0.0, "collective_counts": {},
               "collective_bytes_by_kind": {}}
        for flops, nbytes, trans in self.rows.values():
            out["flops"] += flops
            out["bytes"] += nbytes
            out["transcendentals"] += trans
        for op in self.collectives:
            out["collective_operand_bytes"] += op.operand_bytes
            out["collective_traffic_bytes"] += op.ici_traffic_bytes
            counts, by_kind = (out["collective_counts"],
                               out["collective_bytes_by_kind"])
            counts[op.kind] = counts.get(op.kind, 0) + 1
            by_kind[op.kind] = by_kind.get(op.kind, 0) + op.operand_bytes
        return out

    def analyze_by_opcode(self, top: int = 15
                          ) -> List[Tuple[str, float, float]]:
        """``(op, flops, bytes)`` rows, largest first by the reference's
        order (``max(flops / 1e12, bytes / 1e9)``); ``top=None`` keeps
        them all."""
        rows = sorted(((k, v[0], v[1]) for k, v in self.rows.items()),
                      key=lambda r: -max(r[1] / 1e12, r[2] / 1e9))
        return rows if top is None else rows[:top]


def active() -> Optional[OpCounter]:
    """The innermost entered :class:`OpCounter`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel(name: str, device, work):
    """The region of one kernel wrapper's call on ``device``.  Under an
    active counter the aten ops inside (a plain version run in the
    kernel's place) are not counted, and ``work()`` — the kernel's
    ``(flops, bytes, transcendentals)`` by formula — is, once the region
    ends without error.  Without a counter it is a no-op context (cheap
    enough for every launch of a serving loop; ``work`` is not called),
    but a ``meta`` device raises: a wrapper returns empty outputs on
    ``meta`` only to be counted."""
    if _ACTIVE:
        return _counted_kernel(_ACTIVE[-1], name, work)
    if device.type == "meta":
        raise RuntimeError(
            f"the {name} wrapper returns empty outputs on the meta device "
            f"only under an active launch.op_cost.OpCounter")
    return contextlib.nullcontext()


@contextlib.contextmanager
def _counted_kernel(counter: "OpCounter", name: str, work):
    counter._paused += 1
    try:
        yield
    finally:
        counter._paused -= 1
    counter.add_kernel(name, *work())


def trip(key, device):
    """One trip of a loop whose trips with the same ``key`` dispatch the
    same ops on the same shapes (a flash block of one shape), as a
    context that yields True when the trip may be skipped: on ``meta``
    under an active counter a repeated key adds the first trip's counts
    again, which is what running it would add (a meta tensor holds no
    values for the trip to change).  Elsewhere it yields False (a no-op
    context, cheap enough for a serving loop) and the trip runs."""
    if not _ACTIVE or device.type != "meta":
        return contextlib.nullcontext(False)
    return _meta_trip(_ACTIVE[-1], key)


@contextlib.contextmanager
def _meta_trip(counter: "OpCounter", key):
    hit = counter._trips.get(key)
    if hit is not None:
        for name, vals in hit.items():
            row = counter.rows[name]
            for i, v in enumerate(vals):
                row[i] += v
        yield True
        return
    before = {name: list(v) for name, v in counter.rows.items()}
    yield False
    counter._trips[key] = {
        name: [v - w for v, w in zip(vals, before.get(name, (0.0,) * 3))]
        for name, vals in counter.rows.items()}


def record_collective(kind: str, result_bytes: int, group_size: int
                      ) -> None:
    """Record one collective of ``kind`` (``all-reduce``, ``all-gather``,
    ``all-to-all``) with the reference's ring formulas, if a counter is
    active."""
    counter = active()
    if counter is not None:
        counter.collectives.append(
            collective_op(kind, int(result_bytes), int(group_size)))


def count(fn, *args, **kwargs) -> Tuple[object, OpCounter]:
    """``(fn(*args, **kwargs), the counter that counted it)``."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter
