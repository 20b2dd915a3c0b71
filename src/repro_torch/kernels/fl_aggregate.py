"""Python binding of the hand-written CUDA eq.-(4) kernel
(``csrc/fl_aggregate.cu``), the port of the Pallas TPU kernel
``repro.kernels.fl_aggregate.fl_aggregate_tpu``.

``fl_aggregate_leaves_cuda(thetas, deltas, coeffs)`` computes, for every
leaf, ``thetas[i] + sum_k coeffs[k] * deltas[i][k]`` in one launch over the
leaves where they lie (one launch per table of at most
``fl_aggregate_max_segments()`` leaves of one dtype combination).
``fl_aggregate_lanes_cuda(thetas, deltas, coeffs)`` is the scenario
arena's form: S lanes of one model (``[S, ...]`` thetas, ``[S, K, ...]``
deltas, ``[S, K]`` coeffs), every (lane, leaf) a segment of the same
table on its lane's coefficient row, so all lanes' eq.-(4) step is one
launch per table; lane s of it is bitwise the one-lane call on lane s's
tensors.
``fl_aggregate_cuda(theta, deltas, coeffs)`` and ``fl_delta_reduce_cuda(
deltas, coeffs)`` (the theta-less partial, f32 out) are its one-leaf case
on a flat ``[N]`` / ``[K, N]`` model; ``fl_delta_reduce_leaves_cuda(
deltas, coeffs, outs)`` is the theta-less partial over a leaf table,
written into given f32 views (a rank's term of the client-sharded
round, ``fl.server.aggregate_fused_psum``).  All take CUDA tensors only: they
validate devices, dtypes, shapes and contiguity, refuse inputs that
require grad under grad mode (the kernel has no backward;
``_build.refuse_grad``), allocate the outputs with ``torch.empty``,
build the segment table on the host
(:func:`plan_segments`), launch on the current stream without
synchronising, and raise on any launch error.  Each launch adds one to
:data:`LAUNCHES`, so a run can show that its main path went through the
kernel.

The plain PyTorch versions of the same functions are
:func:`repro_torch.kernels.ref.aggregate_leaves_reference`,
:func:`~repro_torch.kernels.ref.aggregate_reference` and
:func:`~repro_torch.kernels.ref.delta_reduce_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NO_THETA = -1

#: launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fl_aggregate": 0, "fl_delta_reduce": 0,
                            "fl_aggregate_lanes": 0}

#: one row of a launch's table: (leaf index, elements per vector, tiles of
#: this and every earlier row of the table)
Row = Tuple[int, int, int]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def vector_width(size: int, k: int, pointers: Sequence[Tuple[int, int]]
                 ) -> int:
    """The widest vector, in elements, that one leaf streams with: at most
    16 bytes of its widest type, every pointer (``(address, itemsize)`` of
    its theta if any, its deltas and its output) aligned to the vector,
    and with K > 1 every delta row start too (``size`` a multiple)."""
    vec = 16 // max(itemsize for _, itemsize in pointers)
    while vec > 1 and (k > 1 and size % vec or
                       any(addr % (vec * itemsize)
                           for addr, itemsize in pointers)):
        vec //= 2
    return vec


def plan_segments(sizes: Sequence[int], k: int,
                  pointers: Sequence[Sequence[Tuple[int, int]]],
                  kinds: Sequence[Hashable], tile_vectors: int, cap: int
                  ) -> List[Tuple[Hashable, List[Row]]]:
    """The segment tables of one call: the leaves (``sizes[i] >= 1``
    elements, ``pointers[i]`` as in :func:`vector_width`) grouped by dtype
    combination (``kinds[i]``) in order of first appearance, each group
    cut into tables of at most ``cap`` leaves.  A leaf of ``n_vec = size //
    vec`` full vectors takes ``max(1, ceil(n_vec / tile_vectors))`` tiles;
    its last tile also covers the ``size % vec`` scalar tail.  Returns one
    ``(kind, rows)`` per launch."""
    groups: Dict[Hashable, List[int]] = {}
    for i, kind in enumerate(kinds):
        groups.setdefault(kind, []).append(i)
    launches = []
    for kind, leaves in groups.items():
        for start in range(0, len(leaves), cap):
            rows, end = [], 0
            for i in leaves[start:start + cap]:
                vec = vector_width(sizes[i], k, pointers[i])
                end += max(1, -(-(sizes[i] // vec) // tile_vectors))
                rows.append((i, vec, end))
            launches.append((kind, rows))
    return launches


_LIB: list = []


def _library() -> ctypes.CDLL:
    """The built library with every exported signature declared
    (pointers and the stream as ``c_void_p``, so ctypes never truncates
    them)."""
    if not _LIB:
        lib = _build.load_library("fl_aggregate")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fl_aggregate_segments_launch.argtypes = [vp, i32, vp, i32, i32,
                                                     i32, i32, vp]
        lib.fl_aggregate_segments_launch.restype = i32
        for name in ("fl_aggregate_max_k", "fl_aggregate_max_segments",
                     "fl_aggregate_tile_vectors"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i32
        lib.fl_aggregate_error_string.argtypes = [i32]
        lib.fl_aggregate_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check_tensor(t: torch.Tensor, name: str, device: int) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} dtype {t.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if t.get_device() != device:
        raise ValueError(f"all inputs must share one device: {name} lies "
                         f"on {t.device}, coeffs on cuda:{device}")


def _check_leaves(thetas: Sequence[torch.Tensor] | None,
                  deltas: Sequence[torch.Tensor], coeffs: torch.Tensor,
                  lib: ctypes.CDLL) -> None:
    if thetas is not None and len(thetas) != len(deltas):
        raise ValueError(f"{len(thetas)} thetas against {len(deltas)} "
                         f"deltas")
    if not deltas:
        raise ValueError("no leaves")
    if not coeffs.is_cuda:
        raise ValueError(f"coeffs must be a CUDA tensor, got device "
                         f"{coeffs.device}")
    device = coeffs.get_device()
    k = deltas[0].shape[0] if deltas[0].dim() else 0
    if not 1 <= k <= lib.fl_aggregate_max_k():
        raise ValueError(f"K must lie in [1, {lib.fl_aggregate_max_k()}], "
                         f"got {k}")
    if (coeffs.shape != (k,) or coeffs.dtype != torch.float32
            or not coeffs.is_contiguous()):
        raise ValueError(f"coeffs must be contiguous float32 [{k}], got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    for i, d in enumerate(deltas):
        _check_tensor(d, f"leaf {i} deltas", device)
        if thetas is None:
            if d.dim() < 1 or d.shape[0] != k:
                raise ValueError(f"leaf {i}: deltas must be (K,) + the "
                                 f"leaf's shape with K = {k}, got "
                                 f"{tuple(d.shape)}")
            continue
        theta = thetas[i]
        _check_tensor(theta, f"leaf {i} theta", device)
        if d.shape != (k,) + theta.shape:
            raise ValueError(f"leaf {i}: deltas must be (K,) + theta's "
                             f"shape = {(k,) + tuple(theta.shape)}, got "
                             f"{tuple(d.shape)}")


def _raise_on(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code != 0:
        text = lib.fl_aggregate_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {text} "
                           f"(cudaError {code})")


#: one segment of a launch: (theta or None, deltas ``(K,) + shape``, out,
#: coefficient row)
Seg = Tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, int]


def _launch_segments(segs: Sequence[Seg], coeffs: torch.Tensor,
                     counter: str) -> None:
    """Plan the tables of ``segs`` (empty ones skipped) and launch each
    on the current stream, ``coeffs`` a contiguous f32 ``[R, K]`` (or
    ``[K]``, R = 1) table the segments' rows index."""
    _build.refuse_grad(counter, coeffs, *(t for seg in segs
                                          for t in seg[:2]))
    lib = _library()
    k = int(coeffs.shape[-1])
    coeff_rows = int(coeffs.shape[0]) if coeffs.dim() == 2 else 1
    live = [seg for seg in segs if seg[2].numel()]
    if not live:
        return
    sizes, pointers, kinds = [], [], []
    for theta, d, out, _ in live:
        ptrs = [(d.data_ptr(), d.element_size()),
                (out.data_ptr(), out.element_size())]
        theta_dtype = _NO_THETA
        if theta is not None:
            ptrs.append((theta.data_ptr(), theta.element_size()))
            theta_dtype = _DTYPE_CODES[theta.dtype]
        sizes.append(out.numel())
        pointers.append(ptrs)
        kinds.append((theta_dtype, _DTYPE_CODES[d.dtype]))
    plan = plan_segments(sizes, k, pointers, kinds,
                         lib.fl_aggregate_tile_vectors(),
                         lib.fl_aggregate_max_segments())
    device = coeffs.device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for (theta_dtype, delta_dtype), rows in plan:
            table = np.array(
                [(pointers[j][2][0] if theta_dtype != _NO_THETA else 0,
                  pointers[j][0][0], pointers[j][1][0], sizes[j], vec, end,
                  live[j][3])
                 for j, vec, end in rows], dtype=np.int64)
            code = lib.fl_aggregate_segments_launch(
                table.ctypes.data, len(rows), coeffs.data_ptr(), coeff_rows,
                k, theta_dtype, delta_dtype, stream)
            _raise_on(code, lib, counter)
            LAUNCHES[counter] += 1


def _launch_leaves(thetas: Sequence[torch.Tensor] | None,
                   deltas: Sequence[torch.Tensor], coeffs: torch.Tensor,
                   counter: str, outs: Sequence[torch.Tensor] | None = None
                   ) -> List[torch.Tensor]:
    """Validate, allocate the outputs (or take the given ones: f32, the
    reduce only), plan the tables and launch each."""
    _check_leaves(thetas, deltas, coeffs, _library())
    device = deltas[0].device
    if outs is not None:
        outs = list(outs)
        if thetas is not None or len(outs) != len(deltas):
            raise ValueError("given outputs are the reduce's: one f32 "
                             "tensor per leaf, no thetas")
        for i, (d, out) in enumerate(zip(deltas, outs)):
            if (out.dtype != torch.float32 or out.shape != d.shape[1:]
                    or not out.is_contiguous()):
                raise ValueError(f"leaf {i}: out must be contiguous "
                                 f"float32 {tuple(d.shape[1:])}, got "
                                 f"{out.dtype} {tuple(out.shape)}")
            _check_tensor(out, f"leaf {i} out", coeffs.get_device())
    elif thetas is None:
        outs = [torch.empty(d.shape[1:], dtype=torch.float32, device=device)
                for d in deltas]
    else:
        outs = [torch.empty_like(t) for t in thetas]
    _launch_segments([(None if thetas is None else thetas[i], d, outs[i], 0)
                      for i, d in enumerate(deltas)], coeffs, counter)
    return outs


def _check_lanes(thetas: Sequence[torch.Tensor],
                 deltas: Sequence[torch.Tensor], coeffs: torch.Tensor,
                 lib: ctypes.CDLL) -> None:
    if len(thetas) != len(deltas):
        raise ValueError(f"{len(thetas)} thetas against {len(deltas)} "
                         f"deltas")
    if not deltas:
        raise ValueError("no leaves")
    if not coeffs.is_cuda:
        raise ValueError(f"coeffs must be a CUDA tensor, got device "
                         f"{coeffs.device}")
    device = coeffs.get_device()
    if coeffs.dim() != 2:
        raise ValueError(f"coeffs must be [S, K], got "
                         f"{tuple(coeffs.shape)}")
    lanes, k = int(coeffs.shape[0]), int(coeffs.shape[1])
    if lanes < 1 or not 1 <= k <= lib.fl_aggregate_max_k():
        raise ValueError(f"coeffs must be [S, K] with S >= 1 and K in "
                         f"[1, {lib.fl_aggregate_max_k()}], got "
                         f"{tuple(coeffs.shape)}")
    if coeffs.dtype != torch.float32 or not coeffs.is_contiguous():
        raise ValueError(f"coeffs must be contiguous float32, got "
                         f"{coeffs.dtype}")
    for i, (theta, d) in enumerate(zip(thetas, deltas)):
        _check_tensor(theta, f"leaf {i} theta", device)
        _check_tensor(d, f"leaf {i} deltas", device)
        if theta.dim() < 1 or theta.shape[0] != lanes:
            raise ValueError(f"leaf {i}: theta must be (S,) + the leaf's "
                             f"shape with S = {lanes}, got "
                             f"{tuple(theta.shape)}")
        if d.shape != (lanes, k) + theta.shape[1:]:
            raise ValueError(f"leaf {i}: deltas must be (S, K) + the "
                             f"leaf's shape = "
                             f"{(lanes, k) + tuple(theta.shape[1:])}, got "
                             f"{tuple(d.shape)}")


def fl_aggregate_lanes_cuda(thetas: Sequence[torch.Tensor],
                            deltas: Sequence[torch.Tensor],
                            coeffs: torch.Tensor) -> List[torch.Tensor]:
    """S lanes of one model: thetas[i] ``[S, ...]`` (f32 or bf16),
    deltas[i] ``[S, K, ...]``, coeffs ``[S, K]`` f32 -> per leaf ``[S,
    ...]`` in theta's dtype, ``out[i][s] = thetas[i][s] + sum_k
    coeffs[s, k] * deltas[i][s, k]`` summed in f32.  Every (lane, leaf)
    is one segment on coefficient row s, lane-major: one launch per
    table of at most ``fl_aggregate_max_segments()`` segments of one
    dtype pair, counted as ``fl_aggregate_lanes``."""
    thetas, deltas = list(thetas), list(deltas)
    _check_lanes(thetas, deltas, coeffs, _library())
    outs = [torch.empty_like(t) for t in thetas]
    lanes = int(coeffs.shape[0])
    _launch_segments([(thetas[i][s], deltas[i][s], outs[i][s], s)
                      for s in range(lanes) for i in range(len(thetas))],
                     coeffs, "fl_aggregate_lanes")
    return outs


def fl_aggregate_leaves_cuda(thetas: Sequence[torch.Tensor],
                             deltas: Sequence[torch.Tensor],
                             coeffs: torch.Tensor) -> List[torch.Tensor]:
    """thetas[i] (f32 or bf16, any shape), deltas[i] ``(K,) +
    thetas[i].shape`` (f32 or bf16), coeffs [K] f32 -> one tensor per
    leaf in theta's dtype, summed in f32: one launch per table of at most
    ``fl_aggregate_max_segments()`` leaves of one (theta, delta) dtype
    pair."""
    return _launch_leaves(list(thetas), list(deltas), coeffs,
                          "fl_aggregate")


def _check_flat(theta: torch.Tensor | None, deltas: torch.Tensor) -> None:
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be [K, N], got {tuple(deltas.shape)}")
    if theta is not None and theta.shape != deltas.shape[1:]:
        raise ValueError(f"theta must be [{deltas.shape[1]}], got "
                         f"{tuple(theta.shape)}")


def fl_aggregate_cuda(theta: torch.Tensor, deltas: torch.Tensor,
                      coeffs: torch.Tensor) -> torch.Tensor:
    """theta [N], deltas [K, N] (f32 or bf16), coeffs [K] f32 -> [N] in
    theta's dtype, summed in f32 (the one-leaf case)."""
    _check_flat(theta, deltas)
    return _launch_leaves([theta], [deltas], coeffs, "fl_aggregate")[0]


def fl_delta_reduce_leaves_cuda(deltas: Sequence[torch.Tensor],
                                coeffs: torch.Tensor,
                                outs: Sequence[torch.Tensor]
                                ) -> List[torch.Tensor]:
    """The partial eq.-(4) reduce over a model's leaves where they lie:
    deltas[i] ``(K,) + shape_i`` (f32 or bf16), coeffs [K] f32 -> per
    leaf f32 ``sum_k coeffs[k] * deltas[i][k]`` (no theta), written into
    ``outs`` (f32 contiguous tensors, e.g. views of one flat buffer that
    a collective then sums); one launch per table of leaves of one delta
    dtype, counted as ``fl_delta_reduce``."""
    return _launch_leaves(None, list(deltas), coeffs, "fl_delta_reduce",
                          outs=outs)


def fl_delta_reduce_cuda(deltas: torch.Tensor, coeffs: torch.Tensor
                         ) -> torch.Tensor:
    """deltas [K, N] (f32 or bf16), coeffs [K] f32 -> f32 [N]
    ``sum_k coeffs[k] * deltas[k]`` (no theta, no zero vector)."""
    _check_flat(None, deltas)
    return _launch_leaves(None, [deltas], coeffs, "fl_delta_reduce")[0]
