"""Python binding of the hand-written CUDA eq.-(4) kernel
(``csrc/fl_aggregate.cu``), the port of the Pallas TPU kernel
``repro.kernels.fl_aggregate.fl_aggregate_tpu``.

``fl_aggregate_cuda(theta, deltas, coeffs)`` computes
``theta + sum_k coeffs[k] * deltas[k]`` and ``fl_delta_reduce_cuda(deltas,
coeffs)`` the theta-less partial.  Both take CUDA tensors only: they
validate devices, dtypes, shapes and contiguity, allocate the output with
``torch.empty``, launch on the current stream without synchronising, and
raise on any launch error.  Each launch adds one to :data:`LAUNCHES`, so a
run can show that its main path went through the kernel.

The plain PyTorch version of the same function is
:func:`repro_torch.kernels.ref.aggregate_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"fl_aggregate": 0, "fl_delta_reduce": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIB: list = []


def _library() -> ctypes.CDLL:
    """The built library with every exported signature declared
    (pointers and the stream as ``c_void_p``, N as ``c_longlong``, so
    ctypes never truncates them)."""
    if not _LIB:
        lib = _build.load_library("fl_aggregate")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fl_aggregate_launch.argtypes = [vp, vp, vp, vp, i32, i64, i32,
                                            i32, vp]
        lib.fl_aggregate_launch.restype = i32
        lib.fl_delta_reduce_launch.argtypes = [vp, vp, vp, i32, i64, i32, vp]
        lib.fl_delta_reduce_launch.restype = i32
        lib.fl_aggregate_max_k.argtypes = []
        lib.fl_aggregate_max_k.restype = i32
        lib.fl_aggregate_error_string.argtypes = [i32]
        lib.fl_aggregate_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(deltas: torch.Tensor, coeffs: torch.Tensor,
           theta: torch.Tensor | None, lib: ctypes.CDLL) -> None:
    tensors = {"deltas": deltas, "coeffs": coeffs}
    if theta is not None:
        tensors["theta"] = theta
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"all inputs must share one device, got {devices}")
    if deltas.dim() != 2:
        raise ValueError(f"deltas must be [K, N], got {tuple(deltas.shape)}")
    k, n = deltas.shape
    if not 1 <= k <= lib.fl_aggregate_max_k():
        raise ValueError(f"K must lie in [1, {lib.fl_aggregate_max_k()}], "
                         f"got {k}")
    if coeffs.shape != (k,) or coeffs.dtype != torch.float32:
        raise ValueError(f"coeffs must be float32 [{k}], got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    if deltas.dtype not in _DTYPE_CODES:
        raise ValueError(f"deltas dtype {deltas.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    if theta is not None:
        if theta.shape != (n,):
            raise ValueError(f"theta must be [{n}], got "
                             f"{tuple(theta.shape)}")
        if theta.dtype not in _DTYPE_CODES:
            raise ValueError(f"theta dtype {theta.dtype} not in "
                             f"{list(_DTYPE_CODES)}")


def _raise_on(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code != 0:
        text = lib.fl_aggregate_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {text} "
                           f"(cudaError {code})")


def fl_aggregate_cuda(theta: torch.Tensor, deltas: torch.Tensor,
                      coeffs: torch.Tensor) -> torch.Tensor:
    """theta [N], deltas [K, N] (f32 or bf16), coeffs [K] f32 -> [N] in
    theta's dtype, summed in f32."""
    lib = _library()
    _check(deltas, coeffs, theta, lib)
    out = torch.empty_like(theta)
    if theta.numel() == 0:
        return out
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream(theta.device).cuda_stream
        code = lib.fl_aggregate_launch(
            theta.data_ptr(), deltas.data_ptr(), coeffs.data_ptr(),
            out.data_ptr(), deltas.shape[0], theta.numel(),
            _DTYPE_CODES[theta.dtype], _DTYPE_CODES[deltas.dtype], stream)
    _raise_on(code, lib, "fl_aggregate")
    LAUNCHES["fl_aggregate"] += 1
    return out


def fl_delta_reduce_cuda(deltas: torch.Tensor, coeffs: torch.Tensor
                         ) -> torch.Tensor:
    """deltas [K, N] (f32 or bf16), coeffs [K] f32 -> f32 [N]
    ``sum_k coeffs[k] * deltas[k]`` (no theta, no zero vector)."""
    lib = _library()
    _check(deltas, coeffs, None, lib)
    out = torch.empty(deltas.shape[1], dtype=torch.float32,
                      device=deltas.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(deltas.device):
        stream = torch.cuda.current_stream(deltas.device).cuda_stream
        code = lib.fl_delta_reduce_launch(
            deltas.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
            deltas.shape[0], deltas.shape[1], _DTYPE_CODES[deltas.dtype],
            stream)
    _raise_on(code, lib, "fl_delta_reduce")
    LAUNCHES["fl_delta_reduce"] += 1
    return out
