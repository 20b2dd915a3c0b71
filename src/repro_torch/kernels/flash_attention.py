"""Python binding of the hand-written CUDA flash-attention forward
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_tpu``.

``flash_attention_cuda(q, k, v, ...)`` takes q ``[B, H, Sq, D]`` and k, v
``[B, Hkv, Sk, D]`` as the TPU kernel does, but reads them through their
strides: any layout whose head_dim axis is contiguous is taken as it is,
so the model's ``[B, S, H, D]`` activations pass as ``transpose(1, 2)``
views with no copy, and the output is allocated with q's strides (a
``[B, S, H, D]`` buffer for them).  The wrapper validates devices,
dtypes, shapes and strides, launches on the current stream without
synchronising and raises on any launch error.  Each launch adds one to
:data:`LAUNCHES`.

The plain PyTorch version of the same function is
:func:`repro_torch.kernels.ref.mha_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


_LIB: list = []


def _library() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load_library("flash_attention")
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = (
            [vp, vp, vp, vp] + [i32] * 7
            + [ctypes.POINTER(ctypes.c_longlong), f32, f32, i32, i32, vp])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_max_d.argtypes = []
        lib.flash_attention_max_d.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           max_d: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device "
                             f"{t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along head_dim "
                             f"(strides {t.stride()})")
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} dtype {t.dtype} not in "
                             f"{list(_DTYPE_CODES)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must share one device")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k and v must share one dtype, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be [{b}, Hkv, Sk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if q.shape[2] == 0 or k.shape[2] == 0 or q.numel() == 0:
        raise ValueError("empty q or kv sequence")
    if h % k.shape[1]:
        raise ValueError(f"H = {h} is not a multiple of Hkv = {k.shape[1]}")
    if d % 16 or not 16 <= d <= max_d:
        raise ValueError(f"head_dim must be a multiple of 16 in "
                         f"[16, {max_d}], got {d}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, Sq, D], k/v [B, Hkv, Sk, D] (f32 or bf16, one dtype; any
    strides with a contiguous head_dim) -> [B, H, Sq, D] in q's dtype,
    laid out with q's strides."""
    lib = _library()
    _check(q, k, v, lib.flash_attention_max_d())
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    scale = scale if scale is not None else d ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, k.shape[1], sq, k.shape[2], d,
            strides, float(scale), float(softcap), int(bool(causal)),
            int(window), stream)
    if code != 0:
        text = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {text} "
                           f"(cudaError {code})")
    LAUNCHES["flash_attention"] += 1
    return out
