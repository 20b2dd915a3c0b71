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
``LAUNCHES["flash_attention"]``, and one more to
``LAUNCHES["flash_attention_lse"]`` when it also wrote ``lse``.

With ``return_lse=True`` the kernel also writes each query row's
log-sum-exp (f32 ``[B, H, Sq]``, natural log,
``m + log(max(l, 1e-30))``), the residual the training backward
(``repro_torch.models.flash``) recomputes P from, as the JAX package's
``_forward`` returns it.  Serving leaves it off and passes the library a
null pointer; ``out`` is bitwise the same either way.  The wrapper
refuses inputs that require grad under grad mode
(``_build.refuse_grad``): the differentiable entry is
``models.flash.flash_attention``.

The library holds two kernels, chosen by dtype: bf16 runs on the tensor
cores (``wgmma``, D padded to 64, 128 or 256), f32 on the CUDA cores.
:func:`kernel_path` decides the path, the padded head dim and the kv
tile, and the wrapper passes them to the library, which runs the
instantiation that matches.  :func:`flash_attention_flops` counts the work
the inputs need, for the kernel's bound.

The plain PyTorch version of the same function is
:func:`repro_torch.kernels.ref.mha_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 256

#: launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_lse": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_LIB: list = []


class KernelPath(NamedTuple):
    name: str      # "wgmma_bf16" or "cuda_cores_f32"
    d_pad: int     # the head dim the kernel computes with
    kv_tile: int   # kv rows per tile


def kernel_path(dtype: torch.dtype, d: int) -> KernelPath:
    """The kernel the library runs for ``dtype`` and head dim ``d``.
    bf16: the tensor-core kernel with D padded to 64, 128 or 256 (columns
    past ``d`` are zero-filled) and kv tiles of 128 rows, 64 at a padded
    D of 256 (the S and O accumulators then fill the registers).  f32:
    the CUDA-core kernel, D as it is, 64-row kv tiles.  Raises for what
    neither kernel takes."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {dtype} not in {list(_DTYPE_CODES)}")
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"head_dim must be a multiple of 16 in "
                         f"[16, {MAX_D}], got {d}")
    if dtype == torch.float32:
        return KernelPath("cuda_cores_f32", d, 64)
    d_pad = 64 if d <= 64 else (128 if d <= 128 else 256)
    return KernelPath("wgmma_bf16", d_pad, 128 if d_pad <= 128 else 64)


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through: the work the kernel must
    do for these inputs."""
    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_flops(b: int, h: int, d: int, sq: int, sk: int,
                          causal: bool, window: int) -> float:
    """Operations the inputs need: QK^T and PV (2 FLOP per multiply-add
    each) over the visible pairs of every (batch, head)."""
    return 4.0 * b * h * d * visible_pairs(sq, sk, causal, window)


def _library() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load_library("flash_attention")
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = (
            [vp] * 5 + [i32] * 9
            + [ctypes.POINTER(ctypes.c_longlong), f32, f32, i32, i32, vp])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> KernelPath:
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
    path = kernel_path(q.dtype, d)
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel copies rows in 16-byte pieces
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"bf16 {name} must be 16-byte aligned with strides "
                    f"that are multiples of 8 (strides {t.stride()})")
    return path


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """q [B, H, Sq, D], k/v [B, Hkv, Sk, D] (f32 or bf16, one dtype; any
    strides with a contiguous head_dim) -> [B, H, Sq, D] in q's dtype,
    laid out with q's strides; with ``return_lse``, ``(out, lse)``, lse
    f32 ``[B, H, Sq]``."""
    _build.refuse_grad("flash_attention", q, k, v)
    lib = _library()
    path = _check(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scale = scale if scale is not None else d ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPE_CODES[q.dtype],
            b, h, k.shape[1], sq, k.shape[2], d, path.d_pad, path.kv_tile,
            strides, float(scale), float(softcap), int(bool(causal)),
            int(window), stream)
    if code != 0:
        text = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {text} "
                           f"(cudaError {code})")
    LAUNCHES["flash_attention"] += 1
    if lse is None:
        return out
    LAUNCHES["flash_attention_lse"] += 1
    return out, lse
