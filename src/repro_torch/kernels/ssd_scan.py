"""Python binding of the hand-written CUDA Mamba-2 SSD-chunk kernel
(``csrc/ssd_chunk.cu``), the port of the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd_chunk_tpu``.

``ssd_chunk_cuda(x, dt, a_log, b_in, c_in, chunk=)`` computes, for every
(batch, head, chunk), the intra-chunk output ``y_diag`` and the
chunk-end state, exactly the signature of ``ssd_chunk_tpu``: x
``[B, S, nh, hd]``, dt ``[B, S, nh]``, a_log ``[nh]``, b_in/c_in
``[B, S, N]``, S a multiple of ``chunk`` (the model layer pads) ->
(y_diag ``[B, S, nh, hd]`` in x's dtype, states ``[B, nc, nh, hd, N]``
f32).  CUDA tensors only: the wrapper validates devices, dtypes, shapes
and contiguity, launches on the current stream without synchronising and
raises on any launch error.  It refuses inputs that require grad under
grad mode (``_build.refuse_grad``): the differentiable entry is
``models.ssm.ssd_chunked``, whose ``autograd.Function`` launches this
forward and differentiates the plain version in its backward.

It launches two kernels: ``ssd_scores`` computes C B^T once per
(batch, chunk) into a ``[B, nc, L, L]`` f32 scratch (the lower triangle,
stored transposed, rows padded to a multiple of 4), and ``ssd_chunk`` builds y_diag and the states per
(batch, head, chunk) from it.  Each launch adds one to its kernel's
count in :data:`LAUNCHES`.  :func:`ssd_chunk_flops` counts the work the
inputs need, for the kernels' bound.

The cross-chunk recurrence stays in PyTorch
(``repro_torch.models.ssm.ssd_chunked``), as it stays in jnp in the JAX
package.  The plain version of this function is
:func:`repro_torch.kernels.ref.ssd_chunk_batched_reference`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448      # bytes of shared memory a block may use (H100)

#: launches since the last :func:`reset_launch_counts`
LAUNCHES: Dict[str, int] = {"ssd_scores": 0, "ssd_chunk": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def ssd_chunk_flops(b: int, s: int, nh: int, hd: int, n: int,
                    chunk: int) -> float:
    """Operations the inputs need (2 FLOP per multiply-add): C B^T over
    the lower triangle once per (batch, chunk), then per head W X over
    the triangle and the [hd, N] state over the chunk."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    return (2.0 * b * nc * pairs * n
            + 2.0 * b * nh * nc * (pairs * hd + chunk * hd * n))


_LIB: list = []


def _library() -> ctypes.CDLL:
    if not _LIB:
        lib = _build.load_library("ssd_chunk")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scores_launch.argtypes = [vp] * 3 + [i32] * 5 + [vp]
        lib.ssd_scores_launch.restype = i32
        lib.ssd_chunk_launch.argtypes = [vp] * 8 + [i32] * 7 + [vp]
        lib.ssd_chunk_launch.restype = i32
        lib.ssd_scores_ld.argtypes = [i32]
        lib.ssd_scores_ld.restype = i32
        lib.ssd_chunk_smem_bytes.argtypes = [i32]
        lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_chunk_error_string.argtypes = [i32]
        lib.ssd_chunk_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def _check(x, dt, a_log, b_in, c_in, chunk: int) -> None:
    named = (("x", x), ("dt", dt), ("a_log", a_log), ("b_in", b_in),
             ("c_in", c_in))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got device "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from x's "
                             f"{x.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("all inputs must share one device")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, nh, hd], got {tuple(x.shape)}")
    bsz, s, nh, _ = x.shape
    n = b_in.shape[-1] if b_in.dim() == 3 else -1
    want = {"dt": (bsz, s, nh), "a_log": (nh,), "b_in": (bsz, s, n),
            "c_in": (bsz, s, n)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name] or n <= 0:
            raise ValueError(f"{name} must be {list(want[name])}, got "
                             f"{tuple(t.shape)}")
    if chunk <= 0 or s == 0 or s % chunk:
        raise ValueError(f"S = {s} must be a positive multiple of chunk = "
                         f"{chunk}")
    # the kernel moves rows of x, B, C, y and the states 4 values at a time
    if x.shape[-1] % 4 or n % 4:
        raise ValueError(f"hd = {x.shape[-1]} and N = {n} must be multiples "
                         f"of 4")
    for name, t in (("x", x), ("b_in", b_in), ("c_in", c_in)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD over a full sequence (see the module docstring)."""
    _build.refuse_grad("ssd_chunk", x, dt, a_log, b_in, c_in)
    lib = _library()
    _check(x, dt, a_log, b_in, c_in, chunk)
    bsz, s, nh, hd = x.shape
    n = b_in.shape[-1]
    smem = lib.ssd_chunk_smem_bytes(chunk)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"chunk={chunk} needs {smem} bytes "
                         f"of shared memory, more than {_SMEM_LIMIT}")
    nc = s // chunk
    y = torch.empty_like(x)
    states = torch.empty((bsz, nc, nh, hd, n), dtype=torch.float32,
                         device=x.device)
    scores = torch.empty((bsz, nc, chunk, lib.ssd_scores_ld(chunk)),
                         dtype=torch.float32, device=x.device)
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on("ssd_scores", lib, lib.ssd_scores_launch(
            b_in.data_ptr(), c_in.data_ptr(), scores.data_ptr(), code, bsz,
            s, n, chunk, stream))
        LAUNCHES["ssd_scores"] += 1
        _raise_on("ssd_chunk", lib, lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_in.data_ptr(),
            c_in.data_ptr(), y.data_ptr(), states.data_ptr(),
            scores.data_ptr(), code, bsz, s, nh, hd, n, chunk, stream))
        LAUNCHES["ssd_chunk"] += 1
    return y, states


def _raise_on(name: str, lib: ctypes.CDLL, code: int) -> None:
    if code != 0:
        text = lib.ssd_chunk_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {text} "
                           f"(cudaError {code})")
