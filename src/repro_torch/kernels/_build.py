"""Build and load the port's CUDA kernels at first use.

Each source ``kernels/csrc/<name>.cu`` is compiled for Hopper
(``-gencode=arch=compute_90a,code=sm_90a``) by ``nvcc`` into a shared
library under ``build/torch_ext/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, and opened
with ``ctypes``: the kernels export a plain C interface and include no
PyTorch headers, which keeps a cold build to seconds.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them together.
Nothing here runs at import time, so the CPU tests import every module
without ``nvcc``.

There is no fallback: a failed build raises with the compiler's output,
and so does asking for a library on a machine without CUDA.
:func:`refuse_grad` is the one check every kernel wrapper makes before it
launches: a kernel writes into fresh tensors that autograd cannot see, so
it never runs where its output would be expected to carry a gradient.

:data:`LOADED` lists, in order, every library this process has loaded:
the port's counterpart of a cold compile, which the retrace watchdog
(``repro_torch.obs.watchdog``) counts after an arena's warmup.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

_CSRC = Path(__file__).resolve().parent / "csrc"
#: build/torch_ext/ at the checkout root (src/repro_torch/kernels -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC"]
#: every kernel source of the port
KERNELS = ("fl_aggregate", "flash_attention", "ssd_chunk")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: the compiler's output of each verbose build (``-Xptxas -v``)
BUILD_LOG: Dict[str, str] = {}
#: every kernel library this process loaded, in load order (one entry per
#: library, built here or found built on disk)
LOADED: List[str] = []


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME \
        else []
    candidates.append(shutil.which("nvcc") or "")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (no CUDA toolkit on this machine)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named by a hash of the source and
    the flags."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(CUDA_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = KERNELS, verbose: bool = False
              ) -> Dict[str, float]:
    """Compile and load every named kernel not loaded yet, one ``nvcc``
    per source, all started together.  Returns each kernel's build time
    in seconds (0.0 for one already loaded or found built).  With
    ``verbose``, ``-Xptxas -v`` reports registers and shared memory."""
    import torch

    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return {n: 0.0 for n in names}
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the {', '.join(todo)} CUDA kernel(s) need a CUDA device; "
                f"none is visible to torch")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = CUDA_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        nvcc = nvcc_path()
        seconds = {n: 0.0 for n in names}
        procs = {}
        t0 = time.perf_counter()
        for name in todo:
            target = library_path(name)
            if target.exists() and not verbose:
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *flags, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, target)
        while procs:
            for name, (proc, tmp, target) in list(procs.items()):
                if proc.poll() is None:
                    continue
                output = proc.stdout.read()
                del procs[name]
                seconds[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    for other, _, _ in procs.values():
                        other.kill()
                    raise RuntimeError(
                        f"nvcc failed on {name}.cu (exit "
                        f"{proc.returncode}):\n{output}")
                if verbose and output.strip():
                    BUILD_LOG[name] = output
                    print(f"[nvcc {name}]\n{output}", flush=True)
                os.replace(tmp, target)
            time.sleep(0.02)
        for name in todo:
            _LIBS[name] = ctypes.CDLL(os.fspath(library_path(name)))
            LOADED.append(name)
        return seconds


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per process) and return its
    ``ctypes`` handle; the caller declares the exported signatures."""
    build_all([name], verbose=verbose)
    return _LIBS[name]


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if ``kernel`` is reached with grad enabled and an input that
    requires grad: its output would come back detached and every
    parameter upstream would get no gradient.  A kernel with a backward
    is launched inside its ``torch.autograd.Function``'s forward, where
    grad is off (``models.flash.flash_attention``,
    ``models.ssm.ssd_chunked``)."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} CUDA kernel has no backward here: call it under "
            f"torch.no_grad(), on inputs that do not require grad, or "
            f"through its autograd.Function")
