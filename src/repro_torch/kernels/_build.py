"""Build and load the port's CUDA kernels at first use.

Each source ``kernels/csrc/<name>.cu`` is compiled for Hopper
(``-gencode=arch=compute_90a,code=sm_90a``) by
``torch.utils.cpp_extension.load`` into ``build/torch_ext/`` at the root
of the checkout (listed in ``.gitignore``), then opened with ``ctypes``:
the kernels export a plain C interface and include no PyTorch headers,
which keeps a cold build to seconds.  Nothing here runs at import time,
so the CPU tests import every module without ``nvcc``.

There is no fallback: a failed build raises, and so does asking for a
library on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
#: build/torch_ext/ at the checkout root (src/repro_torch/kernels -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: dict = {}


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (once per process) and return its
    ``ctypes`` handle; the caller declares the exported signatures."""
    import torch
    from torch.utils.cpp_extension import load

    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the {name} CUDA kernel needs a CUDA device; none is "
                f"visible to torch")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = load(name=f"repro_torch_{name}",
                    sources=[str(_CSRC / f"{name}.cu")],
                    extra_cuda_cflags=CUDA_FLAGS,
                    build_directory=str(BUILD_DIR),
                    is_python_module=False, verbose=verbose)
        lib = _LIBS[name] = ctypes.CDLL(os.fspath(path))
        return lib
