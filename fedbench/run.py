#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, in this process:

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  The run makes its inputs from ``--seed``, sets up and warms the
arena through the schedule's first rounds, measures for ``--seconds``
(ending at the first round boundary after them), checks a sample of the
window's lane-rounds against the plain reference, and prints one JSON
object as its last line: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiler
trace of the window's first rounds.  It exits non-zero, printing no
result, without
enough CUDA cards, or where JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules a run may not load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every compiler cache at a fixed path inside the checkout (the
    port builds its kernels into ``build/torch_ext/`` itself)."""
    base = ROOT / "build" / "fedbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from fedbench.harness import main as hmain

    cell = hmain.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("fedbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"fedbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fail here, before any work)

    torch.set_num_threads(4)
    result = hmain.run(cell, args.seed, args.seconds, bool(args.trace),
                       T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"fedbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps({"notes": result["notes"]}))
    sys.stdout.flush()
    for line in result["stderr"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
