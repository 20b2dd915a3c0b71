#!/usr/bin/env python3
"""Read the check's numbers of a cell on many seeds in one process: the
program's, (``--control``) the control's, in which the reference
computed in bfloat16 takes the program's place, and (``--faults``) each
fault's, in which the reference in float32 with that fault planted
takes it.  These readings set the limits in
``fedbench/limits/<cell>.json``: above the largest the program gives,
below the smallest the control or a fault gives.

    python3 fedbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--faults 1,2,3] [--seconds 3]

Each seed is a set-up and a short window (one or more whole rounds) at
the cell's own size; one JSON line per seed.  Not run by the benchmark's
own runs.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from fedbench.harness import cell as hcell
    from fedbench.harness import check as hcheck
    from fedbench.harness import data as hdata
    from fedbench.harness import main as hmain

    cell = hmain.find_cell(args.workload)
    cfg, tr = cell.config, cell.traffic
    controls = {int(s) for s in args.control.split(",") if s}
    faulted = {int(s) for s in args.faults.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        inputs = hdata.make(cfg, tr, seed, "cuda")
        window = hcell.run_window(cfg, tr, inputs, args.seconds, False,
                                  "cuda", t0)
        checker = hcheck.Checker(cfg, tr, inputs, "cuda")
        t1 = time.perf_counter()
        items = []
        out = {"seed": seed,
               "program": hcheck.check(checker, window, details=items,
                                       limits=cell.limits),
               "check_s": time.perf_counter() - t1,
               "window_rounds": window.store.window_rounds,
               "items": items}
        if seed in controls:
            t2 = time.perf_counter()
            citems = []
            out["control"] = hcheck.check(checker, window, control=True,
                                          details=citems,
                                          limits=cell.limits)
            out["control_items"] = citems
            out["control_s"] = time.perf_counter() - t2
        for fault in (hcheck.FAULTS if seed in faulted else ()):
            fitems = []
            out[fault] = hcheck.check(checker, window, fault=fault,
                                      details=fitems, limits=cell.limits)
            out[fault + "_items"] = fitems
        print(json.dumps(out), flush=True)
        del inputs, window, checker
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
