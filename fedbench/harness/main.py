"""A run of one cell, end to end: find the cell's files by name, make the
inputs from the seed, run the window, check the outputs against the
reference, read the metrics and form the result line."""

from __future__ import annotations

import dataclasses
import importlib
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from fedbench import flops
from fedbench.harness import cell as hcell
from fedbench.harness import check as hcheck
from fedbench.harness import data as hdata
from fedbench.harness import profile as hprof

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration's file,
    its traffic file (``fedbench/traffic/<traffic>.json``), its limits
    (``fedbench/limits/<cell>.json``) and the metrics it reports."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have: {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    limits_path = root / "fedbench" / "limits" / f"{name}.json"

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(root / conf["file"]),
                traffic=load_json(root / "fedbench" / "traffic"
                                  / f"{w['traffic']}.json"),
                limits=(load_json(limits_path) if limits_path.exists()
                        else None),
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=[m for m in manifest["per_layer"] if mine(m)])


def reader(metric_name: str):
    """The per-layer metric's reader module, by name."""
    return importlib.import_module(f"fedbench.metrics.{metric_name}")


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader may read."""
    digest: Optional[hprof.Digest]
    rounds: int            # the rounds the profiler saw (the trace's)
    lanes: int
    k: int
    params: int
    useful_rows: int
    trained_rows: int
    work_flops: float      # model work of the rounds ``mfu_s`` spans
    mfu_s: float           # window seconds the profiler was off
    peak_flops: float


def row_counts(window: hcell.Window, traffic: dict, epochs: int, bs: int,
               rounds: Optional[int] = None) -> tuple:
    """``(useful, trained)`` rows of the window's rounds (its first
    ``rounds`` of them): per live slot, E x min(n, max(n // bs, 1) x bs)
    of the client's own rows against E x its rung's width."""
    st = window.store
    w0 = traffic["setup_rounds"]
    last = st.window_rounds if rounds is None else rounds
    sel = st.columns["selected"][:, w0:w0 + last, :]
    sel = sel[sel >= 0]
    n = window.layout["sizes"][sel]
    useful = np.minimum(n, np.maximum(n // bs, 1) * bs)
    return (int(epochs * useful.sum()),
            int(epochs * window.layout["widths"][sel].sum()))


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", control: bool = False,
        fault: Optional[str] = None) -> dict:
    """One run; returns the result (``line`` the contract's object,
    ``numbers`` the check's, ``stderr`` the closing lines).  ``control``
    or ``fault`` judge the reference put in the program's place instead
    of the program (``check.check``)."""
    cfg, tr = cell.config, cell.traffic
    inputs = hdata.make(cfg, tr, seed, device)
    window = hcell.run_window(cfg, tr, inputs, seconds, trace, device,
                              t_process)
    st = window.store
    window_s = st.t1 - st.t0
    epochs = int(cfg["client"]["local_epochs"])
    useful, trained = row_counts(window, tr, epochs,
                                 int(cfg["client"]["batch_size"]))
    peak = flops.PEAK_FLOPS["tf32" if window.tf32_conv else "float32"]
    # the whole round's share of the peak counts only the window's rounds
    # before the profiler started (all of them in an untraced run)
    mfu_s = st.t_untraced - st.t0
    mfu_rows = row_counts(window, tr, epochs,
                          int(cfg["client"]["batch_size"]),
                          st.untraced_rounds)[0]
    t_digest = time.perf_counter()
    digest = (hprof.digest(window.traced) if window.traced is not None
              else None)
    digest_s = time.perf_counter() - t_digest
    ctx = Context(digest=digest, rounds=st.traced_rounds,
                  lanes=window.lanes, k=int(tr["sample_count"]),
                  params=flops.param_count(cfg["model"]),
                  useful_rows=useful,
                  trained_rows=trained,
                  work_flops=float(flops.train_flops(cfg["model"],
                                                     mfu_rows)),
                  mfu_s=mfu_s if mfu_rows else 0.0,
                  peak_flops=peak)
    t_check = time.perf_counter()
    checker = hcheck.Checker(cfg, tr, inputs, device)
    numbers = hcheck.check(checker, window, control=control,
                           limits=cell.limits, fault=fault)
    check_s = time.perf_counter() - t_check
    lane_rounds = window.lanes * st.window_rounds
    metrics = {}
    if not trace:
        values = {"lane_rounds_per_s": lane_rounds / window_s,
                  "setup_s": window.setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if cell.limits is None:
        raise SystemExit(f"no limits file for {cell.name} under "
                         f"fedbench/limits/")
    limits = {n: cell.limits.get(n) for n in hcheck.NUMBERS}
    correct = hcheck.verdict(numbers, limits)
    checked = (len(st.start_items)
               + sum(len(items) for items in st.window_items))
    dev_info = {"platform": "gpu" if device != "cpu" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                         else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": window.memory_peak_bytes}
    line = {"correct": bool(correct), "attempted": int(lane_rounds),
            "failed": 0 if correct else int(checked),
            "metrics": metrics, "device": dev_info}
    if digest is not None:
        dev_info["busy_s"] = digest.busy_s()
        dev_info["window_s"] = digest.window_s
        line["breakdown"] = hprof.breakdown(digest)
    line["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                      for n in hcheck.NUMBERS}
    notes = {"round_mfu": (100.0 * ctx.work_flops / ctx.mfu_s / peak
                           if ctx.mfu_s else None),
             "mfu_rounds": st.untraced_rounds,
             "trace_stop_s": window.trace_stop_s,
             "useful_row_share": 100.0 * useful / max(trained, 1),
             "window_rounds": st.window_rounds,
             "traced_rounds": st.traced_rounds if trace else 0,
             "window_s": window_s, "check_s": check_s,
             "signatures_traced_in_window": window.traces_in_window,
             "kernel_libraries_loaded_in_window":
                 window.kernels_loaded_in_window,
             "tf32_conv": window.tf32_conv,
             "tf32_matmul": window.tf32_matmul,
             "eval_accuracy_gap": numbers["eval_accuracy_gap"],
             "round_s": [float(x) for x in np.diff(st.clock)],
             "setup_marks_s": window.marks}
    if digest is not None:
        notes["trace"] = dict(digest.stats, reduce_s=digest_s)
    stderr = [f"check {n} {numbers[n]!r} limit "
              + (repr(limits[n]) if limits[n] is not None
                 else "none (not compared)") for n in hcheck.NUMBERS]
    return {"line": line, "numbers": numbers, "notes": notes,
            "stderr": stderr}
