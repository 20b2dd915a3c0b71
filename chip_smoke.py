#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one result line each (exits non-zero on any failure; no phase's
error is caught):

1. device — ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build — compiles the hand-written CUDA kernel from ``src/`` (first use
   builds into ``build/torch_ext/``);
3. kernel against plain — ``fl_aggregate`` and ``fl_delta_reduce`` against
   their plain PyTorch versions (``kernels/ref.py``) at the slice's model
   size and the other smoke points, with the kernel's median time (CUDA
   events, L2 flushed before every launch), the plain version's, one
   ``torch.addmv`` call's (f32 only) and the bound (bytes over the card's
   HBM rate, operations over its f32 rate, the larger);
4. reference — a small trainer run on the card against the same run on
   the CPU (the CPU path is held against the JAX package by the tests);
5. main path — the paper-scale CNN testbed (N = 120 Dirichlet-0.5
   clients, K = 8, E = 2, batch 16, ``bank_mode='single'``): ``warmup()``,
   then 3 LROA rounds through ``FederatedTrainer.run_round``, checking
   finite losses, q on the simplex, moved queues, changed params and
   exactly one ``fl_aggregate`` launch per round;
6. profile — one more round under ``torch.profiler`` (device time by
   kernel, launches, the device's busy share);
7. the ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

Float32 matmuls and convolutions run in full f32 (TF32 off), so the card
computes what the CPU reference computes.  Imports ``torch``, ``numpy``
and ``repro_torch`` only.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published peaks (NVIDIA data sheets, dense): HBM bytes/s and float32
# (non-tensor-core) FLOP/s, matched on the name nvidia-smi reports
PEAKS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# (N, K, dtype): the slice's CNN, the 11.17M-parameter model that
# paper_default_params accounts for, a ragged N, and K = 1
POINTS = ((545_002, 8, torch.float32), (11_172_342, 8, torch.float32),
          (11_172_342, 8, torch.bfloat16), (65_537, 3, torch.float32),
          (129, 1, torch.float32))
MAIN_POINT = POINTS[0]
ROUNDS = 3
# benchmarks/common.BenchConfig.paper_scale() at K = 8
PAPER_SCALE = dict(num_devices=120, sample_count=8, local_epochs=2,
                   batch_size=16, examples=50_000, image_shape=(32, 32, 3),
                   num_classes=10, width=32, lr=0.1, rounds=2000, seed=0)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def peaks(name: str):
    for key, hbm, f32 in PEAKS:
        if key in name:
            return hbm, f32
    raise RuntimeError(f"no published peaks for card {name!r}")


def time_ms(fn, iters: int = 30, flush=None) -> float:
    """Median device time of ``fn`` over CUDA events, one launch per
    event pair, with the L2 cache flushed before each launch."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_kernels(flush, hbm: float, f32_peak: float) -> list:
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    points = []
    for n, k, dtype in POINTS:
        theta = torch.randn(n, device="cuda", generator=gen).to(dtype)
        deltas = torch.randn(k, n, device="cuda", generator=gen).to(dtype)
        coeffs = torch.softmax(torch.randn(k, device="cuda", generator=gen),
                               0)
        tol = TOL[dtype]
        out = fk.fl_aggregate_cuda(theta, deltas, coeffs)
        red = fk.fl_delta_reduce_cuda(deltas, coeffs)
        want = ref.aggregate_reference(theta, deltas, coeffs)
        want_red = ref.delta_reduce_reference(deltas, coeffs)
        torch.cuda.synchronize()
        ok = (torch.allclose(out.float(), want.float(), atol=tol, rtol=tol)
              and torch.allclose(red, want_red, atol=tol, rtol=tol))
        err = float((out.float() - want.float()).abs().max())
        err_red = float((red - want_red).abs().max())
        size = theta.element_size()
        agg_bytes = (k + 2) * n * size + 4 * k
        red_bytes = k * n * size + 4 * n + 4 * k
        ops = 2 * k * n
        row = dict(
            n=n, k=k, dtype=str(dtype).replace("torch.", ""), tol=tol,
            max_abs_err=err, reduce_max_abs_err=err_red,
            ms=time_ms(lambda: fk.fl_aggregate_cuda(theta, deltas, coeffs),
                       flush=flush),
            plain_ms=time_ms(lambda: ref.aggregate_reference(
                theta, deltas, coeffs), flush=flush),
            library_ms=(time_ms(lambda: torch.addmv(theta, deltas.t(),
                                                    coeffs), flush=flush)
                        if dtype == torch.float32 else None),
            bound_ms=max(agg_bytes / hbm, ops / f32_peak) * 1e3,
            bound_by="bytes" if agg_bytes / hbm >= ops / f32_peak
            else "operations",
            reduce_ms=time_ms(lambda: fk.fl_delta_reduce_cuda(deltas,
                                                              coeffs),
                              flush=flush),
            reduce_plain_ms=time_ms(lambda: ref.delta_reduce_reference(
                deltas, coeffs), flush=flush),
            reduce_bound_ms=max(red_bytes / hbm, ops / f32_peak) * 1e3)
        log("kernel", **row)
        require(ok, f"kernel disagrees with its plain version at N={n} "
                    f"K={k} {dtype} (err {err}, reduce err {err_red}, "
                    f"tol {tol})")
        points.append(row)
        del theta, deltas, out, red, want, want_red
    return points


def build_trainer(device: str, cfg: dict, data: dict, sort_keys_fn=None):
    from repro_torch.core import (LROAController, estimate_hyperparams,
                                  paper_default_params)
    from repro_torch.fl import (ChannelConfig, ChannelProcess, ClientConfig,
                                FederatedTrainer)
    from repro_torch.models import CNNTask
    from repro_torch.optim import paper_step_decay

    params = paper_default_params(
        num_devices=cfg["num_devices"], sample_count=cfg["sample_count"],
        local_epochs=cfg["local_epochs"], data_sizes=data["sizes"],
        device=device)
    task = CNNTask(image_shape=cfg["image_shape"],
                   num_classes=cfg["num_classes"], width=cfg["width"])
    hp = estimate_hyperparams(params, 0.1, loss_scale=1.5, mu=1.0, nu=1e5)
    return FederatedTrainer(
        task, params, LROAController(params, hp),
        ChannelProcess(cfg["num_devices"], ChannelConfig(seed=cfg["seed"])),
        data["clients"],
        ClientConfig(local_epochs=cfg["local_epochs"],
                     batch_size=cfg["batch_size"]),
        paper_step_decay(cfg["lr"], cfg["rounds"]), test_data=data["test"],
        eval_every=max(cfg["rounds"] // 6, 1), seed=cfg["seed"],
        bank_mode="single", device=device, sort_keys_fn=sort_keys_fn)


def make_data(cfg: dict) -> dict:
    """The benchmark testbed (``benchmarks/common.build_testbed``), from
    the port's numpy copies of the data layer."""
    from repro_torch.data import (dirichlet_partition, make_client_datasets,
                                  synthetic_image_classification,
                                  train_test_split)
    x, y = synthetic_image_classification(
        cfg["examples"], cfg["image_shape"], cfg["num_classes"], noise=0.3,
        seed=cfg["seed"])
    (xtr, ytr), test = train_test_split(x, y, 0.15, seed=cfg["seed"] + 1)
    parts = dirichlet_partition(ytr, cfg["num_devices"], 0.5,
                                seed=cfg["seed"] + 2)
    return dict(clients=make_client_datasets(xtr, ytr, parts), test=test,
                sizes=np.asarray([len(p) for p in parts], np.float32))


def phase_reference(devices=("cpu", "cuda")) -> None:
    """The port on the card against the port on the CPU, on a small
    testbed, with the same initial params and epoch keys.  The card's run
    launches ``fl_aggregate`` once per round, the CPU's never.  Also run
    by ``tests/test_torch_cuda.py``."""
    from repro_torch.kernels import fl_aggregate as fk

    cfg = dict(num_devices=6, sample_count=3, local_epochs=2, batch_size=8,
               examples=400, image_shape=(8, 8, 1), num_classes=4, width=4,
               lr=0.1, rounds=3, seed=0)
    from repro_torch.data import bucket_examples

    data = make_data(cfg)
    rows = bucket_examples([len(x) for x, _ in data["clients"]],
                           cfg["batch_size"])
    runs = []
    for device in devices:
        key_rng = np.random.default_rng(123)
        trainer = build_trainer(
            device, cfg, data, sort_keys_fn=lambda k, r=key_rng: r.random(
                (k, cfg["local_epochs"], rows), np.float32))
        gen = torch.Generator()
        gen.manual_seed(7)
        trainer.global_params = {
            name: p.to(device) for name, p in trainer.task.init(gen).items()}
        before = fk.LAUNCHES["fl_aggregate"]
        recs = [trainer.run_round(t) for t in range(cfg["rounds"])]
        launched = fk.LAUNCHES["fl_aggregate"] - before
        require(launched == (cfg["rounds"] if device == "cuda" else 0),
                f"{device} run: {launched} fl_aggregate launches in "
                f"{cfg['rounds']} rounds")
        runs.append((recs, {n: p.cpu() for n, p in
                            trainer.global_params.items()},
                     trainer.controller.queues.cpu()))
    (rc, pc, qc), (rg, pg, qg) = runs
    sel_equal = all(a.selected == b.selected for a, b in zip(rc, rg))
    param_err = max(float((pc[n] - pg[n]).abs().max()) for n in pc)
    loss_err = max(abs(a.mean_loss - b.mean_loss) for a, b in zip(rc, rg))
    queue_rel = float(((qc - qg).abs() / qc.abs().clamp(min=1.0)).max())
    log("reference", rounds=cfg["rounds"], selections_equal=sel_equal,
        param_max_abs_err=param_err, loss_max_abs_err=loss_err,
        queue_max_rel_err=queue_rel, tol=1e-4)
    require(sel_equal, "card and CPU select the same clients")
    require(param_err <= 1e-4 and loss_err <= 1e-4 and queue_rel <= 1e-4,
            "card and CPU runs agree within 1e-4")


def phase_main_path(device: str = "cuda", cfg: dict = PAPER_SCALE) -> dict:
    from repro_torch.kernels import fl_aggregate as fk
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    data = make_data(cfg)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = build_trainer(device, cfg, data)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    bank = trainer.bank
    n_params = sum(p.numel() for p in trainer.global_params.values())
    log("main.setup", data_s=t_data, trainer_s=t_build,
        clients=cfg["num_devices"], sample_count=cfg["sample_count"],
        bucket_rows=bank.bucket_examples, steps_per_epoch=bank.steps_per_epoch,
        bank_bytes=bank.nbytes, model_params=n_params,
        sizes_min=int(bank.sizes.min()), sizes_max=int(bank.sizes.max()))
    t0 = time.perf_counter()
    trainer.warmup()
    log("main.warmup", seconds=time.perf_counter() - t0)

    before = {n: p.clone() for n, p in trainer.global_params.items()}
    queues0 = trainer.controller.queues.clone()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    per_round, rounds = [], []
    fk.reset_launch_counts()
    with trace.installed(trace.MemorySink()) as sink:
        t_all = time.perf_counter()
        for t in range(ROUNDS):
            count0 = fk.LAUNCHES["fl_aggregate"]
            t0 = time.perf_counter()
            rec = trainer.run_round(t)
            torch.cuda.synchronize()
            per_round.append(time.perf_counter() - t0)
            rounds.append((rec, fk.LAUNCHES["fl_aggregate"] - count0))
            q = trainer.last_decision.q
            require(bool(torch.all(q > 0)) and
                    abs(float(q.sum()) - 1.0) <= 1e-5,
                    f"round {t}: q on the simplex")
        t_all = time.perf_counter() - t_all
    launches = dict(fk.LAUNCHES)
    decide_s = [r["dur"] for r in sink.by_name("controller.decide")]
    peak = torch.cuda.max_memory_allocated()
    for t, (rec, n_launch) in enumerate(rounds):
        log("main.round", t=t, seconds=per_round[t], decide_s=decide_s[t],
            loss=rec.mean_loss, selected=rec.selected,
            fl_aggregate_launches=n_launch, queue_mean=rec.queue_mean,
            wall_time_model_s=rec.wall_time,
            test_accuracy=rec.test_accuracy)
        require(np.isfinite(rec.mean_loss), f"round {t}: finite loss")
        require(n_launch == 1, f"round {t}: one fl_aggregate launch, "
                               f"got {n_launch}")
    require(launches["fl_aggregate"] == ROUNDS,
            f"{ROUNDS} fl_aggregate launches in the main path")
    moved = float((trainer.controller.queues - queues0).abs().max())
    changed = max(float((trainer.global_params[n] - before[n]).abs().max())
                  for n in before)
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.global_params.values())
    require(moved > 0.0, "the queues moved")
    require(changed > 0.0 and finite, "the params changed and are finite")
    summary = dict(rounds=ROUNDS, seconds=t_all, rounds_per_s=ROUNDS / t_all,
                   round_s_median=statistics.median(per_round),
                   decide_s_median=statistics.median(decide_s),
                   bank_bytes=bank.nbytes, peak_mem_bytes=peak,
                   queue_max_change=moved, param_max_change=changed,
                   launches=launches)
    log("main", **summary)
    summary["trainer"] = trainer
    return summary


def phase_profile(trainer, t: int) -> None:
    """One more round under ``torch.profiler``: device time by kernel,
    launches, and the device's busy share of the round's wall time (the
    profiler slows the host side, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_round(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    log("profile", round_s=wall, device_busy_s=busy_us * 1e-6,
        device_busy_share=busy_us * 1e-6 / wall,
        kernel_launches=sum(e.count for e in kernels),
        top=[dict(name=e.key[:80], launches=e.count,
                  device_s=e.self_device_time_total * 1e-6)
             for e in top])


def kernels_line(points: list, main_summary: dict, smi: str) -> dict:
    """The ``kernels`` record: each kernel of the main path with its
    launches there and its numbers at the main path's shape."""
    m = next(p for p in points if (p["n"], p["k"]) == MAIN_POINT[:2]
             and p["dtype"] == "float32")
    return {"kernels": [{
        "name": "fl_aggregate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fl_aggregate.cu",
        "replaces": "src/repro/kernels/fl_aggregate.py:35",
        "status": "ported",
        "launches": main_summary["launches"]["fl_aggregate"],
        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "max_abs_err_all_points": max(p["max_abs_err"] for p in points),
        "variants": {"fl_delta_reduce": {
            "launches": main_summary["launches"]["fl_delta_reduce"],
            "max_abs_err": m["reduce_max_abs_err"], "ms": m["reduce_ms"],
            "plain_ms": m["reduce_plain_ms"],
            "bound_ms": m["reduce_bound_ms"]}},
        "card": smi}]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import fl_aggregate as fk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    hbm, f32_peak = peaks(kind)
    print(smi, flush=True)
    log("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        hbm_bytes_per_s=hbm, f32_flops=f32_peak, tf32=False)

    t0 = time.perf_counter()
    fk.build()
    log("build", seconds=time.perf_counter() - t0)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    points = phase_kernels(flush, hbm, f32_peak)
    del flush
    phase_reference()
    main_summary = phase_main_path()
    phase_profile(main_summary.pop("trainer"), ROUNDS)

    print(json.dumps(kernels_line(points, main_summary, smi)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
