"""End-to-end FL driver (the paper's experiment, Figs. 1/2) in the PyTorch
port (``repro_torch``), the counterpart of ``examples/fl_simulation.py``:
train a model with LROA and the baselines over a non-IID synthetic image
dataset (offline stand-in for CIFAR-10/FEMNIST — same Dirichlet(0.5)
partition, same system model), then print the accuracy/latency
comparison.

The controller comparison grid (the full zoo — LROA, Uni-D, Uni-S,
channel-aware, cost-effective, round-robin, DivFL — any number of seeds)
runs through the scenario arena: ONE lane-batched rollout executes every
scenario over the shared client bank, each round's eq.-(4) step of every
lane one ``fl_aggregate`` kernel launch on the card.

    PYTHONPATH=src python examples/fl_simulation_torch.py [--rounds 60] \
        [--devices 30] [--controllers lroa,uni_d,uni_s,divfl] [--seeds 3] \
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import estimate_hyperparams
from repro_torch.fl import ClientConfig, RoundEngine
from repro_torch.optim import paper_step_decay
from repro_torch.sim import Arena, EvalBank, ScenarioGrid
from repro_torch.sim.testbed import BenchConfig, build_testbed


def run_arena_grid(names, cfg: BenchConfig, num_seeds: int, device="cuda",
                   *, params0=None, h_all=None, replay_selected=None,
                   replay_sort_keys=None):
    """All controllers x seeds as one lane-batched arena run on
    ``device``; returns {controller: (mean final accuracy, mean total
    latency)}.

    Accuracy comes from the arena's batched evaluation on the device (an
    ``EvalBank`` holding the test set, every lane evaluated in one
    call).  The initial model is the port's own draw from ``cfg.seed +
    1``; ``params0`` replaces it, and ``h_all``, ``replay_selected`` and
    ``replay_sort_keys`` replace the arena's draws (``Arena.run``), for
    the parity tests."""
    params, task, client_data, (xte, yte) = build_testbed(cfg,
                                                          device=device)
    hp = estimate_hyperparams(params, 0.1, loss_scale=1.5, mu=cfg.mu,
                              nu=cfg.nu)
    engine = RoundEngine(task, ClientConfig(local_epochs=cfg.local_epochs,
                                            batch_size=cfg.batch_size),
                         device=device)
    bank = engine.make_bank(client_data)
    eval_bank = EvalBank(task, xte, yte, device=device)
    grid = ScenarioGrid.product(controllers=names,
                                seeds=np.arange(num_seeds) + cfg.seed,
                                V=(hp.V,), lam=(hp.lam,),
                                sample_count=(cfg.sample_count,),
                                num_devices=cfg.num_devices)
    arena = Arena(engine)
    sched = paper_step_decay(cfg.lr, cfg.rounds)
    lr_seq = np.asarray([float(sched(t)) for t in range(cfg.rounds)],
                        np.float32)
    if params0 is None:
        params0 = task.init(torch.Generator(device).manual_seed(cfg.seed
                                                                + 1))
    report = arena.run(params0, params, bank, grid, cfg.rounds, lr_seq,
                       h_all=h_all, eval_bank=eval_bank,
                       replay_selected=replay_selected,
                       replay_sort_keys=replay_sort_keys)
    total = report.total_latency()
    accuracy = report.final_accuracy()
    results = {}
    for name in grid.controller_names():
        results.setdefault(name, ([], []))
    for s, name in enumerate(grid.controller_names()):
        results[name][0].append(float(accuracy[s]))
        results[name][1].append(float(total[s]))
    return {name: (float(np.mean(accs)), float(np.mean(times)))
            for name, (accs, times) in results.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--devices", type=int, default=24)
    ap.add_argument("--controllers", default="lroa,uni_d,uni_s")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per controller (arena lanes = "
                         "controllers x seeds)")
    ap.add_argument("--cnn", action="store_true",
                    help="use the CNN task (slower, closer to the paper)")
    ap.add_argument("--obs", metavar="LOG", nargs="?",
                    const="runlogs/fl_simulation.jsonl", default=None,
                    help="record a flight-recorder span log (JSONL); "
                         "render with tools/obs_report.py")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)

    sink = None
    if args.obs:
        from repro_torch.obs import trace as obs_trace
        sink = obs_trace.install_sink(obs_trace.JsonlSink(args.obs))

    cfg = BenchConfig(num_devices=args.devices, rounds=args.rounds,
                      use_cnn=args.cnn)
    names = args.controllers.split(",")
    s = len(names) * args.seeds
    print(f"=== arena: {','.join(names)} x {args.seeds} "
          f"seed(s) = {s} rollouts in one batched program ===")
    results = run_arena_grid(names, cfg, args.seeds, device=args.device)

    print(f"\n{'controller':10s} {'final acc':>10s} {'total time':>12s}")
    for name, (acc, total) in results.items():
        print(f"{name:10s} {acc:10.3f} {total:11.0f}s")
    if "lroa" in results:
        for base, (_, total) in results.items():
            if base == "lroa":
                continue
            save = 100 * (1 - results["lroa"][1] / total)
            print(f"LROA saves {save:.1f}% total latency vs {base}")

    if sink is not None:
        from repro_torch.obs import trace as obs_trace
        obs_trace.remove_sink(sink)
        sink.close()
        print(f"\nobs: span log written to {sink.path} — render with "
              f"'python tools/obs_report.py {sink.path}'")
    return results


if __name__ == "__main__":
    main()
