"""Quickstart: LROA online control in ~40 lines, in the PyTorch port
(``repro_torch``), the counterpart of ``examples/quickstart.py``.

Builds the paper's edge system (heterogeneous devices, random channels),
runs Algorithm 2 each round on the device, and shows the Lyapunov
trade-off: latency is minimised while the per-device energy queues stay
bounded (energy budget satisfied on time-average).  The channels come
from the seeded numpy ``ChannelProcess``, so the numbers are those of
the JAX script.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (LROAController, estimate_hyperparams,
                              paper_default_params)
from repro_torch.core import system_model as sm
from repro_torch.fl import ChannelConfig, ChannelProcess

N_DEVICES, ROUNDS = 40, 400


def run(n_devices=N_DEVICES, rounds=ROUNDS, device="cuda") -> dict:
    """Algorithm 2 and the queue update for ``rounds`` rounds on
    ``device``: ``{"lam", "V", "budget", "rounds": [{"round", "latency",
    "q_min", "q_max", "queue_max", "avg_energy"}, ...]}``, one entry for
    each round the script prints."""
    rng = np.random.default_rng(0)
    params = paper_default_params(
        num_devices=n_devices,
        data_sizes=rng.integers(200, 600, n_devices).astype(np.float32),
        device=device)
    # nu trades objective quality for constraint-convergence speed (Thm 4
    # / Fig. 4); a small nu makes the energy queues bite within this
    # short demo.
    hp = estimate_hyperparams(params, mean_gain=0.1, loss_scale=1.5,
                              mu=1.0, nu=1e3)
    controller = LROAController(params, hp)
    channel = ChannelProcess(n_devices, ChannelConfig(seed=0))

    out = dict(lam=hp.lam, V=hp.V, rounds=[],
               budget=float(params.energy_budget[0]))
    energy = np.zeros(n_devices)
    for t in range(rounds):
        h = torch.as_tensor(channel.sample(), dtype=torch.float32,
                            device=device)      # observe channels (Alg.1 l.3)
        decision = controller.decide(h)         # Algorithm 2 (f, p, q)
        energy += sm.expected_energy(params, h, decision.p, decision.f,
                                     decision.q).cpu().numpy()
        controller.step_queues(h, decision)     # queue update (eq. 19)
        if t % 80 == 0 or t == rounds - 1:
            lat = float(sm.expected_round_latency(
                decision.q, sm.round_time(params, h, decision.p,
                                          decision.f)))
            out["rounds"].append(dict(
                round=t, latency=lat, q_min=float(decision.q.min()),
                q_max=float(decision.q.max()),
                queue_max=float(controller.queues.max()),
                avg_energy=energy.mean() / (t + 1)))
    return out


def report(res: dict) -> None:
    """Print :func:`run`'s result as the JAX script prints its run."""
    print(f"lambda = {res['lam']:.1f}  V = {res['V']:.3g}")
    for r in res["rounds"]:
        print(f"round {r['round']:4d}  E[latency] {r['latency']:8.1f}s  "
              f"q in [{r['q_min']:.4f}, {r['q_max']:.4f}]  "
              f"queue max {r['queue_max']:9.1f}  "
              f"avg energy {r['avg_energy']:6.2f} J "
              f"(budget {res['budget']:.0f} J)")

    print("\nDone: sampling probabilities now favour fast/cheap devices "
          "while the time-average energy approaches the budget.")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)
    report(run(device=args.device))


if __name__ == "__main__":
    main()
