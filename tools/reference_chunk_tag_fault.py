"""Reproduce, on the CPU, a fault of the JAX package's chunk checkpoints:
``repro.sim.Arena._chunk_tag`` leaves the learning-rate schedule out of
the tag, so a killed sweep resubmitted with another schedule into the
same checkpoint directory resumes from a carry made under the old one.

A ``repro.sim.SweepService`` (chunks of 2, T = 6, four lanes at N = 6,
an MLP) is killed at its first checkpoint under schedule A, then a fresh
service in the same directory runs the grid under schedule B.  The
script prints, as one JSON line, whether the second run resumed
(``store.loads``), and its largest parameter distance from an
uninterrupted run under A and under B: a resumed run is neither.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/reference_chunk_tag_fault.py
"""

import json
import tempfile

import jax
import numpy as np

from repro.core import paper_default_params
from repro.data import synthetic_image_classification
from repro.fl import ClientConfig, RoundEngine
from repro.models import MLPTask
from repro.sim import Arena, ScenarioGrid, SweepService

N, T = 6, 6


class _Kill(Exception):
    pass


def main() -> int:
    x, y = synthetic_image_classification(N * 40, (8, 8, 1), 4, noise=0.3,
                                          seed=3)
    clients = [(x[i * 40:(i + 1) * 40], y[i * 40:(i + 1) * 40])
               for i in range(N)]
    task = MLPTask(input_dim=64, num_classes=4, hidden=8)
    eng = RoundEngine(task, ClientConfig(local_epochs=2, batch_size=8))
    bank = eng.make_bank(clients, "single")
    sp = paper_default_params(num_devices=N, sample_count=3)
    params0 = task.init(jax.random.PRNGKey(0))
    grid = ScenarioGrid.create(["lroa", "uni_d", "uni_s", "round_robin"],
                               seeds=[1, 2, 3, 4], V=100.0, lam=0.5,
                               sample_count=3)
    lr_a = np.full(T, 0.1, np.float32)
    lr_b = np.full(T, 0.01, np.float32)

    def uninterrupted(lr):
        return Arena(eng).run(params0, sp, bank, grid, T, lr).params

    with tempfile.TemporaryDirectory() as ckdir:
        first = SweepService(Arena(eng, chunk_size=2), params0, sp, bank,
                             checkpoint_dir=ckdir)
        save = first.store.save

        def killing_save(*args):
            save(*args)
            raise _Kill()
        first.store.save = killing_save
        first.submit(grid, T, lr_a)
        try:
            first.run_pending()
        except _Kill:
            pass
        second = SweepService(Arena(eng, chunk_size=2), params0, sp, bank,
                              checkpoint_dir=ckdir)
        ticket = second.submit(grid, T, lr_b)
        second.run_pending()
        resumed = second.result(ticket).params
        loads = second.store.loads

    def dist(a, b):
        return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
                   for k in a)

    print(json.dumps({
        "resumed_from_schedule_a_checkpoint": loads == 1,
        "store_loads": loads,
        "param_max_abs_diff_vs_uninterrupted_b": dist(resumed,
                                                      uninterrupted(lr_b)),
        "param_max_abs_diff_vs_uninterrupted_a": dist(resumed,
                                                      uninterrupted(lr_a)),
        "jax": jax.__version__, "platform": jax.default_backend()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
