"""Learning-rate schedules (pure functions of the round index) — the port
of ``repro.optim.schedule``.  Values are rounded to float32, as the JAX
package's schedules compute them."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(np.float32(lr))


def step_decay(lr: float, boundaries: Sequence[int],
               factor: float) -> Schedule:
    bounds = np.asarray(list(boundaries), np.int64)

    def fn(step: int) -> float:
        n = np.float32(np.sum(int(step) >= bounds))
        return float(np.float32(lr) * np.float32(factor) ** n)

    return fn


def paper_step_decay(lr: float, total_rounds: int) -> Schedule:
    """The paper's schedule: halve at 50% and 75% of total rounds."""
    return step_decay(lr, [int(0.5 * total_rounds),
                           int(0.75 * total_rounds)], 0.5)
