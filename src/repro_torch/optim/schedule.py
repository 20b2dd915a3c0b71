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


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           final_fraction: float = 0.0) -> Schedule:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a half cosine
    from ``lr`` down to ``final_fraction * lr`` at ``total_steps``, in
    float32 as the JAX package computes it."""
    f32 = np.float32

    def fn(step: int) -> float:
        step = f32(step)
        warm = f32(lr) * step / f32(max(warmup_steps, 1))
        prog = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(final_fraction * lr) + f32(
            (1 - final_fraction) * lr * 0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(warm if step < warmup_steps else cos)

    return fn
