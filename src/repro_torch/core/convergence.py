"""Theorem 1 — convergence bound for FedAvg with arbitrary sampling
probabilities under non-convex losses and non-IID data; the port of
``repro.core.convergence``.

    (1/T) sum_t E||grad F(theta^t)||^2
      <= 4 (F(theta^0) - F*) / (eta T E)
       + 8 eta^2 beta^2 E^2 kappa^2
       + (2 beta eta E G^2 / (K T)) sum_t sum_n w_n^2 / q_n^t

The third term is the *sampling error* that LROA's lambda * w_n^2 / q_n
penalty controls; ``sampling_error_term`` exposes it directly.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class BoundConstants:
    beta: float          # smoothness (Assumption 1)
    G: float             # gradient bound (Assumption 2)
    gamma: float         # dissimilarity multiplier (Assumption 3)
    kappa: float         # dissimilarity offset (Assumption 3)
    f0_minus_fstar: float


def max_learning_rate(c: BoundConstants, local_epochs: int) -> float:
    """eta <= min{1/(32 E^2 beta^2 gamma^2), 1/(2 sqrt(2) E beta)}."""
    e = float(local_epochs)
    return min(1.0 / (32.0 * e ** 2 * c.beta ** 2 * c.gamma ** 2),
               1.0 / (2.0 * math.sqrt(2.0) * e * c.beta))


def sampling_error_term(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """sum_n w_n^2 / q_n — per-round sampling penalty (minimised at q = w)."""
    return torch.sum(torch.square(w) / q)


def convergence_bound(c: BoundConstants, eta: float, local_epochs: int,
                      sample_count: int, num_rounds: int,
                      w: torch.Tensor, q_per_round: torch.Tensor
                      ) -> torch.Tensor:
    """Evaluate the RHS of (18). ``q_per_round``: [T, N]."""
    e = float(local_epochs)
    t = float(num_rounds)
    term1 = 4.0 * c.f0_minus_fstar / (eta * t * e)
    term2 = 8.0 * eta ** 2 * c.beta ** 2 * e ** 2 * c.kappa ** 2
    sampling = torch.sum(torch.square(w)[None, :] / q_per_round) / t
    term3 = (2.0 * c.beta * eta * e * c.G ** 2 / sample_count) * sampling
    return term1 + term2 + term3
