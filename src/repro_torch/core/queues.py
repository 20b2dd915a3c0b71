"""Virtual energy-consumption queues (paper Sec. VI-A, eqs. (19)-(21)) —
the port of ``repro.core.queues``.

Queue stability <=> satisfaction of the long-term average energy
constraint (16).
"""

from __future__ import annotations

import torch

from repro_torch.core import system_model as sm


def init_queues(num_devices: int, device="cuda") -> torch.Tensor:
    """Q^0 = 0."""
    return torch.zeros((num_devices,), dtype=torch.float32, device=device)


def energy_increment(params: sm.SystemParams, h: torch.Tensor,
                     p: torch.Tensor, f: torch.Tensor,
                     q: torch.Tensor) -> torch.Tensor:
    """a_n^t = (1-(1-q)^K) E_n^t - Ebar_n — eq. (20)."""
    return sm.expected_energy(params, h, p, f, q) - params.energy_budget


def update_queues(queues: torch.Tensor, increment: torch.Tensor
                  ) -> torch.Tensor:
    """Q^{t+1} = max(Q^t + a^t, 0) — eq. (19)."""
    return torch.clamp(queues + increment, min=0.0)

