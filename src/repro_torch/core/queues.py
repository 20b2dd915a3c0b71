"""Virtual energy-consumption queues (paper Sec. VI-A, eqs. (19)-(21)) —
the port of ``repro.core.queues``.

Queue stability <=> satisfaction of the long-term average energy
constraint (16); the quadratic Lyapunov function and one-slot drift are
provided for diagnostics and for the Lemma-1 constant ``C``.
"""

from __future__ import annotations

import torch

from repro_torch.core import system_model as sm


def init_queues(num_devices: int, device="cuda") -> torch.Tensor:
    """Q^0 = 0."""
    return torch.zeros((num_devices,), dtype=torch.float32, device=device)


def energy_increment(params: sm.SystemParams, h: torch.Tensor,
                     p: torch.Tensor, f: torch.Tensor, q: torch.Tensor,
                     k=None) -> torch.Tensor:
    """a_n^t = (1-(1-q)^K) E_n^t - Ebar_n — eq. (20); ``k`` is K as
    data (``system_model.effective_k``)."""
    return (sm.expected_energy(params, h, p, f, q, k=k) -
            params.energy_budget)


def update_queues(queues: torch.Tensor, increment: torch.Tensor
                  ) -> torch.Tensor:
    """Q^{t+1} = max(Q^t + a^t, 0) — eq. (19)."""
    return torch.clamp(queues + increment, min=0.0)


def lyapunov(queues: torch.Tensor) -> torch.Tensor:
    """L(t) = 1/2 sum_n Q_n^2 — eq. (21)."""
    return 0.5 * torch.sum(torch.square(queues))


def drift(queues_next: torch.Tensor, queues: torch.Tensor) -> torch.Tensor:
    """One-slot Lyapunov drift L(t+1) - L(t) — realisation of eq. (22)."""
    return lyapunov(queues_next) - lyapunov(queues)


def lemma1_constant(params: sm.SystemParams,
                    t_com_upper: torch.Tensor) -> torch.Tensor:
    """The constant C of Lemma 1 (with Tbar the upload-time upper bound).

    C = sum_n [ (Tbar p_max + E alpha c D f_max^2 / 2)^2 + Ebar^2 ].
    """
    e_cmp_max = (0.5 * params.local_epochs * params.capacitance *
                 params.cycles_per_sample * params.data_sizes *
                 torch.square(params.f_max))
    term = torch.square(t_com_upper * params.p_max + e_cmp_max)
    return torch.sum(term + torch.square(params.energy_budget))
