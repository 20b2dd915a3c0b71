"""Per-round decision rules as pure functions of ``(params, h, queues, V,
lam)`` — the port of ``repro.core.policy``.

This slice ports the LROA rule only (Algorithm 2); the other rules of the
JAX package's controller zoo (uni_d, uni_s, channel_aware, cost_effective,
round_robin, divfl) are later work (ROADMAP queue A).
"""

from __future__ import annotations

import torch

from repro_torch.core import solver as slv
from repro_torch.core import system_model as sm


def decide_lroa(params: sm.SystemParams, h: torch.Tensor,
                queues: torch.Tensor, V: float, lam: float,
                cfg: slv.SolverConfig = slv.SolverConfig()
                ) -> slv.ControlDecision:
    """LROA: the full Algorithm-2 drift-plus-penalty solve."""
    return slv.solve_p2(params, h, queues, V, lam, cfg)
