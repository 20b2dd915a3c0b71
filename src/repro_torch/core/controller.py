"""LROA controller — the paper's online control policy as a reusable
object; the port of ``repro.core.controller``.

Per round:  observe channel gains ``h^t``  ->  ``decide`` (Algorithm 2 /
``solver.solve_p2``)  ->  run the FL round  ->  ``step_queues``.

Hyper-parameter initialisation follows Sec. VII-B:

  lambda_0 = T_0 / F_0     with T_0 the mid-range per-round latency estimate
                           and F_0 a loss-scale estimate (q = w),
  V_0      = a_0^2 / (T_0 + lambda * F_0)   with a_0 the energy-residual
                           estimate from eq. (20) at the mid-range operating
                           point (Q_0 = a_0),
  lambda = mu * lambda_0,  V = nu * V_0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import policy as pol
from repro_torch.core import queues as vq
from repro_torch.core import solver as slv
from repro_torch.core import system_model as sm


@dataclasses.dataclass
class LROAHyperParams:
    lam: float
    V: float
    lam0: float
    V0: float
    mu: float
    nu: float


def estimate_hyperparams_arrays(params: sm.SystemParams, mean_gain,
                                loss_scale=1.0, mu=1.0, nu=1e5
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor, torch.Tensor]:
    """The Sec. VII-B estimates ``(lam, V, lam0, V0)`` as float32 scalar
    tensors on the params' device; ``mean_gain``, ``loss_scale``, ``mu``
    and ``nu`` may be numbers or scalar tensors."""
    dev = params.device
    f_mid = 0.5 * (params.f_min + params.f_max)
    p_mid = 0.5 * (params.p_min + params.p_max)
    h = torch.as_tensor(mean_gain, dtype=torch.float32, device=dev).expand(
        params.num_devices)
    t0 = torch.sum(params.data_weights *
                   sm.round_time(params, h, p_mid, f_mid))
    f0 = torch.as_tensor(loss_scale, dtype=torch.float32, device=dev)
    lam0 = t0 / torch.clamp(f0, min=1e-12)
    lam = mu * lam0
    q_w = params.data_weights
    e0 = sm.round_energy(params, h, p_mid, f_mid)
    a0 = torch.mean(torch.abs(
        sm.selection_probability(q_w, params.sample_count) * e0
        - params.energy_budget))
    v0 = torch.square(a0) / torch.clamp(t0 + lam * f0, min=1e-12)
    return lam, nu * v0, lam0, v0


def estimate_hyperparams(params: sm.SystemParams, mean_gain: float,
                         loss_scale: float = 1.0, mu: float = 1.0,
                         nu: float = 1e5) -> LROAHyperParams:
    """lambda_0 = T_0/F_0 and V_0 = a_0^2/(T_0 + lambda F_0) (Sec. VII-B),
    computed in float32 on the params' device, returned as floats."""
    lam, v, lam0, v0 = estimate_hyperparams_arrays(
        params, mean_gain, loss_scale=loss_scale, mu=mu, nu=nu)
    return LROAHyperParams(lam=float(lam), V=float(v), lam0=float(lam0),
                           V0=float(v0), mu=mu, nu=nu)


class QueueTracker:
    """The state every controller carries for the host loop: the virtual
    energy queues (a ``[N]`` tensor on the params' device), the
    hyper-parameters and a history of round statistics."""

    def __init__(self, params: sm.SystemParams,
                 hp: Optional[LROAHyperParams]):
        self.params = params
        self.hp = hp
        self.queues = vq.init_queues(params.num_devices, params.device)
        self.history: list[dict] = []

    def step_queues(self, h: torch.Tensor,
                    decision: slv.ControlDecision) -> torch.Tensor:
        inc = vq.energy_increment(self.params, h, decision.p, decision.f,
                                  decision.q)
        self.queues = vq.update_queues(self.queues, inc)
        return self.queues


class LROAController(QueueTracker):
    """Stateful wrapper: virtual queues + Algorithm 2 decisions; the
    decision rule itself is :func:`repro_torch.core.policy.decide_lroa`.
    """

    name = "lroa"

    def __init__(self, params: sm.SystemParams, hp: LROAHyperParams,
                 cfg: slv.SolverConfig = slv.SolverConfig()):
        super().__init__(params, hp)
        self.cfg = cfg

    def decide(self, h: torch.Tensor) -> slv.ControlDecision:
        return pol.decide_lroa(self.params, h, self.queues,
                               self.hp.V, self.hp.lam, self.cfg)

    def round_stats(self, h: torch.Tensor,
                    decision: slv.ControlDecision) -> dict:
        """The round's expected latency (eq. 11), P2's penalty term,
        expected energy and queue summary, appended to ``history``."""
        f, p, q = decision
        t = sm.round_time(self.params, h, p, f)
        e = sm.expected_energy(self.params, h, p, f, q)
        w = self.params.data_weights
        obj = float(torch.sum(q * t + self.hp.lam * torch.square(w) / q))
        stats = dict(
            expected_latency=float(sm.expected_round_latency(q, t)),
            objective=obj,
            expected_energy=float(torch.mean(e)),
            queue_mean=float(torch.mean(self.queues)),
            queue_max=float(torch.max(self.queues)),
        )
        self.history.append(stats)
        return stats


def realized_round_time(params: sm.SystemParams, h: torch.Tensor,
                        decision: slv.ControlDecision,
                        selected: np.ndarray) -> float:
    """Wall-clock time of a round = max over the realised selected set
    (eq. 10)."""
    t = sm.round_time(params, h, decision.p, decision.f)
    uniq = torch.as_tensor(np.unique(np.asarray(selected)), device=t.device)
    return float(torch.max(t[uniq]))


def realized_energy(params: sm.SystemParams, h: torch.Tensor,
                    decision: slv.ControlDecision,
                    selected: np.ndarray) -> np.ndarray:
    """Per-device energy actually drawn this round (selected devices
    only), on the host."""
    e = sm.round_energy(params, h, decision.p, decision.f).cpu().numpy()
    out = np.zeros_like(e)
    uniq = np.unique(np.asarray(selected))
    out[uniq] = e[uniq]
    return out
