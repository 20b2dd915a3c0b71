"""Baseline controllers from the paper's evaluation (Sec. VII-A) — the
port of ``repro.core.baselines``:

* **Uni-D** — uniform sampling (q = 1/N) + LROA's dynamic (f, p) from the
  P2.1 closed forms.
* **Uni-S** — uniform sampling + static resources: p mid-range, f chosen so
  the expected per-round energy exactly meets the budget (projected to the
  feasible box when the balance equation has no interior root).
* **DivFL** — diverse client selection by greedy facility-location
  maximisation over client dissimilarity, with Uni-S's resource policy.

Every controller has ``LROAController``'s interface: ``decide(h) ->
ControlDecision`` and ``step_queues`` (the queues are tracked for
reporting, though the baselines decide without them).  The decision
rules are the pure functions of ``repro_torch.core.policy``, so
``RoundEngine.run_scan`` and the host loop run the same arithmetic.
DivFL's greedy runs on the host here (:func:`facility_location_greedy`,
numpy), the same loop as ``policy.facility_location_select`` on the
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import policy as pol
from repro_torch.core import solver as slv
from repro_torch.core import system_model as sm
from repro_torch.core.controller import LROAHyperParams, QueueTracker


class UniformDynamicController(QueueTracker):
    """Uni-D: q = 1/N; (f, p) from Theorems 2/3 under the uniform q."""

    name = "uni_d"

    def __init__(self, params: sm.SystemParams, hp: LROAHyperParams,
                 cfg: slv.SolverConfig = slv.SolverConfig()):
        super().__init__(params, hp)
        self.cfg = cfg

    def decide(self, h: torch.Tensor) -> slv.ControlDecision:
        return pol.decide_uni_d(self.params, h, self.queues, self.hp.V,
                                self.hp.lam, self.cfg)


class UniformStaticController(QueueTracker):
    """Uni-S: q = 1/N, p mid-range, f from the energy-balance equation."""

    name = "uni_s"

    def __init__(self, params: sm.SystemParams,
                 hp: Optional[LROAHyperParams] = None, **_):
        super().__init__(params, hp)

    def decide(self, h: torch.Tensor) -> slv.ControlDecision:
        return pol.decide_uni_s(self.params, h, self.queues, 0.0, 0.0)


def facility_location_greedy(similarity: np.ndarray, k: int) -> np.ndarray:
    """Greedy maximisation of G(S) = sum_i max_{j in S} sim[i, j].

    DivFL's diverse-subset selection; O(N^2 k), a 1-1/e approximation by
    submodularity.  Gains accumulate in the similarity's own dtype, row
    by row (numpy's order for an axis-0 sum), and argmax breaks ties
    low-index: the sums and picks of ``policy.facility_location_select``
    on the device, bit for bit.
    """
    n = similarity.shape[0]
    best = np.full((n,), -np.inf, similarity.dtype)
    chosen: list[int] = []
    for _ in range(k):
        # marginal gain of adding j: sum_i max(best_i, sim[i, j]) - sum best
        gains = np.maximum(best[:, None], similarity).sum(axis=0)
        gains[chosen] = -np.inf
        j = int(np.argmax(gains))
        chosen.append(j)
        best = np.maximum(best, similarity[:, j])
    return np.asarray(chosen, np.int64)


class DivFLController(QueueTracker):
    """DivFL: greedy diverse selection + Uni-S resource policy.

    Similarity is measured on the latest local updates recorded by
    :meth:`observe_updates` when there are any; otherwise on the
    ``(data weight, channel gain)`` feature gram of
    ``policy.divfl_features`` / ``divfl_similarity``, the one the device
    rule uses; with neither, slots take clients ``arange(K) % N``.
    """

    name = "divfl"

    def __init__(self, params: sm.SystemParams,
                 hp: Optional[LROAHyperParams] = None, **_):
        super().__init__(params, hp)
        self._update_bank: Optional[np.ndarray] = None  # [N, proj_dim]

    def observe_updates(self, client_ids: np.ndarray,
                        flat_updates: np.ndarray) -> None:
        """Record (projected) local updates to drive the similarity."""
        if self._update_bank is None:
            self._update_bank = np.zeros(
                (self.params.num_devices, flat_updates.shape[-1]),
                np.float32)
        self._update_bank[np.asarray(client_ids)] = flat_updates

    def select(self, h: Optional[torch.Tensor] = None) -> np.ndarray:
        k = self.params.sample_count
        n = self.params.num_devices
        if self._update_bank is not None and np.any(self._update_bank):
            g = self._update_bank
            norms = np.linalg.norm(g, axis=1, keepdims=True)
            gn = g / np.maximum(norms, 1e-12)
            similarity = gn @ gn.T
        elif h is not None:
            h = torch.as_tensor(h, dtype=torch.float32,
                                device=self.params.device)
            similarity = pol.divfl_similarity(pol.divfl_features(
                self.params, h)).cpu().numpy()
        else:
            return np.arange(k) % n
        return facility_location_greedy(similarity, k)

    def decide(self, h: torch.Tensor) -> slv.ControlDecision:
        # the selection is deterministic; q is the uniform 1/N that the
        # eq.-(4) coefficients and the queue drift read
        return pol.decide_divfl(self.params, h, self.queues, 0.0, 0.0)
