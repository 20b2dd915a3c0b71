"""RolloutReport — the structured result of a scenario-arena run, plus
host-side reducers for the paper's Sec. VII trade-off figures: the port
of ``repro.sim.report`` (numpy reducers; params are torch tensors).

The arena returns every scenario's rollout stacked on a leading scenario
axis: params ``[S, ...]`` (torch, on the engine's device), final queues
``[S, N]`` and per-round metric arrays ``[S, T]`` (numpy; ``selected`` is
``[S, T, K_max]``, -1 in a lane's padded slots).  With an ``EvalBank``,
``final_metrics`` holds one evaluation scalar per lane (``test_accuracy``
/ ``test_loss``, ``[S]``), and ``eval_every`` adds ``test_*`` per-round
columns to ``metrics`` (a step curve holding the latest evaluation).

``meta`` records the execution shape, in the JAX package's keys:
``k_mode``, ``k_groups`` (the distinct K of the grid), ``k_max``,
``batch``, ``dispatches`` (the lane-batched segments the run executed:
1 for an unchunked ``k_mode='pad'`` run, one per distinct K for
``'group'``), ``plan`` (the ``repro_torch.sim.dispatch.DispatchPlan`` it
executed, JSON-shaped) and ``buckets`` (one entry per lane-batched
rollout: its ``lanes``, ``k_pad``, ``tiers`` — the ladder's rungs, None
for one bucket — ``dispatches`` and ``executables_built``); the
executable cache's ``executables_built`` (bucket signatures this run
ran for the first time: eager PyTorch compiles nothing, but a new
signature's first run pays the cold work, ``sim.arena``'s docstring),
``executables_cached`` (signatures run so far) and ``traces`` (this
run's new signatures); and the bank's ``bank_storage``,
``bank_nbytes``, ``bank_bytes_per_client``, ``bank_layout``
(``round_engine.bank_layout_key``) and ``tier_work`` (rows trained per
slot per round, per tier).  :meth:`RolloutReport.dispatch_accounting`
cross-checks that the per-bucket counters add up to the run's.  The
reducers turn all
of it into the curves the paper plots — cumulative latency,
loss/accuracy-vs-time, time-averaged energy against the budget,
queue-norm stability — and :meth:`tradeoff_table` aggregates seeds so a
(controller, V, lam, budget, channel, K) grid collapses to one trade-off
point per configuration, the comparison of Figs. 1-6.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.fl.environment import CHANNEL_MODES

PyTree = Any


def concat_chunk_metrics(chunks: List[Dict[str, np.ndarray]]
                         ) -> Dict[str, np.ndarray]:
    """Assemble per-chunk metric columns into full rollout columns.

    The streaming arena reduces each scan segment's outputs to host
    arrays as the next segment executes on device; every chunk
    contributes ``[S, t_c, ...]`` slices of the same metric set, and the
    full ``[S, T, ...]`` report columns are their concatenation along
    the round axis — the incremental counterpart of the monolithic
    ``np.asarray(outs)`` conversion, byte-for-byte identical because
    concatenation only places the already-exact per-chunk values."""
    if not chunks:
        raise ValueError("no metric chunks to assemble")
    if len(chunks) == 1:
        return dict(chunks[0])
    names = set(chunks[0])
    for c in chunks[1:]:
        if set(c) != names:
            raise ValueError(
                f"metric chunks disagree on columns: {sorted(names)} vs "
                f"{sorted(c)}")
    return {name: np.concatenate([c[name] for c in chunks], axis=1)
            for name in chunks[0]}


@dataclasses.dataclass
class RolloutReport:
    """Stacked results of ``Arena.run`` over an S-scenario grid."""

    grid: Any                      # the ScenarioGrid that produced this
    num_rounds: int
    params: PyTree                 # final params, torch leaves [S, ...]
    queues: np.ndarray             # final virtual queues [S, N]
    metrics: Dict[str, np.ndarray]  # [S, T] per-round ([S, T, K] selected)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    final_metrics: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)         # [S] batched final-params eval

    @property
    def num_scenarios(self) -> int:
        return len(self.grid)

    def scenario_params(self, s: int) -> PyTree:
        """Scenario ``s``'s final model (one lane of the stacked pytree)."""
        return {name: v[s] for name, v in self.params.items()}

    def take(self, idx) -> "RolloutReport":
        """Sub-report of the given scenario indices (order kept) — the
        sweep service uses this to hand each coalesced submission its
        own lanes back.  Params slice on their device (one
        ``index_select`` per leaf);
        metrics/queues/final_metrics slice on host.  ``meta`` is
        DEEP-copied (the parent's nested plan / per-bucket counter
        lists must stay immune to mutation through the child, and vice
        versa) and marked with ``split_from``.  A take of ALL lanes in
        grid order keeps the per-bucket counters — accounting still
        describes the execution exactly; a true slice clears them (the
        counters describe the coalesced execution, not the slice, so
        :meth:`dispatch_accounting` is not meaningful there)."""
        idx = np.asarray(idx, np.int64)
        meta = copy.deepcopy(self.meta)
        meta["split_from"] = self.num_scenarios
        if not np.array_equal(idx, np.arange(self.num_scenarios)):
            meta["buckets"] = []
        return RolloutReport(
            grid=self.grid.take(idx), num_rounds=self.num_rounds,
            params={name: torch.index_select(
                v, 0, torch.as_tensor(idx, device=v.device))
                for name, v in self.params.items()},
            queues=np.asarray(self.queues)[idx],
            metrics={k: v[idx] for k, v in self.metrics.items()},
            meta=meta,
            final_metrics={k: np.asarray(v)[idx]
                           for k, v in self.final_metrics.items()})

    # -- per-scenario curves ([S, T]) ---------------------------------------

    def latency_curve(self) -> np.ndarray:
        """Cumulative realised wall-clock (eq. 10) per scenario, [S, T]."""
        return np.cumsum(self.metrics["wall_time"], axis=1)

    def loss_curve(self) -> np.ndarray:
        return self.metrics["loss"]

    def queue_norm_curve(self) -> np.ndarray:
        """||Q^t||_2 per round — the stability trace behind constraint
        (16); bounded iff the time-averaged energy meets the budget."""
        return self.metrics["queue_norm"]

    def accuracy_curve(self) -> np.ndarray:
        """On-device test accuracy per round, [S, T] — a step curve
        holding the latest in-scan evaluation.  Requires the arena run
        to have been given ``eval_bank`` + ``eval_every``."""
        if "test_accuracy" not in self.metrics:
            raise KeyError(
                "no in-scan test accuracy recorded — pass eval_bank= and "
                "eval_every= to Arena.run to evaluate inside the rollout")
        return self.metrics["test_accuracy"]

    # -- per-scenario scalars ([S]) -----------------------------------------

    def total_latency(self) -> np.ndarray:
        return self.metrics["wall_time"].sum(axis=1)

    def final_loss(self) -> np.ndarray:
        return self.metrics["loss"][:, -1]

    def mean_energy(self) -> np.ndarray:
        """Time-averaged per-round mean energy of the selected sets."""
        return self.metrics["energy_mean"].mean(axis=1)

    def final_queue_norm(self) -> np.ndarray:
        return self.metrics["queue_norm"][:, -1]

    def final_accuracy(self) -> np.ndarray:
        """Final-params test accuracy per scenario, [S] (the batched
        on-device evaluation — requires ``eval_bank``)."""
        if "test_accuracy" not in self.final_metrics:
            raise KeyError(
                "no final test accuracy recorded — pass eval_bank= to "
                "Arena.run to evaluate the final params on device")
        return self.final_metrics["test_accuracy"]

    def dispatch_accounting(self) -> Dict[str, int]:
        """Summed per-bucket execution counters, cross-checked against
        the run totals: ``meta['buckets']`` entries are per lane-batched
        rollout and ADDITIVE, so ``sum(bucket dispatches) ==
        meta['dispatches']`` and ``sum(bucket executables_built) ==
        meta['executables_built']`` in every k_mode, and the buckets'
        lanes partition the grid.  Raises ``ValueError`` when a mode breaks the
        sum (a bucket counted twice or dropped), returns the sums plus
        lane coverage otherwise."""
        buckets = self.meta.get("buckets")
        if not buckets:
            raise KeyError("meta carries no per-bucket counters — was "
                           "this report produced by Arena.run?")
        sums = dict(
            dispatches=sum(int(b["dispatches"]) for b in buckets),
            executables_built=sum(int(b["executables_built"])
                                  for b in buckets),
            buckets=len(buckets),
            lanes_covered=sum(len(b["lanes"]) for b in buckets))
        for field in ("dispatches", "executables_built"):
            if sums[field] != int(self.meta[field]):
                raise ValueError(
                    f"per-bucket {field} sum to {sums[field]} but "
                    f"meta[{field!r}] records {self.meta[field]} — the "
                    f"additive accounting contract is broken")
        lanes = sorted(i for b in buckets for i in b["lanes"])
        if lanes != list(range(self.num_scenarios)):
            raise ValueError(
                f"bucket lanes {lanes} do not partition the "
                f"{self.num_scenarios} grid lanes")
        return sums

    def selection_counts(self, num_devices: int) -> np.ndarray:
        """How often each client was drawn, [S, N] (padding ignored)."""
        sel = self.metrics["selected"]
        out = np.zeros((sel.shape[0], num_devices), np.int64)
        for s in range(sel.shape[0]):
            ids, counts = np.unique(sel[s][sel[s] >= 0], return_counts=True)
            out[s, ids.astype(np.int64)] = counts
        return out

    # -- cross-seed aggregation ---------------------------------------------

    def summary(self) -> List[dict]:
        """One plain dict per scenario (grid coordinates + reduced
        metrics) — the rows behind :meth:`tradeoff_table`."""
        g = self.grid
        names = g.controller_names()
        tot = self.total_latency()
        loss = self.final_loss()
        energy = self.mean_energy()
        qnorm = self.final_queue_norm()
        rows = [dict(controller=names[s], seed=int(g.seed[s]),
                     V=float(g.V[s]), lam=float(g.lam[s]),
                     energy_scale=float(g.energy_scale[s]),
                     mean_gain=float(g.mean_gain[s]),
                     sample_count=int(g.sample_count[s]),
                     chan_mode=CHANNEL_MODES[int(g.chan_mode[s])],
                     dropout=float(g.dropout[s]),
                     total_latency=float(tot[s]),
                     final_loss=float(loss[s]),
                     mean_energy=float(energy[s]),
                     final_queue_norm=float(qnorm[s]))
                for s in range(len(g))]
        for name, vals in self.final_metrics.items():
            for s, row in enumerate(rows):
                row[name] = float(vals[s])
        return rows

    def tradeoff_table(self) -> List[dict]:
        """Seed-aggregated trade-off points, one per distinct
        (controller, V, lam, energy_scale, mean_gain, K, channel mode,
        dropout) configuration —
        mean/std of total latency, final loss, and time-averaged energy
        across that configuration's seeds.  Sorted by (controller, V), so
        a V (resp. lambda / budget) sweep reads off as the paper's
        latency-energy (resp. latency-accuracy) trade-off curve.
        """
        rows = self.summary()
        groups: Dict[tuple, List[dict]] = {}
        for r in rows:
            key = (r["controller"], r["V"], r["lam"], r["energy_scale"],
                   r["mean_gain"], r["sample_count"], r["chan_mode"],
                   r["dropout"])
            groups.setdefault(key, []).append(r)
        fields = ["total_latency", "final_loss", "mean_energy",
                  "final_queue_norm"] + sorted(self.final_metrics)
        table = []
        for key in sorted(groups):
            rs = groups[key]
            ctrl, v, lam, escale, gain, k, mode, drop = key
            agg = dict(controller=ctrl, V=v, lam=lam, energy_scale=escale,
                       mean_gain=gain, sample_count=k, chan_mode=mode,
                       dropout=drop, num_seeds=len(rs))
            for field in fields:
                vals = np.asarray([r[field] for r in rs])
                agg[field] = float(vals.mean())
                agg[field + "_std"] = float(vals.std())
            table.append(agg)
        return table
