"""Shape-adaptive dispatch planning for the ScenarioArena — a copy of
``repro.sim.dispatch`` (numpy only; its trace calls go to the port's
``obs.trace``).  The port's arena builds :meth:`DispatchPlan.padded` and
:meth:`DispatchPlan.grouped` for ``k_mode='pad'`` / ``'group'`` and
:func:`plan_dispatch` for ``'auto'`` (by K alone, so
:func:`lane_footprints` has no caller there; ``Arena.warmup`` plans at
``runs=math.inf`` and passes ``is_cached``).

``Arena.run`` used to offer exactly two executions of an S-lane grid:
``k_mode='pad'`` (ONE executable, every lane padded to ``K_max`` slots
and compiled against EVERY bank tier) and ``k_mode='group'`` (one
executable per distinct K, each lane at its native width).  Both are
cost-blind extremes: pad wastes steady-state FLOPs on padded slots and
never-hit tier bodies (the tiered scan-skip win evaporates under vmap,
where ``lax.cond`` lowers to ``select``), group pays one compile chain
per shape on every cold workflow.  This module is the TieredClientBank
trick applied to the SCENARIO axis: bucket the lanes by shape signature
``(K, tier footprint)`` into a small ladder of executables, sized by the
:class:`~repro_torch.sim.cost_model.CostModel` under a ``max_executables``
knob.

The planner's contract, relied on by the arena and the tests:

* **Degenerate extremes are reachable** — :meth:`DispatchPlan.padded`
  is the single-bucket pad program, :meth:`DispatchPlan.grouped` the
  per-K ladder; ``plan_dispatch(..., max_executables=1)`` always
  collapses to the padded plan.
* **Deterministic** — buckets are ordered by ``(k_pad, tiers)`` and
  lane order inside a bucket preserves grid order, so the lane
  permutation (and therefore every stitched ``RolloutReport`` array) is
  a pure function of the grid + plan inputs.
* **Bitwise-safe merges** — a merge only ever RAISES a lane's ``k_pad``
  (padded slots are provably inert: see ``test_arena``'s pad-vs-group
  equivalence) and only ever WIDENS its tier subset (a tier a lane
  never hits contributes exactly-zero masked updates).  Any plan the
  optimiser emits therefore reproduces the per-lane ``run_scan``
  trajectory; the cost model decides speed, never results.

Planning is host-side numpy over at most a handful of signatures —
microseconds against the seconds-scale executables it arranges.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import trace as obs
from repro_torch.sim.cost_model import CostModel

__all__ = ["DispatchBucket", "DispatchPlan", "plan_dispatch",
           "lane_footprints"]


@dataclasses.dataclass(frozen=True)
class DispatchBucket:
    """One executable's worth of lanes: the lanes it serves (grid
    order), the K they are all padded to, and the static tier subset its
    scan body is compiled against (``None`` = all bank tiers)."""

    lanes: Tuple[int, ...]
    k_pad: int
    tiers: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if not self.lanes:
            raise ValueError("DispatchBucket needs at least one lane")
        if self.k_pad < 1:
            raise ValueError(f"k_pad must be >= 1, got {self.k_pad}")
        if self.tiers is not None and len(self.tiers) == 0:
            raise ValueError("tier subset cannot be empty — a lane always "
                             "hits at least one tier")

    @property
    def num_lanes(self) -> int:
        return len(self.lanes)


@dataclasses.dataclass(frozen=True)
class DispatchPlan:
    """Lane → bucket assignment for one arena grid.

    ``buckets`` partition ``range(num_lanes)``; :meth:`permutation` is
    the bucket-concatenation order (the order lanes leave the device)
    and :meth:`inverse_permutation` restores grid order, so
    ``stitched[inverse_permutation()] == grid order`` for any per-lane
    stacked array.
    """

    buckets: Tuple[DispatchBucket, ...]
    num_lanes: int

    def __post_init__(self):
        seen = sorted(i for b in self.buckets for i in b.lanes)
        if seen != list(range(self.num_lanes)):
            raise ValueError(
                f"buckets must partition the {self.num_lanes} lanes; "
                f"got lane multiset {seen}")

    # -- construction -------------------------------------------------------

    @classmethod
    def padded(cls, sample_counts: Sequence[int],
               tiers: Optional[Tuple[int, ...]] = None) -> "DispatchPlan":
        """The ``k_mode='pad'`` degenerate case: one bucket, all lanes,
        ``k_pad = max(K)``, full tier set."""
        ks = np.asarray(sample_counts, dtype=np.int64)
        return cls(buckets=(DispatchBucket(
            lanes=tuple(range(ks.size)), k_pad=int(ks.max()), tiers=tiers),),
            num_lanes=int(ks.size))

    @classmethod
    def grouped(cls, sample_counts: Sequence[int],
                tiers: Optional[Tuple[int, ...]] = None) -> "DispatchPlan":
        """The ``k_mode='group'`` degenerate case: one bucket per
        distinct K (ascending, matching ``np.unique``), full tier set."""
        ks = np.asarray(sample_counts, dtype=np.int64)
        buckets = tuple(
            DispatchBucket(lanes=tuple(int(i) for i in
                                       np.flatnonzero(ks == k)),
                           k_pad=int(k), tiers=tiers)
            for k in np.unique(ks))
        return cls(buckets=buckets, num_lanes=int(ks.size))

    # -- lane bookkeeping ---------------------------------------------------

    def permutation(self) -> np.ndarray:
        """Grid-order lane ids in device (bucket-concatenation) order."""
        return np.asarray([i for b in self.buckets for i in b.lanes],
                          dtype=np.int64)

    def inverse_permutation(self) -> np.ndarray:
        """Device-order → grid-order gather indices: for grid lane ``s``,
        ``inv[s]`` is its row in the concatenated bucket outputs."""
        perm = self.permutation()
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size, dtype=np.int64)
        return inv

    def bucket_of(self) -> np.ndarray:
        """Bucket index per grid lane, ``[S]``."""
        out = np.empty(self.num_lanes, dtype=np.int64)
        for j, b in enumerate(self.buckets):
            out[list(b.lanes)] = j
        return out

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def k_max(self) -> int:
        return max(b.k_pad for b in self.buckets)

    def describe(self) -> List[dict]:
        """JSON-serialisable plan summary (lands in report meta and the
        bench record)."""
        return [dict(lanes=list(b.lanes), k_pad=b.k_pad,
                     tiers=None if b.tiers is None else list(b.tiers))
                for b in self.buckets]


# -- footprints --------------------------------------------------------------

def lane_footprints(selected: np.ndarray,
                    tier_of: np.ndarray) -> List[Tuple[int, ...]]:
    """Per-lane tier footprints from a ``[S, T, K]`` selection replay.

    ``selected`` is the control-plane probe's selection trace (padding
    slots hold -1 or repeats of slot 0 — both map to real clients, which
    is fine: padded slots gather real rows, so their tiers are genuinely
    touched by the padded executable) and ``tier_of`` the bank's host
    client → tier map.  Returns a sorted tier tuple per lane.
    """
    sel = np.asarray(selected)
    tier_of = np.asarray(tier_of)
    out: List[Tuple[int, ...]] = []
    for s in range(sel.shape[0]):
        ids = sel[s][sel[s] >= 0]
        out.append(tuple(sorted(np.unique(tier_of[ids]).tolist())))
    return out


# -- the planner -------------------------------------------------------------

def _merge(a: DispatchBucket, b: DispatchBucket) -> DispatchBucket:
    lanes = tuple(sorted(a.lanes + b.lanes))
    if a.tiers is None or b.tiers is None:
        tiers = None
    else:
        tiers = tuple(sorted(set(a.tiers) | set(b.tiers)))
    return DispatchBucket(lanes=lanes, k_pad=max(a.k_pad, b.k_pad),
                          tiers=tiers)


def plan_dispatch(sample_counts: Sequence[int], *, rounds: int,
                  tier_work: Optional[Dict[int, float]] = None,
                  footprints: Optional[Sequence[Tuple[int, ...]]] = None,
                  cost_model: Optional[CostModel] = None,
                  max_executables: int = 4,
                  is_cached: Optional[Callable[[DispatchBucket],
                                               bool]] = None,
                  runs: float = 1.0) -> DispatchPlan:
    """Choose a :class:`DispatchPlan` for one arena grid.

    Parameters
    ----------
    sample_counts:
        Per-lane K, grid order (``grid.sample_count``).
    rounds:
        Rollout length T (scales the work term against compile).
    tier_work:
        ``{tier id: bucket rows per slot per round}`` (the bank's
        ``steps_per_epoch * batch_size`` per tier, times local epochs).
        ``None`` = single-tier bank with unit work: plans then reduce to
        pure K-bucketing.
    footprints:
        Per-lane sorted tier tuples (see :func:`lane_footprints`).
        ``None`` = every lane hits every tier.
    cost_model:
        Prices; defaults to the tracked-record calibration.
    max_executables:
        Hard cap on buckets; ``1`` always yields the padded plan.
    is_cached:
        Predicate telling the planner a bucket's executable is already
        compiled (the arena passes a probe of its executable cache);
        cached buckets pay no amortised compile.
    runs:
        Planning horizon — how many times this plan's executables will
        be reused.  ``1.0`` (a one-shot cold run) makes compile dominate
        and plans collapse toward pad; ``math.inf`` (``Arena.warmup``'s
        steady-state horizon) makes padding waste dominate and plans
        split by signature.

    The optimiser is exact where it can be and greedy where it must:
    start from one bucket per distinct ``(K, footprint)`` signature
    (the finest bitwise-safe partition), then greedily apply the
    cheapest pairwise merge while over ``max_executables``, and keep
    merging while the best merge strictly lowers the modelled cost.
    With a handful of signatures this explores the whole merge lattice
    that matters; it is deterministic for fixed inputs.
    """
    ks = np.asarray(sample_counts, dtype=np.int64)
    if ks.ndim != 1 or ks.size == 0:
        raise ValueError(f"sample_counts must be a non-empty 1-D sequence, "
                         f"got shape {ks.shape}")
    if max_executables < 1:
        raise ValueError(f"max_executables must be >= 1, "
                         f"got {max_executables}")
    if footprints is not None and len(footprints) != ks.size:
        raise ValueError(f"footprints has {len(footprints)} entries for "
                         f"{ks.size} lanes")
    cm = cost_model if cost_model is not None else CostModel()
    all_tiers = (None if tier_work is None
                 else tuple(sorted(tier_work)))

    def norm_fp(fp) -> Optional[Tuple[int, ...]]:
        if tier_work is None:
            return None
        fp = tuple(sorted(fp))
        if not fp:
            raise ValueError("a lane's tier footprint cannot be empty")
        unknown = set(fp) - set(all_tiers)
        if unknown:
            raise ValueError(f"footprint names unknown tiers {unknown}; "
                             f"tier_work covers {all_tiers}")
        return fp

    # finest bitwise-safe partition: one bucket per (K, footprint)
    sig_lanes: Dict[Hashable, List[int]] = {}
    for s in range(ks.size):
        fp = norm_fp(footprints[s]) if footprints is not None else all_tiers
        sig_lanes.setdefault((int(ks[s]), fp), []).append(s)
    buckets = [DispatchBucket(lanes=tuple(lanes), k_pad=k, tiers=fp)
               for (k, fp), lanes in sorted(
                   sig_lanes.items(),
                   key=lambda kv: (kv[0][0], kv[0][1] or ()))]

    def work(b: DispatchBucket) -> float:
        if tier_work is None:
            return 1.0
        tiers = b.tiers if b.tiers is not None else all_tiers
        return float(sum(tier_work[t] for t in tiers))

    def cost(b: DispatchBucket) -> float:
        cached = bool(is_cached(b)) if is_cached is not None else False
        return cm.bucket_seconds(b.num_lanes, rounds, b.k_pad, work(b),
                                 cached=cached, runs=runs)

    def best_merge(bs: List[DispatchBucket]
                   ) -> Tuple[float, int, int, DispatchBucket]:
        best = None
        for i in range(len(bs)):
            for j in range(i + 1, len(bs)):
                m = _merge(bs[i], bs[j])
                delta = cost(m) - cost(bs[i]) - cost(bs[j])
                # deterministic tie-break: lowest delta, then smallest
                # merged signature
                key = (delta, m.k_pad, m.tiers or ())
                if best is None or key < best[0]:
                    best = (key, i, j, m)
        assert best is not None
        return (best[0][0], best[1], best[2], best[3])

    # phase 1: enforce the executable cap
    while len(buckets) > max_executables:
        _, i, j, m = best_merge(buckets)
        buckets = [b for idx, b in enumerate(buckets)
                   if idx not in (i, j)] + [m]
    # phase 2: keep merging while it strictly pays
    while len(buckets) > 1:
        delta, i, j, m = best_merge(buckets)
        if not delta < 0.0:
            break
        buckets = [b for idx, b in enumerate(buckets)
                   if idx not in (i, j)] + [m]

    buckets.sort(key=lambda b: (b.k_pad, b.tiers or ()))
    plan = DispatchPlan(buckets=tuple(buckets), num_lanes=int(ks.size))
    # flight-recorder breadcrumb: the planner's verdict with the inputs
    # that shaped it (no-op without a sink) — regressions in bucketing
    # show up in the span log next to the dispatches they caused
    obs.event("plan.decision", lanes=int(ks.size), rounds=int(rounds),
              runs=(-1.0 if math.isinf(runs) else float(runs)),
              buckets=plan.num_buckets,
              k_pads=[int(b.k_pad) for b in plan.buckets])
    return plan
