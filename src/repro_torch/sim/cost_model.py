"""Dispatch cost model — the seconds-denominated price list the arena's
shape-adaptive planner (``repro_torch.sim.dispatch``) optimises over: a
copy of ``repro.sim.cost_model``, with ``CostModel.calibrate`` ported
(a timed probe of the port's engine on its device) and one price the
JAX package does not need, ``round_cost``: the port runs a bucket's
rounds from the host, and each round pays the control plane, the tier
routing's read-back and one SGD call per hit tier whatever the bucket's
slots (0 by default, the JAX package's prices).

The ScenarioArena can execute a grid as anywhere between ONE padded
executable (every lane trains ``K_max`` slots over every tier body —
minimal compile, maximal steady-state padding waste) and one executable
per distinct lane shape (zero padding waste, one compile chain per
shape).  Neither extreme is right in general; the tracked bench record
(``BENCH_round_engine.json``, ``arena.mixed_k``) measures the padded
program at ~0.56x the grouped steady-state throughput but ~2.9x its
cold-workflow throughput at the recorded K-skewed operating point.  The
planner therefore needs prices, not heuristics:

* **training work** — a lane in a bucket pays
  ``T * K_pad * sum_t(steps_t * batch_rows_t)`` row-units per rollout:
  every one of the bucket's padded slots runs every tier body in the
  bucket's static tier subset, ``steps_t * batch_rows_t`` (= the tier's
  bucket rows processed per epoch) each.  ``unit_cost`` converts
  row-units to seconds.
* **compile** — each executable the plan needs that is NOT already in
  the arena's cache costs ``compile_cost`` seconds, paid once and
  amortised over the planning horizon (``runs``).
* **dispatch** — each bucket adds one dispatch chain per run
  (``dispatch_cost`` seconds): the term that breaks ties toward fewer
  executables when padding waste is negligible.

The defaults are calibrated against the tracked CPU record;
:meth:`CostModel.from_bench_json` re-derives them from any
``BENCH_round_engine.json``, and :meth:`CostModel.calibrate` measures
them with one timed probe (a cold + warm ``run_scan`` pair) on the
actual engine and bank.  Only the RATIOS matter for plan shape — the
planner compares alternatives, it never promises wall-clock.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Optional

__all__ = ["CostModel"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prices (seconds) for the dispatch planner's three cost terms."""

    #: seconds per training row-unit (one padded slot x one bucket row
    #: processed, see the module docstring); the steady-state price
    unit_cost: float = 8e-6
    #: seconds to compile one fresh rollout executable
    compile_cost: float = 5.0
    #: seconds of per-run launch overhead each extra bucket adds
    dispatch_cost: float = 2e-3
    #: seconds each bucket adds per round whatever its slots (the port's
    #: host-driven round; see the module docstring)
    round_cost: float = 0.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if not getattr(self, f.name) >= 0.0:
                raise ValueError(f"CostModel.{f.name} must be >= 0, got "
                                 f"{getattr(self, f.name)!r}")

    # -- cost terms ---------------------------------------------------------

    def lane_seconds(self, rounds: int, k_pad: int, tier_work: float
                     ) -> float:
        """Steady-state seconds one lane costs per rollout in a bucket of
        ``k_pad`` slots whose tier subset processes ``tier_work`` bucket
        rows per slot per round (``sum_t steps_t * batch_rows_t``)."""
        return self.unit_cost * float(rounds) * float(k_pad) * tier_work

    def bucket_seconds(self, num_lanes: int, rounds: int, k_pad: int,
                       tier_work: float, *, cached: bool,
                       runs: float) -> float:
        """Amortised per-run seconds of one bucket: dispatch + training
        work, plus its compile (if the executable is not cached) spread
        over the ``runs`` planning horizon (``math.inf`` = steady state,
        ``1`` = a one-shot cold grid)."""
        compile_s = 0.0 if cached else self.compile_cost
        runs = max(float(runs), 1.0)
        amortised = 0.0 if math.isinf(runs) else compile_s / runs
        return (amortised + self.dispatch_cost +
                num_lanes * self.lane_seconds(rounds, k_pad, tier_work)
                + self.round_cost * float(rounds))

    # -- calibration --------------------------------------------------------

    @classmethod
    def from_bench_json(cls, path: str = "BENCH_round_engine.json"
                        ) -> "CostModel":
        """Derive (unit_cost, compile_cost) from a tracked bench record's
        ``arena.mixed_k`` section — the grouped rows are the cleanest
        probe: per-K executables with zero padding waste, so steady-state
        seconds / total row-units is the unit price and (cold - steady)
        seconds / executables the compile price.  Missing or unusable
        records fall back to the defaults (the planner must stay usable
        on a fresh checkout)."""
        try:
            with open(path) as f:
                rec = json.load(f)
            cfg = rec["config"]
            mk = rec["arena"]["mixed_k"]
            rows = int(cfg["examples_per_client"])
            s, t = int(mk["S"]), int(mk["rounds"])
            ks = [int(k) for k in mk["K_values"]]
            lanes_per_k = s // len(ks)
            row_units = t * rows * lanes_per_k * sum(ks)
            steady_s = s * t / float(mk["grouped_rounds_per_sec"])
            unit = steady_s / row_units
            compile_s = max(
                (float(mk["grouped_cold_seconds"]) - steady_s) /
                int(mk["grouped_executables"]), 1e-3)
            if unit <= 0.0 or not math.isfinite(unit):
                raise ValueError(f"non-positive unit cost {unit!r}")
            return cls(unit_cost=unit, compile_cost=compile_s)
        except (OSError, ValueError, KeyError, ZeroDivisionError, TypeError):
            return cls()

    @classmethod
    def calibrate(cls, engine, sp, bank, *, rounds: int = 3,
                  seed: int = 0, policy: str = "uni_d",
                  dispatch_cost: Optional[float] = None) -> "CostModel":
        """ONE timed probe on the actual engine and bank, at the engine's
        device: a cold ``run_scan`` at the SystemParams' K, a warm replay,
        and a warm ``run_scan`` at 2K (at most N).  The two warm runs'
        difference over their row-units gives ``unit_cost``; what the
        warm K run costs beyond its row-units, per round, gives
        ``round_cost``; cold minus warm gives ``compile_cost`` — in
        PyTorch what a first run of a shape pays (cuDNN's algorithm
        choice for new batch sizes, the allocator growing).  At K = N
        all the warm seconds are priced as row-units.  The channels come
        from the port's ``fl.environment.sample_gains``; on a CUDA device
        the rollout's kernel (``fl_aggregate``) is built first, so
        ``nvcc`` lands in no number, and the card is synchronised before
        every clock read."""
        import numpy as np
        import torch

        from repro_torch.core import draws
        from repro_torch.fl.environment import sample_gains

        dev = engine.device
        on_card = dev.type == "cuda"
        if on_card:
            from repro_torch.kernels import _build
            _build.build_all(("fl_aggregate",))
        n = sp.num_devices
        h_seq = sample_gains(draws.fold(torch.tensor([seed]), 0), rounds, n,
                             0.1, 0.01, 0.5)[0].cpu().numpy()
        lr_seq = np.zeros(rounds, np.float32)
        params0 = {name: v.to(dev) for name, v in engine.task.init(
            torch.Generator().manual_seed(seed)).items()}

        def clock() -> float:
            if on_card:
                torch.cuda.synchronize(dev)
            return time.perf_counter()

        def once(k: int) -> float:
            t0 = clock()
            engine.run_scan(params0, dataclasses.replace(sp, sample_count=k),
                            bank, h_seq, lr_seq,
                            torch.Generator().manual_seed(seed),
                            policy=policy)
            return clock() - t0

        k, k2 = sp.sample_count, min(2 * sp.sample_count, n)
        cold = once(k)
        warm = once(k)
        # the arena's ``_tier_work`` weights, local epochs included
        banks = bank.tiers if hasattr(bank, "tiers") else [bank]
        tier_work = engine.cfg.local_epochs * sum(
            b.steps_per_epoch * b.batch_size for b in banks)

        def row_units(k: int) -> float:
            return float(rounds * k * tier_work)

        if k2 > k:
            unit = (once(k2) - warm) / (row_units(k2) - row_units(k))
        else:
            unit = warm / max(row_units(k), 1.0)
        unit = max(unit, 1e-12)
        kw = {} if dispatch_cost is None else dict(
            dispatch_cost=dispatch_cost)
        return cls(unit_cost=unit, compile_cost=max(cold - warm, 1e-3),
                   round_cost=max((warm - unit * row_units(k)) / rounds,
                                  0.0), **kw)
