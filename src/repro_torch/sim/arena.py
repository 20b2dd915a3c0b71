"""The scenario arena — the paper's evaluation grid (Sec. VII) as one
lane-batched rollout: the port of ``repro.sim.arena``.

The paper's evaluation is a grid of rollouts: every controller across
seeds, V and lambda, energy budgets, channel statistics, K and dropout.
The arena stacks the S scenarios struct-of-arrays (:class:`ScenarioGrid`)
and runs them as ONE rollout over one engine and one shared, read-only
client bank (``RoundEngine._build_lanes``): a ``ClientBank``, the tier
ladder ``TieredClientBank``, a ``BankPool``, fp32 or int8:

* **Control plane per lane.**  Every round each lane runs its own
  controller's ``decide_by_id`` / ``select_by_id`` with its own solver
  trip counts (the JAX package's ``batch='map'`` control plane), its
  queue update and its metrics — the functions ``run_scan`` runs.
* **Data plane batched.**  The S·K_max selected rows are gathered from
  the bank in one ``index_select``, one E-epoch SGD trains all S·K_max
  clients (each from its lane's model), and every lane's eq.-(4) step is
  one lane-batched ``fl_aggregate`` launch on a CUDA device
  (``server.aggregate_fused_lanes``).  On a multi-tier ladder the S·K_max
  slots' tier ids are read back once a round, and the gather and the SGD
  run once per tier that gets a member; the launch stays one.
* **K as data.**  A mixed-K grid runs padded to ``K_max`` (``k_mode=
  'pad'``, the default: one rollout; slots beyond a lane's K are inert,
  so its model trajectory is the unpadded one) or grouped by K
  (``'group'``: one rollout per distinct K, scattered back to grid
  order).
* **Channels drawn on the device** from the grid's seeds by the port's
  lane-batched samplers (``fl.environment.sample_channel_sequence``,
  ``sample_dropout_mask``), the same bits on the CPU and the card.
* **Evaluation on the device.**  An ``EvalBank`` evaluates the final
  ``[S, ...]`` params in one batched call (``final_metrics``), and
  ``eval_every=E`` inside the rollout every E rounds (``test_*``
  columns).
* **Shape-adaptive dispatch** (``k_mode='auto'``): the copied planner
  buckets the lanes by K where the padded slots a shared bucket would
  train cost more than another bucket's rounds.
* **Chunked, checkpointed runs.**  ``chunk_size=C`` runs T rounds as
  ceil(T / C) segments of the same lane body, each resuming from the
  previous one's carry at the global round, bitwise the one-shot run; a
  ``chunk_store`` (``sim.service.NpzChunkStore``, behind the
  ``SweepService``) saves the carry at chunk boundaries, so a killed run
  resumes where it stopped, bitwise.
* **``batch='map'``**: each lane's data plane on its own, as ``run_scan``
  runs it (one-lane ``fl_aggregate`` launches).
* **Lane-axis sharding** (``mesh=``, a ``launch.mesh`` mesh; one
  ``torch.distributed`` rank per shard): the strong-scaling axis for
  sweep grids.  Each bucket's lanes split into contiguous blocks, whole
  rollouts per rank (the bucket's lane count must divide, else
  ``ValueError``); no collective runs inside a rollout; each bucket's
  params, queues and metric columns (the eval columns too) are gathered
  at its end, so every rank returns the unsharded run's report.  The
  engine must be mesh-free (client- and lane-axis sharding do not nest).
  A chunked run keeps one store: rank 0 saves the gathered carry, every
  rank resumes from its own slice, and the chunk tag holds the shard
  count.

The reproducibility contract: lane s of :meth:`Arena.run` reproduces ::

    engine.run_scan(global_params, grid.scenario_system_params(sp, s),
                    bank, h_all[s], lr_seq,
                    torch.Generator().manual_seed(int(grid.seed[s])),
                    policy=grid.controller_names()[s], V=grid.V[s],
                    lam=grid.lam[s], drop_seq=drop_all[s], k_max=K_max)

(``drop_seq`` when dropout is on; ``K_max`` the lane's group's K under
``'group'``).  The rollout key is the one ``run_scan`` draws from that
generator (:func:`scenario_keys`); selections are exact, and the control
plane is the same code on the same inputs, so queues and every modelled
metric are bitwise.  The model (params, losses) is bitwise where the
batched SGD computes each client as the per-rollout SGD does (the CPU
tests pin where it does) and within float32 resolution otherwise; under
``batch='map'`` it is bitwise wherever the device repeats itself.

**Warmup and the executable cache.**  The JAX package caches one
compiled executable per bucket signature, ``(bank layout, K_max, shards,
eval config, dropout)`` (and ``+ ("resume",)`` for a chunked
continuation), in ``Arena._fns``.  Eager PyTorch compiles nothing, but a
bucket signature's first run does cold work a steady state must not
repeat: the ``nvcc`` build of a kernel at its first launch, cuDNN's and
cuBLAS's set-up for a new SGD shape, the caching allocator's growth.
So the port keys ``_fns`` the same way and holds, per signature, the
record of that first run (its seconds); a new
signature increments ``traces`` and runs under an ``arena.compile``
span.  :meth:`Arena.warmup` runs every bucket of the plan a same-shape
:meth:`Arena.run` will take for a few rounds, discards the results and
arms an attached ``obs.Watchdog``.  T and a chunk's length shape no
per-round tensor here, so neither is part of the signature: a run at
another T does not retrace, where the JAX package's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import math
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import draws
from repro_torch.core import policy as pol
from repro_torch.core import system_model as sm
from repro_torch.core.controller import estimate_hyperparams_arrays
from repro_torch.fl.environment import (CHANNEL_MODE_IDS, CHANNEL_MODES,
                                        ChannelConfig,
                                        sample_channel_sequence,
                                        sample_dropout_mask)
from repro_torch.fl.client_bank import TieredClientBank
from repro_torch.fl.round_engine import _Lane, bank_layout_key
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sim.cost_model import CostModel
from repro_torch.sim.dispatch import DispatchPlan, plan_dispatch
from repro_torch.sim.report import RolloutReport, concat_chunk_metrics

Params = Dict[str, torch.Tensor]

#: the stream of a seed that keys its channels and dropout masks:
#: ``draws.fold(seed, CHANNEL_STREAM)``, apart from the rollout key that
#: ``torch.Generator().manual_seed(seed)`` gives ``run_scan``
CHANNEL_STREAM = 0x43484E4C

#: ``k_mode='auto'``'s default prices, a constant so a plan does not
#: depend on the machine: ``CostModel.calibrate`` on the paper-scale
#: testbed's 4-rung ladder on an H100 80GB HBM3 at 700 W (``chip_smoke.py``
#: sweep phase) gave 1.8e-6 to 2.5e-6 s per row-unit, 0.89 to 1.04 s per
#: bucket round and a first run no slower than a warm one (its 1e-3 s
#: floor; PyTorch compiles nothing ahead, the JAX package's price is 5 s).
#: A bucket's round then costs more than the padded slots a merge adds,
#: so mixed-K grids of that size run as one bucket.
DEFAULT_COST_MODEL = CostModel(unit_cost=2e-6, compile_cost=0.0,
                               round_cost=0.95)


def aot_cache_warmup_supported() -> bool:
    """Whether :meth:`Arena.warmup` can warm ahead of time, without
    running: the JAX package probes whether its jit call cache is filled
    by ``lower().compile()``.  Eager PyTorch builds nothing ahead (the
    cold work is the first run itself), so never."""
    return False


def _as_f32(value, s: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(value, np.float32), (s,)).copy()


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """Struct-of-arrays stack of S scenarios (all fields numpy ``[S]``):
    a copy of the JAX package's grid, with the same fields, defaults and
    validation.

    ``controller`` holds ``repro_torch.core.policy.POLICY_IDS`` ids;
    ``energy_scale`` multiplies the base ``SystemParams.energy_budget``;
    (``mean_gain``, ``min_gain``, ``max_gain``) are the per-scenario
    truncated-exponential channel statistics; ``sample_count`` is K.
    ``chan_mode`` selects the channel process per lane
    (``fl.environment.CHANNEL_MODE_IDS`` — 'iid' or 'markov'), with
    (``bad_gain``, ``p_gb``, ``p_bg``) the Gilbert-Elliott bad-state mean
    and transition probabilities (ignored by 'iid' lanes); ``dropout`` is
    the per-client per-round dropout probability.  Build with
    :meth:`create` (broadcasting scalars) or :meth:`product` (cartesian
    sweep axes).
    """

    controller: np.ndarray
    seed: np.ndarray
    V: np.ndarray
    lam: np.ndarray
    energy_scale: np.ndarray
    mean_gain: np.ndarray
    min_gain: np.ndarray
    max_gain: np.ndarray
    sample_count: np.ndarray
    chan_mode: Optional[np.ndarray] = None
    bad_gain: Optional[np.ndarray] = None
    p_gb: Optional[np.ndarray] = None
    p_bg: Optional[np.ndarray] = None
    dropout: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.controller.shape[0])

    def __post_init__(self):
        s = len(self)
        defaults = dict(chan_mode=np.zeros((s,), np.int32),
                        bad_gain=np.full((s,), 0.02, np.float32),
                        p_gb=np.zeros((s,), np.float32),
                        p_bg=np.zeros((s,), np.float32),
                        dropout=np.zeros((s,), np.float32))
        for name, default in defaults.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, default)
        for f in dataclasses.fields(self):
            arr = getattr(self, f.name)
            if arr.shape != (s,):
                raise ValueError(f"ScenarioGrid.{f.name} must have shape "
                                 f"({s},), got {arr.shape}")
        if s == 0:
            raise ValueError("empty ScenarioGrid")
        if np.any((self.chan_mode < 0) |
                  (self.chan_mode >= len(CHANNEL_MODES))):
            raise ValueError(f"chan_mode ids must index {CHANNEL_MODES}")
        for name in ("p_gb", "p_bg"):
            vals = getattr(self, name)
            if np.any((vals < 0.0) | (vals > 1.0)):
                raise ValueError(f"ScenarioGrid.{name} must lie in [0, 1]")
        if np.any((self.dropout < 0.0) | (self.dropout >= 1.0)):
            raise ValueError("ScenarioGrid.dropout must lie in [0, 1)")
        # the JAX package's PRNGKey truncates seeds to 32 bits; the same
        # range keeps a grid valid in both packages
        if np.any(self.seed < 0) or np.any(self.seed >= 2 ** 32):
            raise ValueError("ScenarioGrid seeds must fit in uint32 "
                             "(PRNGKey truncates wider seeds, which would "
                             "silently alias scenarios)")
        if np.any(self.sample_count < 1):
            raise ValueError(
                f"ScenarioGrid sample_count values must be >= 1, got "
                f"{self.sample_count.tolist()}")

    @staticmethod
    def _check_sample_counts(sample_count, num_devices) -> None:
        """Reject K > N at construction: the paper's sampling draws K of
        N devices."""
        if num_devices is None:
            return
        ks = np.atleast_1d(np.asarray(sample_count, np.int64))
        if np.any(ks > int(num_devices)):
            bad = sorted(int(v) for v in np.unique(ks[ks > num_devices]))
            raise ValueError(
                f"sample_count values {bad} exceed num_devices="
                f"{int(num_devices)} (K must satisfy K <= N)")

    @staticmethod
    def _controller_ids(controllers) -> np.ndarray:
        ids = []
        for c in np.atleast_1d(np.asarray(controllers, object)):
            if isinstance(c, (int, np.integer)):
                cid = int(c)
                if not 0 <= cid < len(pol.POLICIES):
                    raise ValueError(f"controller id {cid} out of range "
                                     f"for {pol.POLICIES}")
            else:
                name = str(c)
                if name not in pol.POLICY_IDS:
                    raise ValueError(f"unknown controller {name!r} "
                                     f"(scan-traceable: {pol.POLICIES})")
                cid = pol.POLICY_IDS[name]
            ids.append(cid)
        return np.asarray(ids, np.int32)

    @staticmethod
    def _channel_mode_ids(modes) -> np.ndarray:
        ids = []
        for m in np.atleast_1d(np.asarray(modes, object)):
            if isinstance(m, (int, np.integer)):
                mid = int(m)
                if not 0 <= mid < len(CHANNEL_MODES):
                    raise ValueError(f"channel mode id {mid} out of range "
                                     f"for {CHANNEL_MODES}")
            else:
                name = str(m)
                if name not in CHANNEL_MODE_IDS:
                    raise ValueError(f"unknown channel mode {name!r} "
                                     f"(known: {CHANNEL_MODES})")
                mid = CHANNEL_MODE_IDS[name]
            ids.append(mid)
        return np.asarray(ids, np.int32)

    @classmethod
    def create(cls, controllers, seeds, V, lam, *, energy_scale=1.0,
               mean_gain=0.1, min_gain=0.01, max_gain=0.5,
               sample_count=2, chan_mode="iid", bad_gain=0.02, p_gb=0.0,
               p_bg=0.0, dropout=0.0,
               num_devices=None) -> "ScenarioGrid":
        """Element-wise grid: every argument broadcasts to the common
        scenario count S (controllers by name or id, channel modes by
        name or id).  ``num_devices`` (optional) validates every K
        against N up front."""
        cls._check_sample_counts(sample_count, num_devices)
        ids = cls._controller_ids(controllers)
        modes = cls._channel_mode_ids(chan_mode)
        seeds = np.atleast_1d(np.asarray(seeds, np.int64))
        s = max(ids.shape[0], seeds.shape[0], modes.shape[0],
                *(np.atleast_1d(np.asarray(v)).shape[0]
                  for v in (V, lam, energy_scale, mean_gain, min_gain,
                            max_gain, sample_count, bad_gain, p_gb, p_bg,
                            dropout)))
        return cls(
            controller=np.broadcast_to(ids, (s,)).copy(),
            seed=np.broadcast_to(seeds, (s,)).copy(),
            V=_as_f32(V, s), lam=_as_f32(lam, s),
            energy_scale=_as_f32(energy_scale, s),
            mean_gain=_as_f32(mean_gain, s),
            min_gain=_as_f32(min_gain, s),
            max_gain=_as_f32(max_gain, s),
            sample_count=np.broadcast_to(
                np.asarray(sample_count, np.int32), (s,)).copy(),
            chan_mode=np.broadcast_to(modes, (s,)).copy(),
            bad_gain=_as_f32(bad_gain, s),
            p_gb=_as_f32(p_gb, s), p_bg=_as_f32(p_bg, s),
            dropout=_as_f32(dropout, s),
        )

    @classmethod
    def product(cls, controllers, seeds, V, lam, *, energy_scale=(1.0,),
                mean_gain=(0.1,), min_gain=(0.01,), max_gain=(0.5,),
                sample_count=(2,), chan_mode=("iid",), bad_gain=(0.02,),
                p_gb=(0.0,), p_bg=(0.0,), dropout=(0.0,),
                num_devices=None) -> "ScenarioGrid":
        """Cartesian sweep: one scenario per element of the cross product
        of the given axes (controllers x seeds x hyper-parameters x
        budgets x channels x K x channel modes x dropout).
        ``num_devices`` (optional) validates every K against N up
        front."""
        cls._check_sample_counts(sample_count, num_devices)
        ids = cls._controller_ids(controllers)
        modes = cls._channel_mode_ids(chan_mode)
        axes = [ids.tolist(), np.atleast_1d(seeds).tolist(),
                np.atleast_1d(V).tolist(), np.atleast_1d(lam).tolist(),
                np.atleast_1d(energy_scale).tolist(),
                np.atleast_1d(mean_gain).tolist(),
                np.atleast_1d(min_gain).tolist(),
                np.atleast_1d(max_gain).tolist(),
                np.atleast_1d(sample_count).tolist(),
                modes.tolist(),
                np.atleast_1d(bad_gain).tolist(),
                np.atleast_1d(p_gb).tolist(),
                np.atleast_1d(p_bg).tolist(),
                np.atleast_1d(dropout).tolist()]
        rows = list(itertools.product(*axes))
        cols = list(zip(*rows))
        return cls(
            controller=np.asarray(cols[0], np.int32),
            seed=np.asarray(cols[1], np.int64),
            V=np.asarray(cols[2], np.float32),
            lam=np.asarray(cols[3], np.float32),
            energy_scale=np.asarray(cols[4], np.float32),
            mean_gain=np.asarray(cols[5], np.float32),
            min_gain=np.asarray(cols[6], np.float32),
            max_gain=np.asarray(cols[7], np.float32),
            sample_count=np.asarray(cols[8], np.int32),
            chan_mode=np.asarray(cols[9], np.int32),
            bad_gain=np.asarray(cols[10], np.float32),
            p_gb=np.asarray(cols[11], np.float32),
            p_bg=np.asarray(cols[12], np.float32),
            dropout=np.asarray(cols[13], np.float32),
        )

    def take(self, idx: np.ndarray) -> "ScenarioGrid":
        """Sub-grid of the given scenario indices (grid order kept)."""
        return ScenarioGrid(**{f.name: getattr(self, f.name)[idx]
                               for f in dataclasses.fields(self)})

    @classmethod
    def concat(cls, grids: "List[ScenarioGrid]") -> "ScenarioGrid":
        """Stack several grids into one (lane order = submission
        order)."""
        if not grids:
            raise ValueError("no grids to concatenate")
        return cls(**{f.name: np.concatenate(
            [getattr(g, f.name) for g in grids])
            for f in dataclasses.fields(grids[0])})

    def controller_names(self) -> list:
        return [pol.POLICIES[c] for c in self.controller]

    def channel_mode_names(self) -> list:
        return [CHANNEL_MODES[m] for m in self.chan_mode]

    def channel_config(self, s: int) -> ChannelConfig:
        """Scenario ``s``'s channel statistics as a ``ChannelConfig``."""
        return ChannelConfig(
            mean_gain=float(self.mean_gain[s]),
            min_gain=float(self.min_gain[s]),
            max_gain=float(self.max_gain[s]),
            seed=int(self.seed[s]),
            mode=CHANNEL_MODES[int(self.chan_mode[s])],
            bad_gain=float(self.bad_gain[s]),
            p_gb=float(self.p_gb[s]), p_bg=float(self.p_bg[s]),
            dropout=float(self.dropout[s]))

    def scenario_system_params(self, sp: sm.SystemParams, s: int
                               ) -> sm.SystemParams:
        """Scenario ``s``'s SystemParams — the exact parameters a
        ``run_scan`` reproduction of lane ``s`` must use (the arena's
        lanes are built from them): K from the grid, the energy budget
        scaled in float32."""
        scale = torch.tensor(float(self.energy_scale[s]),
                             dtype=torch.float32)
        return dataclasses.replace(
            sp, sample_count=int(self.sample_count[s]),
            energy_budget=sp.energy_budget * scale.to(sp.device))


def scenario_keys(grid: ScenarioGrid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scenario keys, int64 ``[S]`` CPU tensors: ``(channel_keys,
    rollout_keys)``.  ``rollout_keys[s]`` is the key ``run_scan`` draws
    from ``torch.Generator().manual_seed(int(grid.seed[s]))`` (one
    ``randint``), so that generator replays lane s; ``channel_keys[s] =
    draws.fold(seed, CHANNEL_STREAM)`` keys the lane's channels and
    dropout mask, a stream apart from the generator's."""
    seeds = torch.as_tensor(np.asarray(grid.seed, np.int64))
    rollout = torch.stack([
        torch.randint(0, 2 ** 62, (),
                      generator=torch.Generator().manual_seed(int(seed)))
        for seed in grid.seed])
    return draws.fold(seeds, CHANNEL_STREAM), rollout


def derive_hyperparams(sp: sm.SystemParams, grid: ScenarioGrid, mu, nu,
                       loss_scale=1.0) -> ScenarioGrid:
    """Fill the grid's (lam, V) from per-scenario (mu, nu) via the
    Sec. VII-B estimates (``core.controller.estimate_hyperparams_arrays``
    in float32), using each scenario's own K, mean channel gain and
    scaled energy budget."""
    s = len(grid)
    mu, nu = _as_f32(mu, s), _as_f32(nu, s)
    loss_scale = _as_f32(loss_scale, s)
    lam = np.zeros(s, np.float32)
    v = np.zeros(s, np.float32)
    dev = sp.device
    for i in range(s):
        lam_i, v_i, _, _ = estimate_hyperparams_arrays(
            grid.scenario_system_params(sp, i), float(grid.mean_gain[i]),
            loss_scale=float(loss_scale[i]),
            mu=torch.tensor(mu[i], device=dev),
            nu=torch.tensor(nu[i], device=dev))
        lam[i], v[i] = float(lam_i), float(v_i)
    return dataclasses.replace(grid, lam=lam, V=v)


def _content_digest(value) -> str:
    """sha1 hex of a tensor, an array or a dict of them: names, dtypes,
    shapes and bytes, so equal content gives the same digest in any
    process and on any device."""
    hasher = hashlib.sha1()
    items = (sorted(value.items()) if isinstance(value, dict)
             else [("", value)])
    for name, v in items:
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.dtype == torch.bfloat16:
                v = v.view(torch.int16)
            v = v.cpu().numpy()
        arr = np.ascontiguousarray(v)
        hasher.update(repr((name, str(arr.dtype), arr.shape)).encode())
        hasher.update(arr.reshape(-1).view(np.uint8))
    return hasher.hexdigest()


def _system_params_digest(sp: sm.SystemParams) -> str:
    """:func:`_content_digest` of every field of ``sp``."""
    return _content_digest({
        f.name: (v if isinstance(v := getattr(sp, f.name), torch.Tensor)
                 else np.asarray(v))
        for f in dataclasses.fields(sp)})


def _lane_slice(value, lo: int, hi: int):
    """Lanes ``[lo, hi)`` (axis 0) of a tensor, an array, or a dict or
    tuple of them."""
    if isinstance(value, dict):
        return {name: _lane_slice(v, lo, hi) for name, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_lane_slice(v, lo, hi) for v in value)
    return value[lo:hi]


def _to_host(tree):
    """A nested dict of tensors as numpy copies (never views of the
    tensors, which a later chunk may overwrite)."""
    if isinstance(tree, dict):
        return {name: _to_host(v) for name, v in tree.items()}
    return tree.detach().to("cpu", copy=True).numpy()


class Arena:
    """Runs a :class:`ScenarioGrid` as one lane-batched rollout over one
    engine (a ``RoundEngine``; its ``device`` is the arena's).

    ``batch`` picks the data plane: ``'vmap'`` (default) trains every
    lane's K slots in one SGD call and reduces every lane in one
    lane-batched ``fl_aggregate`` launch; ``'map'`` runs each lane's
    round on its own, as ``run_scan`` does (its K-client SGD, then a
    one-lane launch), so lane s is bitwise ``run_scan`` on its scenario
    even where the batched SGD convolves through other kernels.  The
    control plane is per lane in both (the JAX package's names).

    ``k_mode`` picks how a mixed-K grid runs: ``'pad'`` (default) — one
    rollout padded to ``K_max``; ``'group'`` — one rollout per distinct
    K, lanes scattered back to grid order; ``'auto'`` — the dispatch
    planner (``sim.dispatch.plan_dispatch`` under ``cost_model``, at
    most ``max_executables`` buckets) buckets the lanes by K, weighing
    the padded slots a merge would train against the bucket rounds it
    saves, and the buckets' results are stitched back to grid order.  It plans
    by K alone: the port's ``_train`` routes every round by tier, so
    every bucket pays each slot's own tier whatever tiers its lanes
    touch (the JAX package's per-bucket tier subsets, found by a
    control-plane probe, prune compiled tier bodies the port does not
    have).  The default ``cost_model`` is :data:`DEFAULT_COST_MODEL`, a
    constant, so a plan does not depend on the machine;
    ``CostModel.calibrate`` prices this engine instead.

    ``chunk_size`` (or ``run``'s) splits every bucket's T rounds into
    ``ceil(T / chunk_size)`` segments of the same lane body, each resuming
    from the previous one's carry (``[S, ...]`` params, ``[S, N]`` queues,
    the last in-rollout evaluation): bitwise the one-shot rollout.  With
    a ``chunk_store`` (``sim.service.NpzChunkStore``) the carry and the
    columns so far are saved at chunk boundaries, and a run of the same
    inputs resumes from the last one.  The JAX package keeps up to
    ``in_flight`` chunks dispatched ahead of the host's reduction; the
    port's control plane reads back every round (the solver's
    while-loops), so there is no queue of device work to overlap, and
    each chunk's columns are read back when it ends.

    ``mesh=`` splits every bucket's lanes over the mesh axis
    ``mesh_axis`` (see the module docstring; the engine must have no
    mesh).

    ``_fns`` holds one record per bucket signature run so far (see the
    module docstring); :meth:`warmup` fills it for a grid's shape, and
    ``traces`` counts the signatures' first runs.  ``watchdog`` (an
    ``obs.Watchdog``, set by its ``attach``) is armed by :meth:`warmup`
    and told of every :meth:`run`.

    ``metrics`` is the arena's :class:`~repro_torch.obs.metrics.
    MetricsRegistry`: ``arena.runs``, ``arena.dispatches``,
    ``arena.traces``, ``arena.executables_built`` (signatures first run
    by :meth:`run`), the ``arena.executables_cached`` gauge, the
    ``arena.chunk.dispatch_s`` / ``reduce_s`` and ``arena.bank_digest_s``
    (the chunk tag's hash of the bank) histograms, and the device-input
    caches' ``arena.input_cache.hits`` / ``.misses`` (lane constants,
    channels and dropout masks keyed by grid content, learning rates by
    value, at most 16 entries each); the sweep service and its chunk
    store write theirs into it too.
    """

    def __init__(self, engine, mesh=None, mesh_axis: str = "data",
                 batch: str = "vmap", k_mode: str = "pad",
                 cost_model: Optional[CostModel] = None,
                 max_executables: int = 4,
                 chunk_size: Optional[int] = None):
        if batch not in ("vmap", "map"):
            raise ValueError(f"unknown batch mode {batch!r} "
                             "(expected 'vmap' or 'map')")
        if k_mode not in ("pad", "group", "auto"):
            raise ValueError(f"unknown k_mode {k_mode!r} "
                             "(expected 'pad', 'group' or 'auto')")
        if max_executables < 1:
            raise ValueError(f"max_executables must be >= 1, "
                             f"got {max_executables}")
        if engine.mesh is not None:
            raise ValueError(
                "ScenarioArena shards the scenario axis; build the "
                "RoundEngine without a mesh (client-axis sharding does not "
                "nest under the arena's lane split)")
        if mesh is not None:
            mesh_lib.check_mesh(mesh, mesh_axis)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.engine = engine
        self.device = engine.device
        self.batch = batch
        self.k_mode = k_mode
        self.cost_model = (cost_model if cost_model is not None
                           else DEFAULT_COST_MODEL)
        self.max_executables = int(max_executables)
        self.chunk_size = chunk_size
        self.metrics = MetricsRegistry()
        #: bucket signature -> {"first_run_s"} (module docstring)
        self._fns: Dict[tuple, dict] = {}
        #: an ``obs.Watchdog``: armed by :meth:`warmup`, told of each run
        self.watchdog = None
        # bank -> ((admits, evicts), content digest), for the chunk tag
        self._bank_digests = weakref.WeakKeyDictionary()
        self._input_cache_cap = 16
        self._lane_cache: Dict[bytes, dict] = {}
        self._lr_cache: Dict[bytes, torch.Tensor] = {}
        self._chan_cache: Dict[bytes, torch.Tensor] = {}

    # -- registry views ------------------------------------------------------

    @property
    def traces(self) -> int:
        """Bucket signatures first run by this arena (``warmup`` included):
        a warmed arena keeps it constant across same-shape runs.  A view
        over ``metrics['arena.traces']``."""
        return self.metrics.counter("arena.traces").value

    @property
    def input_cache_hits(self) -> int:
        return self.metrics.counter("arena.input_cache.hits").value

    @property
    def input_cache_misses(self) -> int:
        return self.metrics.counter("arena.input_cache.misses").value

    def _shards(self) -> int:
        if self.mesh is None:
            return 1
        return mesh_lib.axis_size(self.mesh, self.mesh_axis)

    def _gather_lanes(self, value):
        """This rank's ``[S/shards, ...]`` lanes of a tensor, a numpy
        array or a dict of them -> every rank's, ``[S, ...]`` in rank
        order (numpy stays numpy)."""
        if isinstance(value, dict):
            return {name: self._gather_lanes(v) for name, v in value.items()}
        if isinstance(value, tuple):
            return tuple(self._gather_lanes(v) for v in value)
        if isinstance(value, np.ndarray):
            return mesh_lib.all_gather_cat(
                torch.as_tensor(value, device=self.device), self.mesh,
                self.mesh_axis).cpu().numpy()
        return mesh_lib.all_gather_cat(value, self.mesh, self.mesh_axis)

    # -- device inputs -------------------------------------------------------

    @staticmethod
    def _grid_digest(grid: ScenarioGrid, extra: tuple = ()) -> bytes:
        """Content hash of every grid column (+ ``extra``): the key of the
        device-input caches and of the chunk tag, so a pure function of
        values (tags outlive the process)."""
        hasher = hashlib.sha1()
        for f in dataclasses.fields(grid):
            hasher.update(np.ascontiguousarray(
                getattr(grid, f.name)).tobytes())
        hasher.update(repr(extra).encode())
        return hasher.digest()

    def _cached(self, cache: dict, key, make):
        hit = cache.get(key)
        if hit is not None:
            self.metrics.counter("arena.input_cache.hits").inc()
            return hit
        self.metrics.counter("arena.input_cache.misses").inc()
        if len(cache) >= self._input_cache_cap:
            cache.pop(next(iter(cache)))
        cache[key] = value = make()
        return value

    def _columns(self, grid: ScenarioGrid, *names) -> list:
        return [torch.as_tensor(getattr(grid, n), device=self.device)
                for n in names]

    def sample_channels(self, grid: ScenarioGrid, num_rounds: int,
                        num_devices: int) -> torch.Tensor:
        """Every scenario's channel sequence, ``[S, T, N]`` on the
        arena's device, drawn in one lane-batched call from the
        per-scenario (channel key, mode, mean, clip, chain) columns
        (``fl.environment.sample_channel_sequence``).  Cached by (grid
        content, T, N)."""
        def make():
            with obs.span("arena.upload", what="channels",
                          lanes=len(grid), rounds=num_rounds):
                keys = scenario_keys(grid)[0].to(self.device)
                return sample_channel_sequence(
                    keys, num_rounds, num_devices, *self._columns(
                        grid, "chan_mode", "mean_gain", "bad_gain",
                        "min_gain", "max_gain", "p_gb", "p_bg"))
        return self._cached(self._chan_cache, self._grid_digest(
            grid, ("chan", num_rounds, num_devices)), make)

    def sample_dropout(self, grid: ScenarioGrid, num_rounds: int,
                       num_devices: int) -> torch.Tensor:
        """Every scenario's alive mask, ``[S, T, N]`` float32 (1.0 =
        alive), from the dropout stream of the same channel keys
        (``fl.environment.sample_dropout_mask``), so enabling the axis
        never moves the gains.  Cached like :meth:`sample_channels`."""
        def make():
            with obs.span("arena.upload", what="dropout", lanes=len(grid),
                          rounds=num_rounds):
                keys = scenario_keys(grid)[0].to(self.device)
                return sample_dropout_mask(keys, num_rounds, num_devices,
                                           *self._columns(grid, "dropout"))
        return self._cached(self._chan_cache, self._grid_digest(
            grid, ("drop", num_rounds, num_devices)), make)

    def _lane_inputs(self, grid: ScenarioGrid, sp: sm.SystemParams) -> dict:
        """The per-lane constants: SystemParams (K and the scaled energy
        budget, :meth:`ScenarioGrid.scenario_system_params`), V, lam and
        K as ``[N]`` float32 (as ``run_scan`` passes them), the rollout
        keys on the device.  Cached by grid content and base budget."""
        def make():
            with obs.span("arena.upload", what="lane_constants",
                          lanes=len(grid)):
                n, dev = sp.num_devices, self.device

                def full(v) -> torch.Tensor:
                    return torch.full((n,), float(v), dtype=torch.float32,
                                      device=dev)
                keys = scenario_keys(grid)[1].to(dev)
                return dict(
                    sp=[grid.scenario_system_params(sp, s)
                        for s in range(len(grid))],
                    V=[full(v) for v in grid.V],
                    lam=[full(v) for v in grid.lam],
                    kvec=[full(k) for k in grid.sample_count],
                    keys=[keys[s] for s in range(len(grid))])
        return self._cached(self._lane_cache, self._grid_digest(
            grid, ("lane", sp.num_devices, sp.energy_budget.cpu().numpy()
                   .tobytes())), make)

    def _lr_device(self, lr_seq: np.ndarray) -> torch.Tensor:
        """Device copy of the ``[T]`` learning rates, cached by value."""
        return self._cached(
            self._lr_cache, lr_seq.tobytes(),
            lambda: torch.as_tensor(lr_seq, device=self.device))

    # -- the lane-batched rollout ---------------------------------------------

    def _lanes(self, grid: ScenarioGrid, sp: sm.SystemParams, bank,
               h_all: torch.Tensor, drop_all: Optional[torch.Tensor],
               k_max: int, replay: Tuple[Any, Any]) -> List[_Lane]:
        """One :class:`~repro_torch.fl.round_engine._Lane` per scenario,
        at ``k_max`` slots, each with its controller's decide and select
        rules and its full-length channels, mask and replayed draws."""
        lane_in = self._lane_inputs(grid, sp)
        rep_sel, rep_keys = replay
        lanes = []
        for s in range(len(grid)):
            cid = int(grid.controller[s])

            def decide(sp_s, h, queues, V, lam, kvec, cid=cid):
                return pol.decide_by_id(cid, sp_s, h, queues, V, lam,
                                        k=kvec)

            def select(sp_s, t, h, queues, q, key, slots, kvec, cid=cid):
                return pol.select_by_id(cid, sp_s, t, h, queues, q, key,
                                        slots, kvec)

            lanes.append(_Lane(
                lane_in["sp"][s], k_max, int(grid.sample_count[s]),
                lane_in["kvec"][s], lane_in["V"][s], lane_in["lam"][s],
                lane_in["keys"][s], h_all[s],
                None if drop_all is None else drop_all[s],
                (None if rep_sel is None else rep_sel[s],
                 None if rep_keys is None else rep_keys[s]),
                decide, select, self.engine.cfg.local_epochs,
                bank.bucket_examples,
                queues0=torch.zeros(sp.num_devices, dtype=torch.float32,
                                    device=self.device), index=s))
        return lanes

    @staticmethod
    def _carry_tree(carry: tuple) -> dict:
        """``(params, queues, last_ev)`` chunk carry as the checkpoint's
        named tree: ``params``, ``queues`` and, with in-rollout
        evaluation, ``last_ev``.  It holds no rng: the port's draws are
        counter-based, keyed by the rollout key and the global round."""
        params, queues, last_ev = carry
        tree = {"params": params, "queues": queues}
        if last_ev is not None:
            tree["last_ev"] = last_ev
        return tree

    def _carry_from_tree(self, tree: dict) -> tuple:
        def dev(v):
            return torch.as_tensor(v, device=self.device)
        last_ev = tree.get("last_ev")
        return ({name: dev(v) for name, v in tree["params"].items()},
                dev(tree["queues"]),
                None if last_ev is None else
                {name: dev(v) for name, v in last_ev.items()})

    def _bank_digest(self, bank) -> str:
        """Content digest of ``bank``: every rung's ``device_args()`` and
        ``quant_args()`` and a ladder's client-to-rung map, so a bank of
        the same layout but other data, or a ``BankPool`` after churn,
        never meets another's chunk checkpoint.  Computed once per bank
        (a pool's once per count of its admits and evicts)."""
        version = (getattr(bank, "admits", 0), getattr(bank, "evicts", 0))
        hit = self._bank_digests.get(bank)
        if hit is not None and hit[0] == version:
            return hit[1]
        rungs = bank.tiers if isinstance(bank, TieredClientBank) else [bank]
        parts = {"tier_of": np.asarray(getattr(bank, "tier_of", ()))}
        for t, rung in enumerate(rungs):
            for i, v in enumerate(rung.device_args() + rung.quant_args()):
                if v is not None:
                    parts[f"{t}/{i}"] = v
        t0 = time.perf_counter()
        digest = _content_digest(parts)
        self.metrics.histogram("arena.bank_digest_s").observe(
            time.perf_counter() - t0)
        self._bank_digests[bank] = (version, digest)
        return digest

    def _chunk_tag(self, grid: ScenarioGrid, k_max: int, tier_subset,
                   eval_every, num_rounds: int, chunk: int,
                   lr_seq: np.ndarray, digests: tuple) -> str:
        """Filename-safe content tag of one bucket's chunked execution: a
        pure function of everything that shapes its trajectory, so a
        restarted process resuming the same submission recomputes it,
        and other inputs never meet its checkpoint.  The JAX package's
        tag hashes the grid, K_max, the tier subset, ``eval_every``, T,
        the chunk, the batch mode and the energy budget, and a caller's
        ``h_all`` (and its executable key the shard count, which this tag
        holds); this one adds the learning rates and, in ``digests``
        (:meth:`_run_impl`), every field of the SystemParams, the bank's
        content, the engine's client config and eq.-(4) path, a caller's
        ``drop_all`` and replayed draws, the initial params and the
        in-rollout evaluation's test set."""
        hasher = hashlib.sha1()
        hasher.update(self._grid_digest(grid, (
            "chunk", int(k_max), tier_subset, int(eval_every or 0),
            int(num_rounds), int(chunk), self.batch, self._shards(),
            digests, np.asarray(lr_seq, np.float32).tobytes())))
        return "chunk_" + hasher.hexdigest()[:20]

    def _run_group(self, global_params: Params, sp: sm.SystemParams, bank,
                   grid: ScenarioGrid, h_all: torch.Tensor,
                   lr_seq: np.ndarray, k_max: int, eval_bank=None,
                   eval_every: Optional[int] = None,
                   drop_all: Optional[torch.Tensor] = None,
                   replay: Tuple[Any, Any] = (None, None),
                   tier_subset=None, chunk_size: Optional[int] = None,
                   chunk_store=None, digests: tuple = (),
                   bucket_grid: Optional[ScenarioGrid] = None,
                   span: Optional[Tuple[int, int]] = None):
        """One bucket: every lane of ``grid`` at ``k_max`` slots, in one
        call of the lane body or, with ``chunk_size`` / ``chunk_store``,
        in segments that resume from each other's carry.  Returns ``([S,
        ...] params, [S, N] queues, metrics as numpy, dispatches,
        executables_built)``: the last counts the bucket's signatures
        (the start and, for a continued chunk, the resume signature) run
        here for the first time, each of whose first segment runs under
        an ``arena.compile`` span.

        The chunked pipeline: ceil(T / chunk) dispatches, the ragged
        tail included.  ``chunk_store`` (``.load(tag)``, ``.save(tag,
        t_next, carry, metrics)``, ``.finish(tag)``, ``.every``) resumes
        from its checkpoint at the round it holds, and is handed the
        columns so far and a host copy of the carry at every
        ``every``-th boundary but the last, before the next chunk runs;
        ``finish`` at the end.

        With a mesh, ``grid`` (and every per-lane input) is this rank's
        lanes ``span`` of the bucket ``bucket_grid``: the tag is the
        bucket's, a resume takes this rank's slice of the stored carry
        and columns, and a save gathers them (a collective) for rank 0
        to write."""
        engine = self.engine
        round_fn = (engine._map_plan(bank) if self.batch == "map"
                    else engine._lanes_plan(bank))
        body = engine._build_lanes(k_max, round_fn, eval_bank,
                                   int(eval_every or 0))
        lanes = self._lanes(grid, sp, bank, h_all, drop_all, k_max, replay)
        num_rounds = int(h_all.shape[1])
        lr_dev = self._lr_device(lr_seq)
        chunked = chunk_size is not None or chunk_store is not None
        chunk = (num_rounds if chunk_size is None
                 else max(1, int(chunk_size)))
        tag, t_start, carry, reduced = None, 0, None, []
        writer = (self.mesh is None or
                  mesh_lib.axis_rank(self.mesh, self.mesh_axis) == 0)
        if chunk_store is not None:
            tag = self._chunk_tag(grid if bucket_grid is None
                                  else bucket_grid, k_max, tier_subset,
                                  eval_every, num_rounds, chunk, lr_seq,
                                  digests)
            hit = chunk_store.load(tag)
            if hit is not None:
                t_start, tree, prefix = hit
                if span is not None:
                    tree, prefix = _lane_slice((tree, prefix), *span)
                carry = self._carry_from_tree(tree)
                reduced.append(dict(prefix))
        segments = [(t0, min(chunk, num_rounds - t0))
                    for t0 in range(t_start, num_rounds, chunk)]
        every = max(1, int(getattr(chunk_store, "every", 1)))
        s = len(grid)
        start_key = (bank_layout_key(bank, tier_subset), int(k_max),
                     self._shards(),
                     self._eval_key(eval_bank, eval_every),
                     drop_all is not None)
        built = 0
        for i, (t0, ln) in enumerate(segments):
            key = start_key if carry is None else start_key + ("resume",)
            cold = key not in self._fns
            t_disp = time.perf_counter()
            with (obs.span("arena.compile", stage="first_run",
                           resume=carry is not None, k_max=int(k_max),
                           key=repr(key))
                  if cold else contextlib.nullcontext()):
                with obs.span("arena.dispatch", chunk=i, t0=t0, rounds=ln,
                              k_max=int(k_max), lanes=s):
                    params, queues, outs, last_ev = body(
                        global_params, lanes, lr_dev, t0, carry, ln)
            t_red = time.perf_counter()
            if cold:
                self.metrics.counter("arena.traces").inc()
                self._fns[key] = {"first_run_s": t_red - t_disp}
                built += 1
            carry = (params, queues, last_ev)
            with obs.span("arena.reduce", chunk=i, rounds=ln,
                          k_max=int(k_max), lanes=s):
                reduced.append({name: v.cpu().numpy()
                                for name, v in outs.items()})
                # the read-back drained the stream: device spans resolve
                obs.resolve_device()
            if chunked:
                self.metrics.histogram("arena.chunk.dispatch_s").observe(
                    t_red - t_disp)
                self.metrics.histogram("arena.chunk.reduce_s").observe(
                    time.perf_counter() - t_red)
            if (chunk_store is not None and i < len(segments) - 1
                    and (i + 1) % every == 0):
                tree = self._carry_tree(carry)
                columns = concat_chunk_metrics(reduced)
                if span is not None:
                    tree, columns = self._gather_lanes((tree, columns))
                if writer:
                    # metrics first, carry second (the store's commit order)
                    chunk_store.save(tag, t0 + ln, _to_host(tree), columns)
        metrics = concat_chunk_metrics(reduced)
        if chunk_store is not None and writer:
            chunk_store.finish(tag)
        params, queues, _ = carry
        return params, queues, metrics, len(segments), built

    # -- shape-adaptive dispatch planning ------------------------------------

    def _eval_key(self, eval_bank, eval_every):
        """The eval component of a bucket signature: ``(id(task),
        eval_every)``, or None without in-rollout evaluation."""
        if eval_bank is None or not eval_every:
            return None
        return (id(eval_bank.task), int(eval_every))

    def _plan(self, bank, grid: ScenarioGrid, num_rounds: int, *,
              runs: float = 1.0, eval_key=None,
              use_dropout: bool = False) -> DispatchPlan:
        """The ``k_mode='auto'`` plan for this grid at the reuse horizon
        ``runs`` (1 for a cold :meth:`run`, ``math.inf`` for
        :meth:`warmup`'s steady state): by K alone, every bucket on every
        tier of the bank.  The cost model sees the signatures already run
        through ``is_cached``, so a warmed arena's plans snap to them."""
        def is_cached(bucket) -> bool:
            return (bank_layout_key(bank, bucket.tiers), int(bucket.k_pad),
                    self._shards(), eval_key, use_dropout) in self._fns

        return plan_dispatch(
            grid.sample_count, rounds=num_rounds,
            tier_work=self._tier_work(bank), cost_model=self.cost_model,
            max_executables=self.max_executables, is_cached=is_cached,
            runs=runs)

    def _run_plan(self, global_params: Params, sp: sm.SystemParams, bank,
                  grid: ScenarioGrid, h_all: torch.Tensor,
                  lr_seq: np.ndarray, plan: DispatchPlan, *, eval_bank,
                  eval_every, drop_all, replay, chunk_size, chunk_store,
                  digests):
        """Run every bucket of ``plan`` (:meth:`_run_group`) and stitch
        the lanes back to grid order: params with one ``index_select``
        per leaf over the inverse permutation, queues and metrics on the
        host, ``selected`` padded with -1 to ``K_max``.  Returns
        ``(params, queues, metrics, executables_built, bucket_meta)``."""
        dev = self.device
        k_max = int(grid.sample_count.max())
        tiers_all = (list(range(bank.num_tiers))
                     if getattr(bank, "num_tiers", 1) > 1 else None)
        rep_sel, rep_keys = replay
        shards = self._shards()
        whole = plan.num_buckets == 1 and self.mesh is None
        parts, bucket_meta, built_total = [], [], 0
        for b in plan.buckets:
            idx = np.asarray(b.lanes, np.int64)
            span = None
            if self.mesh is not None:
                if idx.size % shards:
                    raise ValueError(
                        f"scenario count {idx.size} not divisible by mesh "
                        f"axis {self.mesh_axis!r} size {shards} (per-K "
                        f"group sizes must split evenly across shards)")
                span = mesh_lib.contiguous_block(idx.size, self.mesh,
                                                 self.mesh_axis)
            mine = idx if span is None else idx[span[0]:span[1]]
            idx_t = torch.as_tensor(mine, device=dev)

            def pick(x, slots: bool = False):
                if x is None:
                    return None
                x = x if whole else x.index_select(0, idx_t)
                return x[:, :, :b.k_pad] if slots else x

            p_g, q_g, m_g, nd, built = self._run_group(
                global_params, sp, bank, grid if whole else grid.take(mine),
                pick(h_all), lr_seq, b.k_pad, eval_bank=eval_bank,
                eval_every=eval_every, drop_all=pick(drop_all),
                replay=(pick(rep_sel, True), pick(rep_keys, True)),
                tier_subset=b.tiers, chunk_size=chunk_size,
                chunk_store=chunk_store, digests=digests,
                bucket_grid=None if span is None else grid.take(idx),
                span=span)
            if span is not None:
                with obs.span("arena.gather", lanes=int(idx.size),
                              shards=shards):
                    p_g, q_g, m_g = self._gather_lanes((p_g, q_g, m_g))
            built_total += built
            bucket_meta.append(dict(
                lanes=[int(i) for i in idx], k_pad=int(b.k_pad),
                tiers=tiers_all if b.tiers is None else list(b.tiers),
                dispatches=int(nd), executables_built=int(built)))
            parts.append((p_g, q_g, m_g))
        if whole:
            params, queues, metrics = parts[0]
            return (params, queues.cpu().numpy(), metrics, built_total,
                    bucket_meta)
        inv = plan.inverse_permutation()
        inv_t = torch.as_tensor(inv, device=dev)
        params = {name: torch.cat([p[name] for p, _, _ in parts])
                  .index_select(0, inv_t) for name in parts[0][0]}
        queues = np.concatenate([q.cpu().numpy() for _, q, _ in parts])[inv]
        metrics = {}
        for name in parts[0][2]:
            cols = []
            for _, _, m in parts:
                v = m[name]
                if name == "selected" and v.shape[-1] < k_max:
                    v = np.concatenate([v, np.full(
                        v.shape[:-1] + (k_max - v.shape[-1],), -1,
                        v.dtype)], axis=-1)
                cols.append(v)
            metrics[name] = np.concatenate(cols)[inv]
        return params, queues, metrics, built_total, bucket_meta

    # -- entry point ----------------------------------------------------------

    def run(self, global_params: Params, sp: sm.SystemParams, bank,
            grid: ScenarioGrid, num_rounds: int, lr_seq,
            *, h_all=None, drop_all=None, eval_bank=None,
            eval_every: Optional[int] = None,
            chunk_size: Optional[int] = None, chunk_store=None,
            replay_selected=None, replay_sort_keys=None) -> RolloutReport:
        """Run every scenario of ``grid`` for ``num_rounds`` rounds.

        ``global_params``: the shared initial model (never modified).
        ``sp``: base SystemParams — each lane takes K and the scaled
        energy budget from the grid.  ``bank``: the shared read-only
        client bank (single bucket, ladder or pool; fp32 or int8).
        ``lr_seq``: ``[T]`` learning rates shared across
        scenarios.  ``h_all``: optional ``[S, T, N]`` channels (default
        :meth:`sample_channels`).  ``drop_all``: optional ``[S, T, N]``
        alive masks (default :meth:`sample_dropout` when any lane has
        ``dropout > 0``).  ``eval_bank``: an
        :class:`~repro_torch.sim.eval.EvalBank` evaluating the final
        ``[S, ...]`` params in one batched call (``final_metrics``);
        ``eval_every``: also evaluate inside the rollout every that many
        rounds (``test_*`` columns).  ``chunk_size`` (default the
        arena's) and ``chunk_store``: the chunked, checkpointed pipeline
        (see the class docstring); bitwise the one-shot run, and so is a
        run resumed from a checkpoint.  ``replay_selected`` (``[S, T,
        K_max]``) and ``replay_sort_keys`` (``[S, T, K_max, E, B]``)
        replace the draws, for the parity tests only.

        Lane s reproduces ``run_scan`` under the contract of the module
        docstring.  Returns a :class:`RolloutReport` whose ``meta`` holds
        the plan, each bucket's lanes, ``k_pad``, tiers, ``dispatches``
        and ``executables_built``, the run's ``chunk_size``,
        ``executables_built``, ``executables_cached`` and ``traces``.
        The run's counts are folded into ``metrics`` and an attached
        watchdog is told of it.
        """
        run_span = obs.span("arena.run", k_mode=self.k_mode,
                            lanes=len(grid), rounds=int(num_rounds))
        with run_span:
            report = self._run_impl(
                global_params, sp, bank, grid, num_rounds, lr_seq,
                h_all=h_all, drop_all=drop_all, eval_bank=eval_bank,
                eval_every=eval_every, chunk_size=chunk_size,
                chunk_store=chunk_store, replay_selected=replay_selected,
                replay_sort_keys=replay_sort_keys)
            run_span.set(dispatches=int(report.meta["dispatches"]),
                         executables_built=int(
                             report.meta["executables_built"]))
        m = self.metrics
        m.counter("arena.runs").inc()
        m.counter("arena.dispatches").inc(int(report.meta["dispatches"]))
        m.counter("arena.executables_built").inc(
            int(report.meta["executables_built"]))
        m.gauge("arena.executables_cached").set(len(self._fns))
        if self.watchdog is not None:
            self.watchdog.observe_run(self, report.meta)
        return report

    def _run_impl(self, global_params: Params, sp: sm.SystemParams, bank,
                  grid: ScenarioGrid, num_rounds: int, lr_seq, *,
                  h_all=None, drop_all=None, eval_bank=None,
                  eval_every=None, chunk_size=None, chunk_store=None,
                  replay_selected=None, replay_sort_keys=None
                  ) -> RolloutReport:
        """(The uninstrumented body of :meth:`run`.)"""
        s, n, dev = len(grid), sp.num_devices, self.device
        ScenarioGrid._check_sample_counts(grid.sample_count, n)
        if sp.device.type != dev.type:
            raise ValueError(f"SystemParams live on {sp.device}, the arena "
                             f"on {dev}")
        if eval_every is not None and eval_bank is None:
            raise ValueError("eval_every requires an eval_bank")
        lr_seq = np.asarray(lr_seq, np.float32)
        if lr_seq.shape != (num_rounds,):
            raise ValueError(f"lr_seq must have shape ({num_rounds},), "
                             f"got {lr_seq.shape}")
        h_derived = h_all is None
        if h_derived:
            h_all = self.sample_channels(grid, num_rounds, n)
        h_all = torch.as_tensor(np.array(h_all, np.float32)
                                if not isinstance(h_all, torch.Tensor)
                                else h_all, dtype=torch.float32, device=dev)
        if tuple(h_all.shape) != (s, num_rounds, n):
            raise ValueError(f"h_all must have shape {(s, num_rounds, n)}, "
                             f"got {tuple(h_all.shape)}")
        drop_given = drop_all is not None
        if drop_all is None and np.any(np.asarray(grid.dropout) > 0.0):
            drop_all = self.sample_dropout(grid, num_rounds, n)
        if drop_all is not None:
            drop_all = torch.as_tensor(
                drop_all if isinstance(drop_all, torch.Tensor)
                else np.asarray(drop_all, np.float32),
                dtype=torch.float32, device=dev)
            if tuple(drop_all.shape) != (s, num_rounds, n):
                raise ValueError(f"drop_all must have shape "
                                 f"{(s, num_rounds, n)}, got "
                                 f"{tuple(drop_all.shape)}")
        ks = np.unique(grid.sample_count)
        k_max = int(ks.max())
        rep_sel = (None if replay_selected is None else torch.as_tensor(
            np.asarray(replay_selected).astype(np.int64), device=dev))
        rep_keys = (None if replay_sort_keys is None else torch.as_tensor(
            np.asarray(replay_sort_keys, np.float32), device=dev))
        for got, want, what in (
                (rep_sel, (s, num_rounds, k_max), "replay_selected"),
                (rep_keys, (s, num_rounds, k_max,
                            self.engine.cfg.local_epochs,
                            bank.bucket_examples), "replay_sort_keys")):
            if got is not None and tuple(got.shape) != want:
                raise ValueError(f"{what} must be {list(want)}, got "
                                 f"{list(got.shape)}")
        if chunk_size is None:
            chunk_size = self.chunk_size
        digests = ()
        if chunk_store is not None:
            # the content of what a caller passed in (the grid's own
            # channels and masks are functions of the grid, in the tag)
            digests = (
                ("sp", _system_params_digest(sp)),
                ("bank", self._bank_digest(bank)),
                ("engine", repr(self.engine.cfg), self.engine.impl),
                ("h", "auto" if h_derived else _content_digest(h_all)),
                ("drop", _content_digest(drop_all) if drop_given
                 else "auto"),
                ("params", _content_digest(global_params)),
                ("replay", [None if r is None else _content_digest(r)
                            for r in (rep_sel, rep_keys)]),
                ("test_set", None if not eval_every else _content_digest(
                    {"x": eval_bank.x, "y": eval_bank.y})))
        meta = dict(k_mode=self.k_mode, k_groups=[int(k) for k in ks],
                    k_max=k_max, batch=self.batch, shards=self._shards(),
                    chunk_size=(None if chunk_size is None
                                else int(chunk_size)),
                    bank_storage=bank.storage, bank_nbytes=int(bank.nbytes),
                    bank_bytes_per_client=bank.bytes_per_client,
                    bank_layout=bank_layout_key(bank),
                    tier_work=self._tier_work(bank))
        with obs.span("arena.plan", k_mode=self.k_mode, lanes=s,
                      k_max=k_max):
            plan = self._mode_plan(bank, grid, num_rounds, runs=1.0,
                                   eval_key=self._eval_key(eval_bank,
                                                           eval_every),
                                   use_dropout=drop_all is not None)
        traces = self.traces
        params, queues, metrics, built, buckets = self._run_plan(
            global_params, sp, bank, grid, h_all, lr_seq, plan,
            eval_bank=eval_bank, eval_every=eval_every, drop_all=drop_all,
            replay=(rep_sel, rep_keys), chunk_size=chunk_size,
            chunk_store=chunk_store, digests=digests)
        meta.update(dispatches=sum(b["dispatches"] for b in buckets),
                    executables_built=int(built),
                    executables_cached=len(self._fns),
                    traces=self.traces - traces,
                    plan=plan.describe(), buckets=buckets)
        return RolloutReport(grid=grid, num_rounds=num_rounds,
                             params=params, queues=queues, metrics=metrics,
                             meta=meta,
                             final_metrics=self._final_eval(eval_bank,
                                                            params))

    def _mode_plan(self, bank, grid: ScenarioGrid, num_rounds: int, *,
                   runs: float, eval_key, use_dropout: bool
                   ) -> DispatchPlan:
        """The plan of the arena's ``k_mode`` for ``grid``: the padded
        single bucket, one bucket per distinct K, or (``'auto'``)
        :meth:`_plan` at the horizon ``runs``."""
        if self.k_mode == "auto":
            return self._plan(bank, grid, num_rounds, runs=runs,
                              eval_key=eval_key, use_dropout=use_dropout)
        if self.k_mode == "pad" or np.unique(grid.sample_count).size == 1:
            return DispatchPlan.padded(grid.sample_count)
        return DispatchPlan.grouped(grid.sample_count)

    def _tier_work(self, bank) -> Dict[int, float]:
        """``{tier: rows trained per slot per round}`` (local epochs x
        steps per epoch x batch), per rung of a ladder; a one-bucket
        bank is tier 0 — the JAX package's cost-model weights."""
        banks = bank.tiers if isinstance(bank, TieredClientBank) else [bank]
        epochs = float(self.engine.cfg.local_epochs)
        return {t: epochs * b.steps_per_epoch * b.batch_size
                for t, b in enumerate(banks)}

    def _final_eval(self, eval_bank, params_stacked: Params
                    ) -> Dict[str, np.ndarray]:
        """One batched ``task.metrics`` call over the final ``[S, ...]``
        params."""
        if eval_bank is None:
            return {}
        with obs.span("arena.eval", what="final"):
            return {"test_" + name: v for name, v in
                    eval_bank.evaluate_stacked(params_stacked).items()}

    def warmup(self, global_params: Params, sp: sm.SystemParams, bank,
               grid: ScenarioGrid, num_rounds: int, lr_seq=None, *,
               h_all=None, eval_bank=None, eval_every: Optional[int] = None,
               aot: Optional[bool] = None,
               chunk_size: Optional[int] = None) -> dict:
        """Run every bucket signature a same-shape :meth:`run` will hit,
        so iterating on grid VALUES (V, lam, seeds, channels; shapes
        fixed) does no cold work again.  The plan is the arena's
        ``k_mode``'s: the padded single bucket, every per-K group, or
        (``'auto'``) the steady-state plan at ``runs=math.inf``.

        Each bucket runs ``min(T, max(1, eval_every or 1))`` rounds, so
        an in-rollout evaluation runs once, then one final batched
        evaluation.  With ``chunk_size`` (default the arena's) and
        ``T > chunk_size`` the bucket runs as a chunk and its
        continuation, so the resume signature is warm too.  On a ladder
        the warm rounds replay selections that cycle every lane's slots
        through every tier (one client of each), as
        ``FederatedTrainer.warmup`` reaches every tier's SGD.

        ``aot``: eager PyTorch has no ahead-of-time path
        (:func:`aot_cache_warmup_supported` is False), so ``None`` and
        ``False`` run the buckets and ``True`` raises ``ValueError``.

        Nothing observable changes: the results are discarded, no chunk
        store is written, ``arena.runs`` does not move, the bank and the
        params are read only.  Returns ``{'executables_built',
        'executables_cached', 'traces', 'aot', 'plan'}``; an attached
        watchdog arms at the end."""
        if aot:
            raise ValueError(
                "Arena.warmup(aot=True): eager PyTorch compiles nothing "
                "ahead of a run (aot_cache_warmup_supported() is False); "
                "warmup runs each bucket instead (aot=None)")
        warm_span = obs.span("arena.warmup", k_mode=self.k_mode,
                             lanes=len(grid), rounds=int(num_rounds))
        warm_span.__enter__()
        before = self.traces
        s, n, dev = len(grid), sp.num_devices, self.device
        if lr_seq is None:
            lr_seq = np.zeros(num_rounds, np.float32)
        lr_seq = np.asarray(lr_seq, np.float32)
        if h_all is None:
            h_all = self.sample_channels(grid, num_rounds, n)
        h_all = torch.as_tensor(h_all, dtype=torch.float32, device=dev)
        drop_all = None
        if np.any(np.asarray(grid.dropout) > 0.0):
            drop_all = self.sample_dropout(grid, num_rounds, n)
        if chunk_size is None:
            chunk_size = self.chunk_size
        ek = self._eval_key(eval_bank, eval_every)
        plan = self._mode_plan(bank, grid, num_rounds, runs=math.inf,
                               eval_key=ek, use_dropout=drop_all is not None)
        warm = min(num_rounds, max(1, int(eval_every or 1)))
        chunk = None
        if chunk_size is not None and num_rounds > chunk_size:
            # a first chunk and one continuation reach both signatures
            chunk = min(warm, max(1, int(chunk_size)))
            warm = max(warm, chunk + 1)
        rep_sel = None
        if getattr(bank, "num_tiers", 1) > 1:
            reps = [int(m[0]) for m in bank.tier_members]
            k_max = int(grid.sample_count.max())
            slot = (np.arange(s)[:, None, None] * k_max
                    + np.arange(warm)[None, :, None]
                    + np.arange(k_max)[None, None, :])
            rep_sel = torch.as_tensor(np.asarray(reps)[slot % len(reps)],
                                      device=dev)
        params, _, _, built, _ = self._run_plan(
            global_params, sp, bank, grid, h_all[:, :warm], lr_seq[:warm],
            plan, eval_bank=eval_bank, eval_every=eval_every,
            drop_all=None if drop_all is None else drop_all[:, :warm],
            replay=(rep_sel, None), chunk_size=chunk, chunk_store=None,
            digests=())
        self._final_eval(eval_bank, params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result = {"executables_built": int(built),
                  "executables_cached": len(self._fns),
                  "traces": self.traces - before,
                  "aot": False, "plan": plan.describe()}
        warm_span.set(executables_built=int(built), aot=False)
        warm_span.__exit__(None, None, None)
        if self.watchdog is not None:
            self.watchdog.arm(self)
        return result
