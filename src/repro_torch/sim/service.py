"""SweepService — a long-lived sweep loop over the scenario arena: the
port of ``repro.sim.service``.

The paper's comparison (Fig. 3-6) needs thousands of rounds per
controller.  On a shared card a run that long has to be cut into chunks,
survive a kill, and resume where it stopped.  The service turns the
arena's chunked pipeline (``Arena.run(chunk_size=, chunk_store=)``) into
that loop:

* **Submission queue.**  ``submit(grid, num_rounds, lr_seq)`` enqueues a
  :class:`~repro_torch.sim.arena.ScenarioGrid` and returns a ticket;
  nothing runs until :meth:`SweepService.process_once` /
  :meth:`SweepService.run_pending` drains the queue.
* **Coalescing.**  Pending submissions with the same round count and
  learning-rate schedule (channels, seeds, V, lam and K are per-lane
  data) concatenate into ONE grid (``ScenarioGrid.concat``) of at most
  ``max_lanes`` lanes, run as one arena call under its dispatch plan,
  and split back per submission with ``RolloutReport.take``.  The
  arena draws every lane's channels from its grid seeds.
* **Crash-safe checkpoints.**  With ``checkpoint_dir``, every
  ``checkpoint_every``-th chunk boundary saves the carry (params, queues,
  the last in-rollout evaluation, its round) and the columns so far through
  ``repro_torch.checkpoint`` (atomic npz + manifest).  A killed service
  that resubmits the same grid resumes mid-rollout and finishes bitwise
  like an uninterrupted run: the tag is a content hash of the inputs
  that shape the trajectory, the carry round-trips exactly, and the lane
  body resumes at the global round.

The service holds no training state of its own (the initial params and
the bank are shared, read-only), so one instance serves any number of
grids.  :meth:`SweepService.warmup` warms the arena for a submission
shape (``Arena.warmup``).
"""

from __future__ import annotations

import dataclasses
import itertools
import socket
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (checkpoint_exists, delete_checkpoint,
                                    restore_arrays, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sim.arena import ScenarioGrid
from repro_torch.sim.report import RolloutReport

#: carry-manifest wire-format version.  Bump when the chunk carry's tree,
#: its dtypes, or the metrics-first/carry-second commit order change
#: incompatibly: a store then refuses to resume from the stale file
#: instead of mis-restoring it.
CHUNK_STORE_SCHEMA_VERSION = 1


class NpzChunkStore:
    """The arena's chunk-checkpoint protocol over
    ``repro_torch.checkpoint``.

    One checkpoint pair per in-flight bucket tag: ``<tag>_metrics`` (the
    columns so far, ``[S, t, ...]``, a flat dict restored structure-free
    by ``restore_arrays``) and ``<tag>_carry``, the chunk carry as the
    arena's named tree::

        {"params": {leaf: [S, ...]}, "queues": [S, N],
         "last_ev": {metric: [S]},     # with in-rollout evaluation only
         "t": int64 scalar}            # the round the carry resumes at

    restored through the ``like`` tree that ``carry_like(s)`` builds
    (tensors on the arena's device, so the carry lands there).  The JAX
    package's carry also holds each lane's rng; the port's draws are
    counter-based (keyed by the rollout key and the global round), so its
    carry has none.  Metrics save FIRST, carry second, each file of a
    pair replaced atomically.  The round ``t`` a carry resumes at is read
    from the carry's own npz, never from its manifest: a kill between the
    npz and the manifest of one save leaves a carry newer than its
    manifest, which then resumes at the carry's round.  A crash between
    the metrics and the carry leaves metrics ahead of the carry, which
    :meth:`load` trims; metrics behind the carry (no order of saves
    leaves them so) are refused.  ``every`` is the arena-side cadence:
    save at every ``every``-th chunk boundary (1 = each)."""

    def __init__(self, directory: str, carry_like, every: int = 1,
                 metrics: Optional[MetricsRegistry] = None):
        self.directory = directory
        self.carry_like = carry_like
        self.every = max(1, int(every))
        #: shared metrics registry (the owning service passes the
        #: arena's, so ``store.saves`` / ``store.loads`` land in the same
        #: namespace); a standalone store gets its own
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    @property
    def saves(self) -> int:
        """Completed :meth:`save` calls (view over ``store.saves``)."""
        return self.metrics.counter("store.saves").value

    @property
    def loads(self) -> int:
        """Successful :meth:`load` hits (view over ``store.loads``)."""
        return self.metrics.counter("store.loads").value

    def load(self, tag: str):
        """``(t, carry, metrics)`` of the checkpoint under ``tag``, or
        None when there is none."""
        if not checkpoint_exists(self.directory, f"{tag}_carry"):
            return None
        with obs.span("store.load", tag=tag):
            _, md = restore_arrays(self.directory, f"{tag}_carry")
            found = int(md.get("schema_version", 0))
            if found != CHUNK_STORE_SCHEMA_VERSION:
                raise ValueError(
                    f"chunk checkpoint {tag!r} in {self.directory!r} "
                    f"was written with carry schema_version {found} "
                    f"(written by host {md.get('host', '?')!r}, torch "
                    f"{md.get('torch_version', '?')} at "
                    f"{md.get('saved_at', '?')}); this build expects "
                    f"schema_version {CHUNK_STORE_SCHEMA_VERSION} and "
                    f"refuses to resume from an incompatible carry — "
                    f"delete the stale checkpoint (or finish it with a "
                    f"matching build) and resubmit")
            like = dict(self.carry_like(int(md["s"])),
                        t=np.zeros((), np.int64))
            carry, _ = restore_checkpoint(self.directory, f"{tag}_carry",
                                          like=like)
            t = int(carry.pop("t"))
            metrics, _ = restore_arrays(self.directory, f"{tag}_metrics")
            short = [k for k, v in metrics.items() if v.shape[1] < t]
            if short:
                raise ValueError(
                    f"chunk checkpoint {tag!r} in {self.directory!r}: the "
                    f"carry is at round {t} but the columns {short[:3]} "
                    f"stop earlier; refusing to resume")
            # a crash after the metrics save but before the carry save
            # leaves metrics AHEAD of the carry's round: trim to it
            # (axis 1 is the round axis of every column)
            metrics = {k: v[:, :t] for k, v in metrics.items()}
        self.metrics.counter("store.loads").inc()
        return t, carry, metrics

    def save(self, tag: str, t_next: int, carry: dict,
             metrics: Dict[str, np.ndarray]) -> None:
        s = int(carry["queues"].shape[0])
        # the carry manifest doubles as provenance: which wire format,
        # which host and torch wrote it, when, and which trajectory (the
        # tag is the content digest of everything that shapes it)
        md = {"t": int(t_next), "s": s,
              "schema_version": CHUNK_STORE_SCHEMA_VERSION,
              "host": socket.gethostname(),
              "torch_version": torch.__version__,
              "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S",
                                        time.gmtime()) + "Z",
              "grid_digest": tag}
        with obs.span("store.save", tag=tag, t=int(t_next), lanes=s):
            save_checkpoint(self.directory, f"{tag}_metrics",
                            dict(metrics), metadata=md)
            save_checkpoint(self.directory, f"{tag}_carry",
                            dict(carry, t=np.asarray(t_next, np.int64)),
                            metadata=md)
        self.metrics.counter("store.saves").inc()

    def finish(self, tag: str) -> None:
        delete_checkpoint(self.directory, f"{tag}_carry")
        delete_checkpoint(self.directory, f"{tag}_metrics")


@dataclasses.dataclass
class _Submission:
    ticket: int
    grid: ScenarioGrid
    num_rounds: int
    lr_seq: np.ndarray


class SweepService:
    """A long-lived sweep loop owning a :class:`repro_torch.sim.Arena`.

    ``arena`` / ``params0`` / ``sp`` / ``bank`` are what every submission
    runs on (``eval_bank`` / ``eval_every`` add the evaluation on the
    device).  ``chunk_size`` selects the chunked pipeline for every run
    (None = the arena's default); ``max_lanes`` caps the lanes of one
    coalesced batch; ``checkpoint_dir`` + ``checkpoint_every`` enable the
    crash-safe chunk store (``self.store``; tests wrap its ``save`` to
    simulate kills).

    ``stats`` is a view over the shared registry's ``service.*``
    counters: completed ``batches`` and ``scenarios``, the per-batch
    ``coalesced_lanes`` and busy ``seconds`` (submit-to-drain wall time
    of :meth:`run_pending`).
    """

    def __init__(self, arena, params0, sp, bank, *, eval_bank=None,
                 eval_every: Optional[int] = None,
                 chunk_size: Optional[int] = None, max_lanes: int = 16,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1):
        if eval_every is not None and eval_bank is None:
            raise ValueError("eval_every requires an eval_bank")
        self.arena = arena
        self.params0 = params0
        self.sp = sp
        self.bank = bank
        self.eval_bank = eval_bank
        self.eval_every = eval_every
        self.chunk_size = (chunk_size if chunk_size is not None
                           else arena.chunk_size)
        self.max_lanes = int(max_lanes)
        #: the arena's registry, shared: ``service.*`` and ``store.*``
        #: land beside ``arena.*``, so one ``metrics.snapshot()`` captures
        #: the whole stack
        self.metrics = arena.metrics
        self.store = None
        if checkpoint_dir is not None:
            self.store = NpzChunkStore(checkpoint_dir, self._carry_like,
                                       every=checkpoint_every,
                                       metrics=self.metrics)
        self._queue: List[_Submission] = []
        self._results: Dict[int, RolloutReport] = {}
        self._tickets = itertools.count()

    @property
    def stats(self) -> Dict[str, Any]:
        m = self.metrics
        return {
            "batches": m.counter("service.batches").value,
            "scenarios": m.counter("service.scenarios").value,
            "coalesced_lanes": [
                int(v) for v in
                m.histogram("service.coalesced_lanes").values],
            "seconds": m.gauge("service.seconds").value,
        }

    # -- checkpoint structure -----------------------------------------------

    def _carry_like(self, s: int) -> dict:
        """The ``like`` tree a checkpointed carry of ``s`` lanes restores
        into, rebuilt from the service's config alone (the params'
        shapes, N, the EvalBank's carry struct), so a fresh process
        restores a file it never wrote; on the arena's device."""
        dev = self.arena.device
        like = {
            "params": {name: torch.empty((s,) + tuple(v.shape),
                                         dtype=v.dtype, device=dev)
                       for name, v in self.params0.items()},
            "queues": torch.empty((s, self.sp.num_devices),
                                  dtype=torch.float32, device=dev),
        }
        if self.eval_bank is not None and self.eval_every:
            like["last_ev"] = {
                name: torch.empty(st.shape, dtype=st.dtype, device=dev)
                for name, st in self.eval_bank.carry_struct(
                    self.params0, s).items()}
        return like

    # -- the queue ----------------------------------------------------------

    def submit(self, grid: ScenarioGrid, num_rounds: int,
               lr_seq=None) -> int:
        """Enqueue a grid; returns a ticket for :meth:`result`."""
        ScenarioGrid._check_sample_counts(grid.sample_count,
                                          self.sp.num_devices)
        if lr_seq is None:
            lr_seq = np.zeros(num_rounds, np.float32)
        lr_seq = np.asarray(lr_seq, np.float32)
        if lr_seq.shape != (num_rounds,):
            raise ValueError(f"lr_seq must have shape ({num_rounds},), "
                             f"got {lr_seq.shape}")
        if len(grid) > self.max_lanes:
            raise ValueError(f"submission of {len(grid)} lanes exceeds "
                             f"max_lanes={self.max_lanes}")
        ticket = next(self._tickets)
        self._queue.append(_Submission(ticket, grid, num_rounds, lr_seq))
        self.metrics.gauge("service.queue_depth").set(len(self._queue))
        return ticket

    def pending(self) -> int:
        return len(self._queue)

    def _coalesce(self) -> List[_Submission]:
        """Pop the queue head plus every later submission compatible
        with it (same T and lr schedule) that still fits
        ``max_lanes``, FIFO order kept,
        incompatible submissions left queued."""
        head = self._queue.pop(0)
        batch = [head]
        lanes = len(head.grid)
        rest: List[_Submission] = []
        for sub in self._queue:
            if (sub.num_rounds == head.num_rounds and
                    np.array_equal(sub.lr_seq, head.lr_seq) and
                    lanes + len(sub.grid) <= self.max_lanes):
                batch.append(sub)
                lanes += len(sub.grid)
            else:
                rest.append(sub)
        self._queue = rest
        return batch

    # -- execution ----------------------------------------------------------

    def warmup(self, grid: ScenarioGrid, num_rounds: int,
               lr_seq=None) -> dict:
        """Warm the arena for this submission shape (the chunked
        continuation included): ``Arena.warmup`` with the service's
        ``eval_bank``, ``eval_every`` and ``chunk_size``.  Steady-state
        submissions of that shape then do no cold work."""
        return self.arena.warmup(self.params0, self.sp, self.bank, grid,
                                 num_rounds, lr_seq,
                                 eval_bank=self.eval_bank,
                                 eval_every=self.eval_every,
                                 chunk_size=self.chunk_size)

    def process_once(self) -> List[int]:
        """Run ONE coalesced batch through the arena; returns the
        completed tickets (empty when the queue is idle)."""
        if not self._queue:
            return []
        batch = self._coalesce()
        grid = (batch[0].grid if len(batch) == 1
                else ScenarioGrid.concat([b.grid for b in batch]))
        self.metrics.gauge("service.queue_depth").set(len(self._queue))
        t_start = time.perf_counter()
        with obs.span("service.batch", tickets=len(batch),
                      lanes=len(grid), rounds=int(batch[0].num_rounds),
                      queue_depth=len(self._queue)):
            rep = self.arena.run(
                self.params0, self.sp, self.bank, grid,
                batch[0].num_rounds, batch[0].lr_seq,
                eval_bank=self.eval_bank, eval_every=self.eval_every,
                chunk_size=self.chunk_size, chunk_store=self.store)
            offset = 0
            for sub in batch:
                n = len(sub.grid)
                self._results[sub.ticket] = (
                    rep if len(batch) == 1
                    else rep.take(np.arange(offset, offset + n)))
                offset += n
        m = self.metrics
        m.counter("service.batches").inc()
        m.counter("service.scenarios").inc(len(grid))
        m.histogram("service.coalesced_lanes").observe(len(grid))
        m.gauge("service.seconds").add(time.perf_counter() - t_start)
        return [b.ticket for b in batch]

    def run_pending(self) -> List[int]:
        """Drain the whole queue; returns every completed ticket.  The
        final wait for the card makes the service's seconds measure
        finished work."""
        done: List[int] = []
        while self._queue:
            done.extend(self.process_once())
        if done and self.arena.device.type == "cuda":
            t_block = time.perf_counter()
            with obs.span("service.reduce", tickets=len(done)):
                torch.cuda.synchronize(self.arena.device)
            self.metrics.gauge("service.seconds").add(
                time.perf_counter() - t_block)
        return done

    def result(self, ticket: int) -> RolloutReport:
        """The completed report for ``ticket`` (popped: each result is
        handed out once)."""
        if ticket not in self._results:
            raise KeyError(f"ticket {ticket} has no completed result "
                           f"(pending submissions: {self.pending()})")
        return self._results.pop(ticket)
