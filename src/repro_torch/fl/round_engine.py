"""Device-resident FL round engine over a client bank — the port of
``repro.fl.round_engine.RoundEngine``: one round
(:meth:`RoundEngine.round_step`) and a whole rollout of Algorithm 1
(:meth:`RoundEngine.run_scan`), on a single-bucket ``ClientBank``, the
tier ladder (``TieredClientBank``) or a ``BankPool``, fp32 or int8.

A round is

    gather the K selected rows of the bank       (index_select on device;
                                                  int8 rows dequantized
                                                  right after it)
      -> K-client batched E-epoch local SGD       (client.batched_local_sgd)
      -> eq.-(4) aggregation                      (server.aggregate_fused;
                                                   ONE hand-written CUDA
                                                   fl_aggregate launch)

with no per-round host-to-device transfer of client data.  One gather
(:func:`_gather`) feeds one training core (:meth:`RoundEngine._train`)
on every path.

The tier ladder.  The JAX package runs all K slots through every tier
the selection hits (non-members gather row 0 with a zeroed coefficient)
and sums the tiers' aggregates.  The port computes the same eq. (4)
without that zeroed work: the K slots are routed by ``tier_of``, each
tier that gets a member trains only its member slots (one
``batched_local_sgd`` at its ``steps_per_epoch``, on the first ``B_t``
columns of the slots' epoch keys), the deltas go back to slot order,
and ONE ``fl_aggregate`` launch reduces all K of them — however many
tiers the round hits.  Padded and dropped slots still train, as in the
reference, with coefficient 0.  The result differs from the reference
only in the f32 order of the cross-tier sum.  A selection inside one
tier, and every round of a one-tier ladder, is that tier's
single-bucket round, bit for bit.

``run_scan`` runs T rounds of decide -> select -> train -> aggregate ->
queue update under any controller of ``repro_torch.core.policy.POLICIES``
as a Python loop whose state (params, queues, per-round metrics) stays
on the device: the host reads back what Algorithm 2's while-loops read
(one norm per iteration), the metrics once, at the end, and — on a
multi-tier ladder — the K slots' tier ids once per round, since the
sizes of the tier calls depend on them.

The scenario arena (``repro_torch.sim.Arena``) runs S such rollouts as
one (:meth:`RoundEngine._build_lanes`): the same per-round control plane
per lane, one gather (per hit tier), one SGD over S·K_max clients (per
hit tier; the S·K tier ids read back once per round) and one
lane-batched eq.-(4) launch per round (:meth:`RoundEngine._lanes_plan`),
or, under ``batch='map'``, each lane's round as ``run_scan`` runs it
(:meth:`RoundEngine._map_plan`).  The lane body resumes from a carry at
any global round, which the arena's chunked, checkpointed runs use.

``round_step(hierarchical=True)`` reduces eq. (4) cluster by cluster
over a bank built with ``clusters=`` (``server.aggregate_hierarchical``,
plain PyTorch).  ``round_step_stacked`` takes host-stacked batches
(``ClientBank.gather_host``) through the same round core.

Client-axis sharding (``mesh=``, a ``launch.mesh`` ``DeviceMesh`` with
the axis ``mesh_axis``; one ``torch.distributed`` rank per shard) — the
reference's ``shard_map`` of the round core.  The control plane runs
replicated on every rank (the same solver, numpy and counter-based
draws give the same bits with no communication); the data plane is
split (:meth:`RoundEngine._sharded_round`): rank r trains the contiguous
slots ``[r K/s, (r + 1) K/s)`` of the selection (K must divide, else
``ValueError`` as in the reference), routed by tier on a ladder; a slot
whose bank row another rank holds (the bank's placement, see
``fl.client_bank``) is fetched with one ``all_to_all`` of packed rows per
tier the selection hits; the rank's partial eq.-(4) term is one
``fl_delta_reduce`` launch, summed over the ranks by one ``all_reduce``
(``server.aggregate_fused_psum``, or ``aggregate_hierarchical_psum``),
so every rank adds the same update and the params stay bitwise
replicated; the losses come back in slot order on every rank.
``round_step`` and ``run_scan`` take this path whenever the engine has a
mesh (a one-rank mesh included); ``round_step_stacked``, whose batches
come from the host, trains them whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import draws
from repro_torch.core import policy as pol
from repro_torch.core import queues as vq
from repro_torch.core import system_model as sm
from repro_torch.data.pipeline import assign_tiers, validate_client_data
from repro_torch.fl import client as fl_client
from repro_torch.fl import server as fl_server
from repro_torch.fl.client_bank import ClientBank, TieredClientBank, widen
from repro_torch.kernels import ref
from repro_torch.kernels.ops import IMPLS
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import trace as obs_trace

Params = Dict[str, torch.Tensor]


def _one_bucket(bank):
    """A one-tier ladder IS its bucket: the tier's bank; else ``bank``."""
    if isinstance(bank, TieredClientBank) and bank.num_tiers == 1:
        return bank.tiers[0]
    return bank


def bank_layout_key(bank, tier_subset=None) -> tuple:
    """The layout of ``bank``'s SGD calls, as the JAX package keys its
    executables: per tier (of ``tier_subset``, default all) ``(tier,
    steps_per_epoch, masked, int8)`` for a multi-tier ladder, else
    ``(steps_per_epoch, masked, int8)``; ``masked`` is ``not
    uniform``, exactly when ``device_args`` returns the step masks."""
    bank = _one_bucket(bank)
    if isinstance(bank, TieredClientBank):
        tiers = (range(bank.num_tiers) if tier_subset is None
                 else tier_subset)
        return tuple((int(t), bank.tiers[t].steps_per_epoch,
                      not bank.tiers[t].uniform,
                      bank.tiers[t].storage == "int8") for t in tiers)
    return (bank.steps_per_epoch, not bank.uniform, bank.storage == "int8")


def _take(bank, idx: torch.Tensor) -> tuple:
    """Rows ``idx`` (``[K]`` int64 on the device) of every stack a
    one-bucket bank holds on this rank: ``(xs, ys, num_steps,
    num_examples, x_scale, x_zero)``, None where the bank has none."""
    return tuple(None if t is None else torch.index_select(t, 0, idx)
                 for t in bank.device_args() + bank.quant_args())


def _finish(rows: tuple):
    """Taken rows -> ``(xs, ys, num_steps, num_examples)`` as the SGD
    reads them, widened here, right after the gather, at ``[K, B,
    ...]``: the banks keep their data's dtypes, and the rows become f32
    features, int64 labels (``client_bank.widen``) and int64 masks,
    exactly.  An int8 bank's rows are dequantized here:
    ``q * scale + zero`` rounded once per element (``ref.fma_f32``), the
    fused multiply-add XLA gives the JAX package's gather
    (``data.pipeline.dequantize_stack``, a product then a sum, may
    differ from it in the last bit)."""
    xs, ys, ns, ne, scale, zero = rows
    xs, ys = widen(xs, ys)
    if scale is not None:
        shape = (-1,) + (1,) * (xs.dim() - 1)
        xs = ref.fma_f32(xs, scale.reshape(shape), zero.reshape(shape))
    return (xs, ys,
            *(None if m is None else m.to(torch.int64) for m in (ns, ne)))


def _gather(bank, idx: torch.Tensor):
    """THE gather: rows ``idx`` of a one-bucket bank -> ``(xs, ys,
    num_steps, num_examples)`` (:func:`_take`, then :func:`_finish`)."""
    return _finish(_take(bank, idx))


def _pack_rows(rows: tuple) -> torch.Tensor:
    """Taken rows (None entries skipped) as one ``[R, bytes]`` uint8
    tensor: each stack's row bytes side by side."""
    return torch.cat([t.reshape(t.shape[0], int(np.prod(
        t.shape[1:], dtype=np.int64))).contiguous().view(torch.uint8)
        for t in rows if t is not None], dim=1)


def _unpack_rows(packed: torch.Tensor, like: tuple) -> tuple:
    """Inverse of :func:`_pack_rows` for ``packed`` rows of the stacks
    ``like`` (each stack's dtype and row shape; None stays None)."""
    out, off = [], 0
    for t in like:
        if t is None:
            out.append(None)
            continue
        width = int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()
        out.append(packed[:, off:off + width].contiguous().view(t.dtype)
                   .reshape((packed.shape[0],) + tuple(t.shape[1:])))
        off += width
    return tuple(out)


def _by_tier(tiers: np.ndarray, tier_sel: np.ndarray, device, train_tier
             ) -> Tuple[Params, torch.Tensor]:
    """The tier routing of both round cores: for each tier ``t`` of
    ``tiers`` in order, ``train_tier(t, m)`` trains the slots ``m`` (int64
    on ``device``) whose entry of ``tier_sel`` (host ``[k]``) is ``t`` and
    returns their deltas and losses (or None when it trains none); the
    results are scattered back to slot order in ``[k, ...]`` buffers."""
    k = len(tier_sel)
    deltas, losses = {}, None
    for t in tiers:
        m = torch.as_tensor(np.flatnonzero(tier_sel == t), device=device)
        got = train_tier(int(t), m)
        if got is None:
            continue
        d, l = got
        if losses is None:
            losses = l.new_empty(k)
            deltas = {name: v.new_empty((k,) + tuple(v.shape[1:]))
                      for name, v in d.items()}
        losses.index_copy_(0, m, l)
        for name, v in d.items():
            deltas[name].index_copy_(0, m, v)
    return deltas, losses


class RoundEngine:
    """Executes FL rounds as device-resident computations on ``device``.

    ``impl`` selects the eq.-(4) path (see ``repro_torch.kernels.ops``):
    'auto' launches the CUDA kernel on a CUDA device and runs the plain
    per-leaf reduce on the CPU.  ``mesh`` (a ``launch.mesh`` mesh with
    the axis ``mesh_axis``) shards the client axis over its ranks (see
    the module docstring); ``device`` is then this rank's device.
    """

    def __init__(self, task, client_cfg: fl_client.ClientConfig,
                 impl: str = "auto", device="cuda", mesh=None,
                 mesh_axis: str = mesh_lib.AXIS):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if mesh is not None:
            mesh_lib.check_mesh(mesh, mesh_axis)
        self.task = task
        self.cfg = client_cfg
        self.impl = impl
        self.device = torch.device(device)
        self.mesh = mesh
        self.mesh_axis = mesh_axis

    def make_bank(self, client_data, tiered: str = "auto",
                  max_tiers: int = 4, storage: str = "fp32",
                  clusters: Optional[int] = None):
        """Build the device-resident bank this engine's rounds gather from.

        ``tiered``: 'auto' builds the :class:`TieredClientBank` ladder when
        the partition spans more than one size tier (``assign_tiers`` with
        ``max_tiers``) and the single-bucket :class:`ClientBank` when it
        fits one; 'single' forces the one global bucket; 'tiered' forces
        the ladder, even of one rung.  ``storage``: 'fp32' or 'int8'
        (per-client affine codes, dequantized in the gather).
        ``clusters``: fit k-means routing for ``round_step(...,
        hierarchical=True)`` — single-bucket banks only.  The bank is
        placed on the engine's mesh (``fl.client_bank``).
        """
        if tiered not in ("auto", "single", "tiered"):
            raise ValueError(f"unknown bank mode {tiered!r}")
        validate_client_data(client_data)
        assignment = None
        if tiered == "auto":
            sizes = [int(np.asarray(x).shape[0]) for x, _ in client_data]
            # the ladder is built from this very assignment
            assignment = assign_tiers(sizes, self.cfg.batch_size, max_tiers)
            tiered = "single" if len(assignment[1]) == 1 else "tiered"
        kw = dict(device=self.device, x_layout=self.task.device_layout,
                  storage=storage, mesh=self.mesh, mesh_axis=self.mesh_axis)
        if tiered == "single":
            return ClientBank(client_data, self.cfg, clusters=clusters, **kw)
        if clusters is not None:
            raise ValueError("clusters= needs a single-bucket bank "
                             "(tiered='single'), got a tier ladder")
        return TieredClientBank(client_data, self.cfg, max_tiers=max_tiers,
                                assignment=assignment, **kw)

    # -- the training core ---------------------------------------------------

    def _sgd(self, params: Params, bank, idx: torch.Tensor, lr,
             sort_keys: torch.Tensor, per_client: bool, tier: int = 0
             ) -> Tuple[Params, torch.Tensor]:
        """One ``batched_local_sgd`` over rows ``idx`` of a one-bucket
        bank (rung ``tier`` of a ladder), on the first ``B`` columns of
        the ``[K, E, >= B]`` keys."""
        with obs_trace.span("engine.train_tier", tier=tier,
                            slots=int(idx.numel()),
                            width=bank.bucket_examples,
                            steps=self.cfg.local_epochs
                            * bank.steps_per_epoch):
            xs, ys, ns, ne = _gather(bank, idx)
            return self._local_sgd(params, xs, ys, ns, ne, lr, sort_keys,
                                   per_client)

    def _local_sgd(self, params: Params, xs: torch.Tensor, ys: torch.Tensor,
                   ns: Optional[torch.Tensor], ne: Optional[torch.Tensor],
                   lr, sort_keys: torch.Tensor, per_client: bool = False
                   ) -> Tuple[Params, torch.Tensor]:
        """THE round core: ``batched_local_sgd`` over ``[K, B, ...]``
        batches in the device layout, on the first ``B`` columns of the
        ``[K, E, >= B]`` keys (every round path trains through here)."""
        rows = xs.shape[1]
        if sort_keys.shape[-1] != rows:
            sort_keys = sort_keys[..., :rows]
        return fl_client.batched_local_sgd(
            self.task.loss_fn, params, xs, ys, lr, self.cfg,
            rows // self.cfg.batch_size, num_steps=ns, num_examples=ne,
            sort_keys=sort_keys, per_client=per_client)

    def _train(self, params: Params, bank, selected: torch.Tensor, lr,
               sort_keys: torch.Tensor, per_client: bool = False,
               tier_sel: Optional[np.ndarray] = None
               ) -> Tuple[Params, torch.Tensor]:
        """Local SGD of the slots ``selected`` (``[K]`` int64 on the
        device) -> deltas ``[K, ...]`` and losses ``[K]`` in slot order.

        A one-bucket bank trains every slot in one call.  A multi-tier
        ladder routes the slots by tier: each tier that gets a member
        trains its member slots in one call (rows from its stacks at
        ``pos_in_tier``), and the results are scattered back to slot
        order.  ``tier_sel`` (host ``[K]``) names the slots' tiers; when
        None they are read back from the device, the one synchronisation
        of a tiered round.  ``per_client``: ``params`` are ``[K, ...]``
        starts, one per slot (the arena's lanes)."""
        bank = _one_bucket(bank)
        if not isinstance(bank, TieredClientBank):
            return self._sgd(params, bank, selected, lr, sort_keys,
                             per_client)
        if tier_sel is None:
            with obs_trace.span("engine.route", slots=int(selected.numel())):
                tier_sel = bank.tier_of_device.index_select(
                    0, selected).cpu().numpy()
        pos = bank.pos_device.index_select(0, selected)

        def train_tier(t: int, m: torch.Tensor):
            starts = ({name: v.index_select(0, m)
                       for name, v in params.items()} if per_client
                      else params)
            return self._sgd(starts, bank.tiers[t], pos.index_select(0, m),
                             lr, sort_keys.index_select(0, m), per_client,
                             tier=t)

        return _by_tier(np.unique(tier_sel), tier_sel, selected.device,
                        train_tier)

    # -- the client-sharded round core ---------------------------------------

    def _shards(self) -> int:
        if self.mesh is None:
            return 1
        return mesh_lib.axis_size(self.mesh, self.mesh_axis)

    def _my_slots(self, k: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's contiguous slots of ``k`` (the
        reference's ``P(axis)`` split of the client axis)."""
        shards = self._shards()
        if k % shards:
            raise ValueError(
                f"sample_count {k} not divisible by mesh axis "
                f"{self.mesh_axis!r} size {shards}")
        return mesh_lib.contiguous_block(k, self.mesh, self.mesh_axis)

    def _fetch(self, bank, rows: np.ndarray, take: np.ndarray, lo: int,
               hi: int):
        """The gathered ``(xs, ys, num_steps, num_examples)`` of this
        rank's slots ``j`` in ``[lo, hi)`` with ``take[j]``, in slot
        order (None when it has none), from ``bank`` (one bucket) at
        ``rows[j]``.  A bank whose rows are split over the mesh serves
        each slot from the rank that holds its row: every rank packs the
        rows the others need (:func:`_pack_rows`) and ONE
        ``all_to_all`` exchanges them — every rank knows the whole
        selection, so the counts need no handshake; every rank calls
        this for the same banks, in the same order."""
        mine = [j for j in range(lo, hi) if take[j]]
        dev = self.device
        if not getattr(bank, "row_sharded", False):
            if not mine:
                return None
            return _gather(bank, torch.as_tensor(rows[mine], device=dev))
        per, shards = bank.rows_held, bank.shards
        me = mesh_lib.axis_rank(self.mesh, self.mesh_axis)
        span = hi - lo
        owner, local = rows // per, rows % per
        send_counts, send_rows, recv_counts, order = [], [], [], []
        for r in range(shards):
            theirs = [j for j in range(r * span, (r + 1) * span)
                      if take[j] and owner[j] == me]
            send_counts.append(len(theirs))
            send_rows += [int(local[j]) for j in theirs]
            from_r = [j for j in mine if owner[j] == r]
            recv_counts.append(len(from_r))
            order += from_r
        taken = _take(bank, torch.as_tensor(np.asarray(send_rows, np.int64),
                                            device=dev))
        packed = mesh_lib.all_to_all_rows(_pack_rows(taken), send_counts,
                                          recv_counts, self.mesh,
                                          self.mesh_axis)
        if not mine:
            return None
        perm = torch.as_tensor([order.index(j) for j in mine], device=dev)
        return _finish(tuple(None if t is None else t.index_select(0, perm)
                             for t in _unpack_rows(packed, taken)))

    def _sharded_train(self, params: Params, bank, selected: np.ndarray,
                       lr, sort_keys: torch.Tensor, lo: int, hi: int
                       ) -> Tuple[Params, torch.Tensor]:
        """Local SGD of this rank's slots ``[lo, hi)`` of ``selected``
        (host ``[K]``) -> deltas ``[hi - lo, ...]`` and losses in slot
        order; on a multi-tier ladder one fetch for every tier the
        selection hits (on every rank) and one SGD call per tier this
        rank's slots hit, as :meth:`_train` routes them."""
        bank = _one_bucket(bank)
        keys = sort_keys[lo:hi]
        if not isinstance(bank, TieredClientBank):
            xs, ys, ns, ne = self._fetch(bank, selected,
                                         np.ones(selected.size, bool), lo, hi)
            return self._local_sgd(params, xs, ys, ns, ne, lr, keys)
        tier_sel = bank.tier_of[selected]
        pos = bank.pos_in_tier[selected].astype(np.int64)

        def train_tier(t: int, m: torch.Tensor):
            got = self._fetch(bank.tiers[t], pos, tier_sel == t, lo, hi)
            if got is None:
                return None
            return self._local_sgd(params, *got, lr, keys.index_select(0, m))

        return _by_tier(np.unique(tier_sel), tier_sel[lo:hi], self.device,
                        train_tier)

    def _sharded_round(self, params: Params, bank, selected: np.ndarray,
                       coeffs: torch.Tensor, lr, sort_keys: torch.Tensor,
                       hierarchical: bool = False
                       ) -> Tuple[Params, torch.Tensor]:
        """THE sharded round: this rank's slots trained
        (:meth:`_sharded_train`), its deltas and coefficients reduced to
        the replicated new params (``server.aggregate_fused_psum``, or
        the hierarchical form over its slots' clusters), and every rank's
        losses gathered in slot order."""
        lo, hi = self._my_slots(int(selected.size))
        deltas, losses = self._sharded_train(params, bank, selected, lr,
                                             sort_keys, lo, hi)
        if hierarchical:
            bank = _one_bucket(bank)
            csel = bank.cluster_of_device.index_select(0, torch.as_tensor(
                selected[lo:hi].astype(np.int64), device=self.device))
            new = fl_server.aggregate_hierarchical_psum(
                params, deltas, coeffs[lo:hi], csel, bank.num_clusters,
                self.mesh, self.mesh_axis)
        else:
            new = fl_server.aggregate_fused_psum(
                params, deltas, coeffs[lo:hi], self.mesh, self.mesh_axis,
                impl=self.impl)
        return new, mesh_lib.all_gather_cat(losses, self.mesh,
                                            self.mesh_axis)

    def round_step(self, global_params: Params, bank,
                   selected: np.ndarray, coeffs: np.ndarray, lr: float,
                   sort_keys: torch.Tensor, hierarchical: bool = False
                   ) -> Tuple[Params, torch.Tensor]:
        """One round gathered from the device-resident bank.

        ``selected``: [K] client indices (slots of a ``BankPool``);
        ``coeffs``: [K] per-draw eq.-(4) weights; ``sort_keys``: [K, E, B]
        uniform epoch-order keys (``B`` the widest rung of a ladder).
        Returns (new global params, per-client losses [K]); the launches
        are queued on the current stream and not waited for.  A ladder
        routes the slots on the host (``tier_of``); an empty selection
        returns a copy of the params.  ``hierarchical=True`` reduces
        eq. (4) over the bank's k-means clusters (a bank built with
        ``clusters=``; single-bucket banks and pools only).  With a
        mesh, :meth:`_sharded_round` (K divisible by the axis size).
        """
        selected = np.asarray(selected)
        if selected.size and not (0 <= int(selected.min()) and
                                  int(selected.max()) < bank.num_clients):
            raise IndexError(
                f"selected indices {selected} out of range for bank of "
                f"{bank.num_clients} clients")
        if hierarchical:
            if isinstance(bank, TieredClientBank):
                raise ValueError("hierarchical aggregation is single-bucket "
                                 "only, got a tier ladder")
            if getattr(bank, "cluster_of_device", None) is None:
                raise ValueError("hierarchical=True needs a bank built with "
                                 "clusters=... (no cluster routing on this "
                                 "bank)")
        bank = _one_bucket(bank)
        dev = self.device
        with obs_trace.span("engine.round", k=int(selected.size)):
            if selected.size == 0:
                return ({name: v.clone() for name, v in
                         global_params.items()},
                        torch.zeros(0, dtype=torch.float32, device=dev))
            if self.mesh is not None:
                return self._sharded_round(
                    global_params, bank, selected.astype(np.int64),
                    torch.as_tensor(np.asarray(coeffs, np.float32),
                                    device=dev), lr,
                    torch.as_tensor(sort_keys, dtype=torch.float32,
                                    device=dev), hierarchical)
            sel = torch.as_tensor(selected.astype(np.int64), device=dev)
            deltas, losses = self._train(
                global_params, bank, sel, lr,
                torch.as_tensor(sort_keys, dtype=torch.float32, device=dev),
                tier_sel=(bank.tier_of[selected]
                          if isinstance(bank, TieredClientBank) else None))
            coeffs = torch.as_tensor(np.asarray(coeffs, np.float32),
                                     device=dev)
            if hierarchical:
                return fl_server.aggregate_hierarchical(
                    global_params, deltas, coeffs,
                    bank.cluster_of_device.index_select(0, sel),
                    bank.num_clusters), losses
            return fl_server.aggregate_fused(global_params, deltas, coeffs,
                                             impl=self.impl), losses

    def round_step_stacked(self, global_params: Params, xs: np.ndarray,
                           ys: np.ndarray, coeffs: np.ndarray, lr: float,
                           sort_keys: torch.Tensor,
                           num_steps: Optional[np.ndarray] = None,
                           num_examples: Optional[np.ndarray] = None
                           ) -> Tuple[Params, torch.Tensor]:
        """The host-stacked round: ``[K, B, ...]`` batches in the host
        (NHWC) layout, as ``ClientBank.gather_host`` returns them,
        uploaded this round, then the same round core and eq.-(4) step as
        :meth:`round_step` — bitwise its result on the same selection."""
        dev = self.device
        xs = self.task.device_layout(torch.as_tensor(
            np.asarray(xs, np.float32), device=dev))
        ys = torch.as_tensor(np.asarray(ys).astype(np.int64), device=dev)

        def mask(v):
            return None if v is None else torch.as_tensor(
                np.asarray(v).astype(np.int64), device=dev)

        deltas, losses = self._local_sgd(
            global_params, xs, ys, mask(num_steps), mask(num_examples),
            lr, torch.as_tensor(sort_keys, dtype=torch.float32, device=dev))
        coeffs = torch.as_tensor(np.asarray(coeffs, np.float32), device=dev)
        return fl_server.aggregate_fused(global_params, deltas, coeffs,
                                         impl=self.impl), losses

    # -- multi-round rollout -----------------------------------------------

    def _scan_plan(self, bank):
        """The data-plane half of a rollout over ``bank``:
        ``round_fn(params, selected, coeffs, lr, sort_keys)`` trains the
        ``[K]`` slots (:meth:`_train`) and applies eq. (4) in one
        ``fl_aggregate`` launch on a CUDA device; with a mesh it reads
        the selection back and runs :meth:`_sharded_round`."""
        if self.mesh is not None:
            def sharded_fn(params, selected, coeffs, lr, sort_keys):
                return self._sharded_round(params, bank,
                                           selected.cpu().numpy(), coeffs,
                                           lr, sort_keys)
            return sharded_fn

        def round_fn(params, selected, coeffs, lr, sort_keys):
            deltas, losses = self._train(params, bank, selected, lr,
                                         sort_keys)
            return fl_server.aggregate_fused(params, deltas, coeffs,
                                             impl=self.impl), losses

        return round_fn

    def _lanes_plan(self, bank):
        """The data plane of a lane-batched rollout over ``bank``:
        ``round_fn(params, selected, coeffs, lr, sort_keys)`` takes ``[S,
        ...]`` params, ``[S, K]`` selections and coefficients and ``[S, K,
        E, B]`` epoch keys, trains the S·K slots, each from its lane's
        model (:meth:`_train` with ``per_client=True``: one SGD call, or
        one per hit tier of a ladder), and applies every lane's eq.-(4)
        step (``server.aggregate_fused_lanes``: one lane-batched
        ``fl_aggregate`` launch on a CUDA device).  Returns the ``[S,
        ...]`` params and the ``[S, K]`` losses."""

        def round_fn(params, selected, coeffs, lr, sort_keys):
            lanes, k = selected.shape
            starts = {name: v.repeat_interleave(k, dim=0)
                      for name, v in params.items()}
            deltas, losses = self._train(
                starts, bank, selected.reshape(-1), lr,
                sort_keys.reshape((lanes * k,) + tuple(sort_keys.shape[2:])),
                per_client=True)
            deltas = {name: d.reshape((lanes, k) + tuple(d.shape[1:]))
                      for name, d in deltas.items()}
            return (fl_server.aggregate_fused_lanes(params, deltas, coeffs,
                                                    impl=self.impl),
                    losses.reshape(lanes, k))

        return round_fn

    def _map_plan(self, bank):
        """The data plane of the arena's ``batch='map'``: the signature of
        :meth:`_lanes_plan`'s ``round_fn``, but each lane's round runs on
        its own through :meth:`_scan_plan`'s (its K-client SGD, then a
        one-lane ``fl_aggregate`` launch on a CUDA device), so lane s
        makes the very calls ``run_scan`` makes on its scenario."""
        one = self._scan_plan(bank)

        def round_fn(params, selected, coeffs, lr, sort_keys):
            # each lane's model in tensors of its own, as run_scan holds
            # it (a slice of the stack would start at another alignment)
            outs = [one({name: v[s].clone() for name, v in params.items()},
                        selected[s], coeffs[s], lr, sort_keys[s])
                    for s in range(selected.shape[0])]
            return ({name: torch.stack([o[0][name] for o in outs])
                     for name in params},
                    torch.stack([o[1] for o in outs]))

        return round_fn

    def _build_scan(self, k: int, decide_fn, round_fn, select_fn):
        """The rollout body: a function running T rounds on the device.

        ``decide_fn(sp, h, queues, V, lam, kvec)`` is the control plane,
        ``select_fn(sp, t, h, queues, q, key, slots, kvec)`` fills the
        slots (prefix-stable in the slot index), ``round_fn`` is the data
        plane from :meth:`_scan_plan`; ``rows``, the body's argument, is
        the width of the epoch keys (the bank's widest bucket).

        Padded-K contract (the JAX package's): ``k`` is the slot count
        K_max; ``k_act`` and ``kvec`` (``[N]`` float32) carry the true K.
        Slots ``i >= k_act`` are inert: their client clamps to 0, their
        eq.-(4) coefficient is exactly 0 (``fl_aggregate`` adds exactly
        0.0 for it), their loss, time and energy are masked, and their
        ``selected`` output is -1.  Slot i's client and epoch keys depend
        on (rollout key, round, i) only (``core.draws``), so a padded
        rollout gives the unpadded rollout's model trajectory.

        ``drop_seq`` (a ``[T, N]`` alive mask, or None) threads realised
        dropouts: a dropped client is masked like an inert slot (``act = af *
        alive[selected]``) but stays in ``selected``; a round in which
        every slot dropped has wall time 0; the queues drift on
        expectations, untouched by dropout.

        ``replay`` (``(selected [T, K], sort_keys [T, K, E, B])``, each
        tensor or None) replaces the draws with given ones: the parity
        tests pass the JAX package's selections and epoch keys in.

        The control plane of a round (:func:`_control`) and its outputs
        (:func:`_outputs`) are the functions the arena's lane body
        (:meth:`_build_lanes`) runs per lane.
        """
        epochs = self.cfg.local_epochs

        def scan_fn(params, queues, sp, rows, h_seq, drop_seq, lr_seq, key,
                    V, lam, kvec, k_act, replay):
            lane = _Lane(sp, k, k_act, kvec, V, lam, key, h_seq, drop_seq,
                         replay, decide_fn, select_fn, epochs, rows)
            outs = []
            for t in range(h_seq.shape[0]):
                dec, selected, sort_keys, coeffs = _control(lane, t, queues)
                params, losses = round_fn(params, selected, coeffs,
                                          lr_seq[t], sort_keys)
                queues, out = _outputs(lane, t, dec, queues, selected,
                                       losses)
                outs.append(out)
            return params, queues, _stack_metrics(outs)

        return scan_fn

    def _build_lanes(self, k: int, round_fn, eval_bank=None,
                     eval_every: int = 0):
        """The scenario arena's rollout body over S lanes.

        Control plane per lane: every round, each lane runs
        :func:`_control` (its controller's ``decide_by_id`` and
        ``select_by_id``, its own solver trip counts, draws keyed by its
        rollout key) and :func:`_outputs` (queues, metrics) — the very
        functions of :meth:`_build_scan`, with :meth:`_build_scan`'s
        padded-K, dropout and inert-slot rules per lane.  Data plane
        batched: ``round_fn`` from :meth:`_lanes_plan` gathers, trains and
        aggregates all lanes at once.  So lane s reproduces
        :meth:`run_scan` on its scenario.

        ``eval_bank`` with ``eval_every = E > 0`` adds the in-rollout
        evaluation of the JAX package's scan: the initial params are
        evaluated once, and after every round t with ``(t + 1) % E ==
        0`` the ``[S, ...]`` params are, in one batched call; each round
        emits ``test_<metric>`` ``[S]`` columns holding the latest
        evaluation (a step curve).

        The body takes ``(params, lanes, lr_seq, t0=0, carry=None,
        num_rounds=None)`` and runs the global rounds ``t0 .. t0 +
        num_rounds - 1`` (default: to the end of ``lr_seq``): ``params``
        the shared initial model (copied to ``[S, ...]``), ``lanes`` a
        list of :class:`_Lane`, ``lr_seq`` and every tensor of a lane the
        full-length ``[T, ...]`` ones, indexed by the global round (the
        draws of :func:`_control` are keyed by it, and ``eval_every``
        fires on it).  ``carry`` — ``([S, ...] params, [S, N] queues,
        last_ev)`` as a previous call returned it — continues a rollout
        where that call stopped: the chunked arena's segments, and its
        resumes from a checkpoint.  Without a carry the rollout starts
        from ``params`` and the lanes' initial queues, and the initial
        evaluation runs (at ``t0 == 0``).  It returns ``([S, ...] params,
        [S, N] queues, metrics, last_ev)`` — the carry beside the metrics,
        each metric an ``[S, num_rounds]`` device tensor (``selected``
        ``[S, num_rounds, k]``) that the caller reads back.
        """

        on_card = self.device.type == "cuda"

        def lanes_fn(params, lanes, lr_seq, t0: int = 0, carry=None,
                     num_rounds: Optional[int] = None):
            s_count = len(lanes)
            if num_rounds is None:
                num_rounds = lr_seq.shape[0] - t0
            if carry is None:
                params = {name: v.unsqueeze(0).expand(
                    (s_count,) + tuple(v.shape)).clone()
                    for name, v in params.items()}
                queues = [ln.queues0 for ln in lanes]
                last_ev = None
                if eval_every and t0 == 0:
                    last_ev = {name: v.expand(s_count) for name, v in
                               eval_bank.metrics_one(
                                   {n: v[0] for n, v in params.items()}
                               ).items()}
            else:
                params, queues, last_ev = carry
                queues = list(queues.unbind(0))
            outs = [[] for _ in lanes]
            evals = []
            for t in range(t0, t0 + num_rounds):
                control = [_control(ln, t, queues[i])
                           for i, ln in enumerate(lanes)]
                with obs_trace.span("engine.lanes_round", t=t,
                                    lanes=s_count, k=k, device=on_card):
                    params, losses = round_fn(
                        params, torch.stack([c[1] for c in control]),
                        torch.stack([c[3] for c in control]), lr_seq[t],
                        torch.stack([c[2] for c in control]))
                for i, ln in enumerate(lanes):
                    dec, selected = control[i][0], control[i][1]
                    queues[i], out = _outputs(ln, t, dec, queues[i],
                                              selected, losses[i])
                    outs[i].append(out)
                if eval_every:
                    if (t + 1) % eval_every == 0:
                        with obs_trace.span("engine.eval", t=t,
                                            lanes=s_count):
                            last_ev = eval_bank.metrics_stacked(params)
                    evals.append(last_ev)
            scalars = torch.stack([torch.stack([o[0] for o in lane])
                                   for lane in outs])
            metrics = {name: scalars[:, :, i]
                       for i, name in enumerate(SCAN_SCALARS)}
            metrics["selected"] = torch.stack(
                [torch.stack([o[1] for o in lane]) for lane in outs])
            for name in (evals[0] if evals else {}):
                metrics["test_" + name] = torch.stack(
                    [ev[name] for ev in evals], dim=1)
            return params, torch.stack(queues), metrics, last_ev

        return lanes_fn

    @staticmethod
    def _fixed_policy_decide(policy: str):
        """A ``decide_fn`` for :meth:`_build_scan` that runs one named
        ``repro_torch.core.policy`` rule with K as data."""
        fn = pol.DECIDE_FNS[pol.POLICY_IDS[policy]]

        def decide(sp, h, queues, V, lam, kvec):
            return fn(sp, h, queues, V, lam, k=kvec)

        return decide

    @staticmethod
    def _fixed_policy_select(policy: str):
        """A ``select_fn`` for :meth:`_build_scan`: the named policy's
        selection mode."""
        return pol.SELECT_FNS[pol.SELECTION_MODES[policy]]

    def run_scan(self, global_params: Params, sp: sm.SystemParams,
                 bank, h_seq: np.ndarray, lr_seq: np.ndarray,
                 gen: torch.Generator, *, queues: Optional[torch.Tensor] = None,
                 policy: str = "lroa", V: float = 0.0, lam: float = 0.0,
                 drop_seq: Optional[np.ndarray] = None,
                 k_max: Optional[int] = None,
                 replay_selected: Optional[np.ndarray] = None,
                 replay_sort_keys: Optional[np.ndarray] = None
                 ) -> Tuple[Params, torch.Tensor, Dict[str, np.ndarray]]:
        """Run ``h_seq.shape[0]`` rounds of Algorithm 1 under ``policy``.

        ``h_seq``: [T, N] channel gains; ``lr_seq``: [T] learning rates;
        ``gen``: a CPU ``torch.Generator`` from which the rollout's key
        is drawn (one draw, so the same generator state gives the same
        selections and epoch keys on the CPU and on the card; see
        ``core.draws``).  ``policy`` is any of ``core.policy.POLICIES``;
        its decide rule and its selection mode both run.  ``V`` and
        ``lam`` are the drift-plus-penalty weights, passed on as ``[N]``
        float32 vectors as the JAX package's scan does.  ``drop_seq``
        ([T, N], 1.0 = alive) threads realised dropouts.  ``k_max``
        (default ``sp.sample_count``) pads the slots beyond the true K
        with inert ones (see :meth:`_build_scan`).  ``replay_selected``
        ([T, k_max]) and ``replay_sort_keys`` ([T, k_max, E, B], ``B`` the
        bank's widest bucket: slot k in tier t reads the first ``B_t``
        columns) replace the draws, for the parity tests.  ``bank``: a
        ``ClientBank``, ``TieredClientBank`` or ``BankPool``.

        Returns (final params, final queues, per-round metrics as numpy:
        ``loss``, ``wall_time``, ``energy_mean``, ``queue_mean``,
        ``queue_norm``, ``q_min``, ``q_max`` of shape [T] and
        ``selected`` [T, k_max], -1 in inert slots, the JAX package's
        names; and ``q_sum`` [T], the port's check that every round's q
        lies on the simplex).  Every round's eq.-(4) step is one
        ``fl_aggregate`` launch on a CUDA device, however many tiers the
        round hits.  With a mesh each round is :meth:`_sharded_round`
        (the slot count divisible by the axis size): one
        ``fl_delta_reduce`` launch and one ``all_reduce`` per round.
        """
        if policy not in pol.POLICY_IDS:
            raise ValueError(f"unknown policy {policy!r} (scan-traceable: "
                             f"{pol.POLICIES})")
        if gen.device.type != "cpu":
            raise ValueError(f"run_scan draws its key from a CPU generator "
                             f"(the same on every device), got one on "
                             f"{gen.device}")
        k_act = sp.sample_count
        k = k_act if k_max is None else int(k_max)
        if k < k_act:
            raise ValueError(f"k_max={k} is below the true K={k_act}")
        if self.mesh is not None:
            self._my_slots(k)
        round_fn = self._scan_plan(bank)
        dev, n = self.device, sp.num_devices
        if sp.device.type != dev.type:
            raise ValueError(f"SystemParams live on {sp.device}, the engine "
                             f"on {dev}")
        h_seq = torch.as_tensor(np.asarray(h_seq, np.float32), device=dev)
        num_rounds = h_seq.shape[0]
        if tuple(h_seq.shape) != (num_rounds, n):
            raise ValueError(f"h_seq must be [T, {n}], got "
                             f"{tuple(h_seq.shape)}")
        lr_seq = torch.as_tensor(np.asarray(lr_seq, np.float32), device=dev)
        if tuple(lr_seq.shape) != (num_rounds,):
            raise ValueError(f"lr_seq must be [{num_rounds}], got "
                             f"{tuple(lr_seq.shape)}")
        if drop_seq is not None:
            drop_seq = torch.as_tensor(np.asarray(drop_seq, np.float32),
                                       device=dev)
            if tuple(drop_seq.shape) != (num_rounds, n):
                raise ValueError(f"drop_seq must be [{num_rounds}, {n}], "
                                 f"got {tuple(drop_seq.shape)}")
        rows = bank.bucket_examples
        replay = (
            None if replay_selected is None else torch.as_tensor(
                np.asarray(replay_selected).astype(np.int64), device=dev),
            None if replay_sort_keys is None else torch.as_tensor(
                np.asarray(replay_sort_keys, np.float32), device=dev))
        for got, want, what in ((replay[0], (num_rounds, k),
                                 "replay_selected"),
                                (replay[1], (num_rounds, k,
                                             self.cfg.local_epochs, rows),
                                 "replay_sort_keys")):
            if got is not None and tuple(got.shape) != want:
                raise ValueError(f"{what} must be {list(want)}, got "
                                 f"{list(got.shape)}")
        if queues is None:
            queues = vq.init_queues(n, dev)
        key = torch.randint(0, 2 ** 62, (), generator=gen).to(dev)
        scan_fn = self._build_scan(k, self._fixed_policy_decide(policy),
                                   round_fn,
                                   self._fixed_policy_select(policy))

        def full(v: float) -> torch.Tensor:
            """K, V and lam as [N] data, as the JAX package passes them."""
            return torch.full((n,), v, dtype=torch.float32, device=dev)

        with obs_trace.span("engine.round", what="run_scan", policy=policy,
                            rounds=num_rounds, k=k_act):
            return scan_fn(global_params, queues, sp, rows, h_seq, drop_seq,
                           lr_seq, key, full(V), full(lam),
                           full(float(k_act)), k_act, replay)


class _Lane:
    """One rollout's constants, as the rollout bodies read them: its
    system params, slot count ``k`` (K_max) and true K (``k_act``,
    ``kvec`` ``[N]``), ``V`` and ``lam`` as ``[N]`` float32, rollout key,
    channels ``[T, N]``, alive mask ``[T, N]`` or None, replayed draws
    ``(selected, sort_keys)`` (each None or ``[T, ...]``), its controller's
    decide and select functions, local epochs and bank rows; and, for the
    arena, its initial queues and its lane index (the ``scan.*``
    spans' ``lane``)."""

    def __init__(self, sp, k, k_act, kvec, V, lam, key, h_seq, drop_seq,
                 replay, decide_fn, select_fn, epochs, rows, queues0=None,
                 index=None):
        self.sp, self.k, self.k_act, self.kvec = sp, k, k_act, kvec
        self.V, self.lam, self.key = V, lam, key
        self.h_seq, self.drop_seq, self.replay = h_seq, drop_seq, replay
        self.decide_fn, self.select_fn = decide_fn, select_fn
        self.epochs, self.rows, self.queues0 = epochs, rows, queues0
        self.index = index
        dev = h_seq.device
        self.slots = torch.arange(k, device=dev)
        self.active = self.slots < k_act
        self.af = self.active.to(torch.float32)


def _control(lane: _Lane, t: int, queues: torch.Tensor):
    """Round t's control plane of one rollout: the decision, the slots'
    clients (inert slots on client 0), their ``[k, E, B]`` epoch keys and
    their eq.-(4) coefficients (exactly 0 where a slot is inert or
    dropped: w / (K q) is inf there when the padded slot's client 0 has
    q = 0)."""
    sp, kvec, slots = lane.sp, lane.kvec, lane.slots
    h = lane.h_seq[t]
    with obs_trace.span("scan.decide", t=t, lane=lane.index):
        dec = lane.decide_fn(sp, h, queues, lane.V, lane.lam, kvec)
    with obs_trace.span("scan.select", t=t, lane=lane.index):
        rep_sel, rep_keys = lane.replay
        if rep_sel is None:
            drawn = lane.select_fn(
                sp, t, h, queues, dec.q,
                draws.round_key(lane.key, t, draws.SELECT_STREAM), slots,
                kvec)
        else:
            drawn = rep_sel[t]
        selected = torch.where(lane.active, drawn, 0)
        if rep_keys is None:
            sort_keys = draws.epoch_keys(
                draws.round_key(lane.key, t, draws.CLIENT_STREAM), slots,
                lane.epochs, lane.rows)
        else:
            sort_keys = rep_keys[t]
        act = _act(lane, t, selected)
        w = sp.data_weights
        ratio = w[selected] / (kvec[selected] * dec.q[selected])
        coeffs = torch.where(act > 0, ratio * act, 0.0)
    return dec, selected, sort_keys, coeffs


def _act(lane: _Lane, t: int, selected: torch.Tensor) -> torch.Tensor:
    """1.0 for a live slot, 0.0 for an inert or dropped one."""
    if lane.drop_seq is None:
        return lane.af
    return lane.af * lane.drop_seq[t][selected]


def _outputs(lane: _Lane, t: int, dec, queues: torch.Tensor,
             selected: torch.Tensor, losses: torch.Tensor):
    """Round t's queue update and metrics row of one rollout: (new
    queues, (the :data:`SCAN_SCALARS` as one tensor, ``selected`` with
    -1 in inert slots))."""
    with obs_trace.span("scan.outputs", t=t, lane=lane.index):
        sp, kvec, active, af = lane.sp, lane.kvec, lane.active, lane.af
        n = sp.num_devices
        h = lane.h_seq[t]
        act = _act(lane, t, selected)
        queues = vq.update_queues(queues, vq.energy_increment(
            sp, h, dec.p, dec.f, dec.q, k=kvec))
        t_n = sm.round_time(sp, h, dec.p, dec.f, k=kvec)
        e_n = sm.round_energy(sp, h, dec.p, dec.f, k=kvec)
        if lane.drop_seq is not None:
            loss = (torch.sum(losses * act) /
                    torch.clamp(torch.sum(act), min=1.0))
            live = active & (act > 0.0)
            # all slots dropped: no upload finished this round
            wall = torch.clamp(torch.max(torch.where(
                live, t_n[selected], float("-inf"))), min=0.0)
        else:
            loss = torch.sum(losses * af) / float(lane.k_act)
            live = active
            wall = torch.max(torch.where(live, t_n[selected],
                                         float("-inf")))
        # dead slots mark the extra row n, which is dropped
        mask = torch.zeros(n + 1, dtype=torch.float32,
                           device=h.device).index_fill_(
            0, torch.where(live, selected, n), 1.0)[:n]
        return queues, (torch.stack([
            loss, wall,
            torch.sum(e_n * mask) / torch.clamp(torch.sum(mask), min=1.0),
            torch.mean(queues), torch.linalg.vector_norm(queues),
            torch.min(dec.q), torch.max(dec.q), torch.sum(dec.q)]),
            torch.where(active, selected, -1))


def _stack_metrics(outs) -> Dict[str, np.ndarray]:
    """The rows of :func:`_outputs` as ``{name: [T] numpy}`` and
    ``selected`` ``[T, k]``, read back once."""
    scalars = torch.stack([o[0] for o in outs]).cpu().numpy()
    metrics = {name: scalars[:, i] for i, name in enumerate(SCAN_SCALARS)}
    metrics["selected"] = torch.stack([o[1] for o in outs]).cpu().numpy()
    return metrics


#: the scalar per-round metrics of ``run_scan``, in its stacking order
SCAN_SCALARS = ("loss", "wall_time", "energy_mean", "queue_mean",
                "queue_norm", "q_min", "q_max", "q_sum")
