"""ClientBank — the device-resident FL data plane; the port of
``repro.fl.client_bank``.

ALL N clients' bucketed data is tiled and stacked to ``[N, B, ...]`` once
at construction, uploaded once, and every round gathers its K selected
rows on the device (``index_select``) — no per-round host-to-device
transfer of client data.

* The inputs are stored in the layout the task reads (``x_layout``,
  e.g. ``CNNTask.device_layout``: NHWC -> NCHW), applied once at upload
  so no SGD step permutes its batch.
* The stacks keep the data's dtypes, as the JAX package's banks do
  (:func:`stored_dtype`: a 64-bit dtype at 32 bits, as JAX stores it
  with x64 off): features as given (f16, f32, uint8 ...), labels as
  given (int32 for ``data.synthetic``), the ``num_steps`` /
  ``num_examples`` masks as int32 ``[N]``.  The round engine widens the
  K gathered rows, at ``[K, B, ...]``: features to f32, integer labels
  to int64 (what ``F.cross_entropy`` takes), masks to int64.
* One GLOBAL bucket ``B = bucket_num_batches(max_i ceil(n_i / bs)) * bs``
  covers every client (see ``repro_torch.data.pipeline``); the masks
  keep padded clients at their true step counts and examples.
* The host keeps a private copy of every client's true (x, y) — ``sum_i
  n_i`` rows, never the tiled form — for :meth:`ClientBank.client_view`
  and the test-only :meth:`ClientBank.gather_host`.

The scale plane behind the same interface:

* ``storage='int8'``: the xs stack holds per-client affine int8 codes
  (``data.pipeline.quantize_stack``, in the task's layout) and ``[N]``
  f32 ``x_scale`` / ``x_zero``; the round engine dequantizes the K
  selected rows right after the gather (``quant_args``), so f32 rows
  exist only at ``[K, B, ...]``.
* ``clusters=k``: host k-means over per-client features
  (``data.pipeline.kmeans_clusters``), ``cluster_of`` on the host and on
  the device, for ``RoundEngine.round_step(hierarchical=True)``.
* :class:`TieredClientBank`: the tier ladder, one :class:`ClientBank`
  per power-of-two size tier (``data.pipeline.assign_tiers``) and the
  maps ``tier_of`` / ``pos_in_tier``, so device rows are ``sum_t N_t
  B_t`` instead of ``N * max_i n_i``.
* :class:`BankPool`: a fixed ``[N_cap, B, ...]`` stack whose population
  churns by writing rows in place: its tensors are never reallocated
  (the torch form of the JAX package's zero-retrace contract).
* ``nbytes`` / ``bytes_per_client`` / :func:`estimate_bank_nbytes`: the
  device footprint as a tracked number.

Client-axis sharding (``mesh=``, ``mesh_axis=``; a ``launch.mesh``
``DeviceMesh``, one rank per shard): the reference's placement rule —
when the axis has ``shards > 1`` ranks and they divide N, rank r holds
the contiguous rows ``[r N/shards, (r + 1) N/shards)`` of every stack
(``row_start``, ``rows_held``; ``nbytes`` counts this rank's); otherwise
every rank holds them all.  On a ladder the rule applies per rung.  The
host copies, the masks' host mirrors and the cluster routing stay whole
on every rank (control-plane data).  The round engine fetches a slot's
row from the rank that holds it (``RoundEngine(mesh=)``).  A
``BankPool`` takes no mesh, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import (assign_clusters, assign_tiers,
                                       client_bucket_examples,
                                       client_cluster_features,
                                       dequantize_stack, kmeans_clusters,
                                       pad_client_data, quantize_stack,
                                       stack_client_arrays,
                                       validate_client_data)
from repro_torch.fl.client import ClientConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs.metrics import MetricsRegistry

_STORAGES = ("fp32", "int8")

Layout = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _check_storage(storage: str) -> str:
    if storage not in _STORAGES:
        raise ValueError(f"storage must be one of {_STORAGES}, "
                         f"got {storage!r}")
    return storage


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


#: 64-bit dtypes and the 32-bit ones the JAX package (x64 off) stores
_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32)}


def stored_dtype(dtype) -> np.dtype:
    """The numpy dtype a bank stores data of ``dtype`` in: the data's
    own, a 64-bit one at 32 bits (the JAX package's device arrays)."""
    dtype = np.dtype(dtype)
    return _NARROW.get(dtype, dtype)


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of :func:`stored_dtype` of numpy ``dtype``."""
    return torch.from_numpy(np.empty(0, stored_dtype(dtype))).dtype


def upload(arr, device, layout: Layout = None,
           copy: bool = True) -> torch.Tensor:
    """Host ``arr`` on ``device`` in :func:`stored_dtype`, through
    ``layout`` when given: a private copy that never aliases ``arr``'s
    memory, on the CPU too, unless ``copy=False`` (``arr`` a stack the
    caller built for the upload)."""
    arr = np.asarray(arr)
    dt = stored_dtype(arr.dtype)
    arr = np.array(arr, dt) if copy else arr.astype(dt, copy=False)
    t = torch.as_tensor(arr, device=device)
    return (layout(t) if layout is not None else t).contiguous()


def widen(x: torch.Tensor, y: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stored rows as a task reads them, exactly: features in f32,
    integer labels in int64 (what ``F.cross_entropy`` takes); a no-op on
    f32 features and on int64 or float labels."""
    return x.to(torch.float32), (y if y.is_floating_point()
                                 else y.to(torch.int64))


def estimate_bank_nbytes(sizes: Sequence[int], batch_size: int,
                         feature_shape: Tuple[int, ...],
                         label_shape: Tuple[int, ...] = (),
                         feature_dtype=np.float32,
                         label_dtype=np.int32,
                         storage: str = "fp32") -> int:
    """Device bytes a single-bucket :class:`ClientBank` WOULD hold, with
    no allocation, the JAX package's formula: the ``[N, B, ...]`` xs
    stack (``feature_dtype``, or int8 codes), the ``label_dtype`` labels,
    the two int32 ``[N]`` masks and (int8) the f32 ``[N]`` scale and
    zero — :attr:`ClientBank.nbytes` for data of those dtypes."""
    _check_storage(storage)
    n = len(sizes)
    b = max(client_bucket_examples(int(s), batch_size) for s in sizes)
    feat = int(np.prod(feature_shape, dtype=np.int64)) if feature_shape else 1
    lab = int(np.prod(label_shape, dtype=np.int64)) if label_shape else 1
    x_item = 1 if storage == "int8" else np.dtype(feature_dtype).itemsize
    total = n * b * feat * x_item
    total += n * b * lab * np.dtype(label_dtype).itemsize
    total += 2 * n * 4                       # num_steps / num_examples
    if storage == "int8":
        total += 2 * n * 4                   # x_scale / x_zero
    return int(total)


class ClientBank:
    """Device-resident ``[N, B, ...]`` stacks of every client's data."""

    def __init__(self, client_data: Sequence[tuple],
                 client_cfg: ClientConfig, device="cuda",
                 x_layout: Layout = None, storage: str = "fp32",
                 clusters: Optional[int] = None, mesh=None,
                 mesh_axis: str = mesh_lib.AXIS):
        validate_client_data(client_data)
        self.batch_size = client_cfg.batch_size
        self.storage = _check_storage(storage)
        self.device = torch.device(device)
        # private host copies of the TRUE data (client_view, gather_host)
        self._clients = [(np.array(x), np.array(y)) for x, y in client_data]
        host_x, host_y, num_steps, num_examples = stack_client_arrays(
            self._clients, self.batch_size)
        self._num_steps, self._num_examples = num_steps, num_examples
        self._tiled: Optional[tuple] = None
        self.num_clients = host_x.shape[0]
        self.bucket_examples = host_x.shape[1]
        self.steps_per_epoch = self.bucket_examples // self.batch_size
        # every client exactly fills the bucket => the masks are inert and
        # the unmasked SGD path runs
        self.uniform = bool(np.all(num_examples == self.bucket_examples))
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self._place(mesh, mesh_axis)
        rows = slice(self.row_start, self.row_start + self.rows_held)
        if self.storage == "int8":
            host_x, scale, zero = quantize_stack(host_x)
            self.x_scale = upload(scale[rows], self.device)
            self.x_zero = upload(zero[rows], self.device)
        else:
            self.x_scale = self.x_zero = None
        self.xs = upload(host_x[rows], self.device, x_layout, copy=False)
        self.ys = upload(host_y[rows], self.device, copy=False)
        self.num_steps = upload(num_steps[rows], self.device)
        self.num_examples = upload(num_examples[rows], self.device)
        if clusters is not None:
            feats = client_cluster_features(self._clients)
            self.cluster_of, self.cluster_centroids = kmeans_clusters(
                feats, clusters)
            self.num_clusters = int(self.cluster_centroids.shape[0])
            self.cluster_of_device = upload(self.cluster_of, self.device)
        else:
            self.cluster_of = self.cluster_centroids = None
            self.num_clusters = 0
            self.cluster_of_device = None

    def _place(self, mesh, axis: str) -> None:
        """The reference's placement rule (``_placement``): this rank's
        contiguous ``N / shards`` rows when the axis has ``shards > 1``
        ranks dividing N, else every row."""
        n = self.num_clients
        self.shards = 1 if mesh is None else mesh_lib.axis_size(mesh, axis)
        self.row_sharded = self.shards > 1 and n % self.shards == 0
        self.rows_held = n // self.shards if self.row_sharded else n
        self.row_start = (mesh_lib.axis_rank(mesh, axis) * self.rows_held
                          if self.row_sharded else 0)

    @property
    def sizes(self) -> np.ndarray:
        """True per-client dataset sizes ``n_i`` (host, [N])."""
        return self._num_examples

    @property
    def true_examples(self) -> int:
        """``sum_i n_i`` — the irreducible example count."""
        return int(self._num_examples.sum())

    @property
    def padded_examples(self) -> int:
        """``N * B`` — device rows held (incl. tiling padding)."""
        return self.num_clients * self.bucket_examples

    @property
    def nbytes(self) -> int:
        """Device bytes this rank holds: the xs/ys stacks, the two masks
        and (int8) the scale/zero codes."""
        return _nbytes([self.xs, self.ys, self.num_steps, self.num_examples]
                       + [t for t in self.quant_args() if t is not None])

    @property
    def bytes_per_client(self) -> float:
        return self.nbytes / self.num_clients

    def quant_args(self) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
        """Per-client affine codes ``(x_scale, x_zero)`` for the
        dequantizing gather, or ``(None, None)`` in fp32 mode."""
        return self.x_scale, self.x_zero

    def device_args(self) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """(xs, ys, num_steps, num_examples) — the rows this rank holds;
        the masks are None for a uniform bank (every client fills the
        bucket)."""
        if self.uniform:
            return self.xs, self.ys, None, None
        return self.xs, self.ys, self.num_steps, self.num_examples

    # -- host-side views ---------------------------------------------------

    def gather_host(self, selected: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray,
                               Optional[np.ndarray], Optional[np.ndarray]]:
        """The selected clients' tiled rows ``[K, B, ...]`` from the host
        copies, in the host (NHWC) layout and always UNQUANTIZED, even
        for an int8 bank (the reference the quantization bound is stated
        against); the masks are None when every selected client fills
        the bucket.  For tests; the tiled stacks are cached at first
        use."""
        if self._tiled is None:
            self._tiled = stack_client_arrays(self._clients,
                                              self.batch_size)[:2]
        host_x, host_y = self._tiled
        idx = np.asarray(selected, np.int64)
        xs, ys = host_x[idx], host_y[idx]
        if np.all(self._num_examples[idx] == self.bucket_examples):
            return xs, ys, None, None
        return xs, ys, self._num_steps[idx], self._num_examples[idx]

    def client_view(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Client ``i``'s true (x, y): the bank's private host copy."""
        return self._clients[i]


class TieredClientBank:
    """Bucket-ladder bank: one :class:`ClientBank` per power-of-two size
    tier, plus global-index maps.

    ``tier_of[i]`` names client i's tier and ``pos_in_tier[i]`` its row in
    that tier's stack (members keep ascending global order, so a one-tier
    ladder has ``pos_in_tier == arange(N)`` and its tier IS the
    single-bucket bank).  ``tier_of_device`` / ``pos_device`` are the
    same maps on the device, for routing a selection that lives there
    (``run_scan``, the arena).  ``bucket_examples`` is the widest rung:
    epoch keys are drawn that wide and slot k in tier t reads their first
    ``B_t`` columns (the port's draws are prefix-stable in the row)."""

    def __init__(self, client_data: Sequence[tuple],
                 client_cfg: ClientConfig, device="cuda",
                 x_layout: Layout = None, max_tiers: int = 4,
                 assignment: Optional[tuple] = None, storage: str = "fp32",
                 mesh=None, mesh_axis: str = mesh_lib.AXIS):
        validate_client_data(client_data)
        self.batch_size = client_cfg.batch_size
        self.storage = _check_storage(storage)
        self.device = torch.device(device)
        sizes = [int(np.asarray(x).shape[0]) for x, _ in client_data]
        self.num_clients = len(sizes)
        # a caller that already ran the ladder decision (make_bank's
        # 'auto') hands its assignment over
        if assignment is None:
            assignment = assign_tiers(sizes, self.batch_size, max_tiers)
        self.tier_of, self.tier_buckets = assignment
        self.num_tiers = len(self.tier_buckets)
        self.bucket_examples = int(self.tier_buckets[-1])
        self.tier_members = [np.flatnonzero(self.tier_of == t)
                             for t in range(self.num_tiers)]
        pos = np.zeros(self.num_clients, np.int32)
        for members in self.tier_members:
            pos[members] = np.arange(members.size, dtype=np.int32)
        self.pos_in_tier = pos
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.tiers = [ClientBank([client_data[i] for i in members],
                                 client_cfg, device=device,
                                 x_layout=x_layout, storage=storage,
                                 mesh=mesh, mesh_axis=mesh_axis)
                      for members in self.tier_members]
        self.tier_of_device = torch.as_tensor(
            self.tier_of.astype(np.int64), device=self.device)
        self.pos_device = torch.as_tensor(pos.astype(np.int64),
                                          device=self.device)

    @property
    def sizes(self) -> np.ndarray:
        """True per-client dataset sizes ``n_i`` in GLOBAL order ([N])."""
        out = np.zeros(self.num_clients, np.int32)
        for members, bank in zip(self.tier_members, self.tiers):
            out[members] = bank.sizes
        return out

    @property
    def true_examples(self) -> int:
        return sum(bank.true_examples for bank in self.tiers)

    @property
    def padded_examples(self) -> int:
        """``sum_t N_t * B_t`` — device rows held across the ladder."""
        return sum(bank.padded_examples for bank in self.tiers)

    @property
    def nbytes(self) -> int:
        """Device bytes this rank holds across the ladder (the tiers'
        stacks)."""
        return sum(bank.nbytes for bank in self.tiers)

    @property
    def bytes_per_client(self) -> float:
        return self.nbytes / self.num_clients

    def client_view(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Client ``i``'s true (x, y) via its tier's host copy."""
        return self.tiers[self.tier_of[i]].client_view(
            int(self.pos_in_tier[i]))


class BankPool:
    """Slot-recycled pool: a fixed-capacity device-resident ``[N_cap, B,
    ...]`` bank whose population churns without reallocating.

    The stacks are allocated ONCE at ``(capacity, B)``; :meth:`admit`
    tiles a client's rows to ``B``, optionally quantizes them, and writes
    them into a free slot of the same tensors (one row copy per stack);
    :meth:`evict` only returns the slot to the free list.  Every tensor
    keeps its storage for the pool's life (:meth:`data_ptrs`).

    It has the bank interface (``device_args`` / ``quant_args`` / sizes /
    accounting), so ``RoundEngine.round_step`` / ``run_scan`` and the
    arena run on it.  Unlike :class:`ClientBank`: ``uniform`` is always
    False (the masks stay valid for any resident mix); selection is over
    SLOTS (:meth:`sample_slots`, :meth:`slots_for`), and an empty slot
    holds inert rows (one step over zeros).  Tallies (``pool.admits``,
    ``pool.evicts``, ``pool.uploads``, ``pool.resident``,
    ``pool.traces``, ``pool.quant.abs_err``) live in its
    :class:`MetricsRegistry`, ``registry`` (the caller's when given, so
    several pools and the arena can share one).  The stacks are
    allocated in ``feature_dtype`` (or int8) and ``label_dtype``
    (:func:`stored_dtype`), the masks in int32, as in the JAX package.
    :meth:`warmup` makes the first row write ahead of churn
    (``traces``).
    """

    def __init__(self, client_cfg: ClientConfig, capacity: int,
                 max_examples: Optional[int] = None,
                 feature_shape: Optional[Tuple[int, ...]] = None,
                 label_shape: Tuple[int, ...] = (),
                 feature_dtype=np.float32, label_dtype=np.int32,
                 storage: str = "fp32", clusters: Optional[int] = None,
                 initial_clients: Optional[Dict[object, tuple]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device="cuda", x_layout: Layout = None):
        self.batch_size = client_cfg.batch_size
        self.storage = _check_storage(storage)
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.device = torch.device(device)
        self._layout = x_layout
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        init_items = list(initial_clients.items()) if initial_clients else []
        if init_items:
            validate_client_data([pair for _, pair in init_items])
            if len(init_items) > self.capacity:
                raise ValueError(f"{len(init_items)} initial clients exceed "
                                 f"pool capacity {self.capacity}")
            x0, y0 = (np.asarray(a) for a in init_items[0][1])
            feature_shape, label_shape = x0.shape[1:], y0.shape[1:]
            feature_dtype, label_dtype = x0.dtype, y0.dtype
            sizes = [np.asarray(x).shape[0] for _, (x, _) in init_items]
            max_examples = max(int(max_examples or 0), max(sizes))
        elif feature_shape is None or max_examples is None:
            raise ValueError("an empty pool needs feature_shape and "
                             "max_examples to fix its static [N_cap, B, "
                             "...] shape up front")
        self.feature_shape = tuple(feature_shape)
        self.label_shape = tuple(label_shape)
        self.feature_dtype = np.dtype(feature_dtype)
        self.label_dtype = np.dtype(label_dtype)
        if not np.issubdtype(self.feature_dtype, np.floating):
            raise ValueError(f"feature_dtype {self.feature_dtype} is not a "
                             f"float dtype")
        self.bucket_examples = client_bucket_examples(int(max_examples),
                                                      self.batch_size)
        self.steps_per_epoch = self.bucket_examples // self.batch_size
        self.num_clients = self.capacity          # the bank interface's N
        self.uniform = False
        b, dev = self.bucket_examples, self.device
        # empty slots: one step over zeros, full-bucket num_examples,
        # identity codes
        xs = torch.zeros((self.capacity, b) + self.feature_shape,
                         dtype=torch.int8 if self.storage == "int8"
                         else _torch_dtype(self.feature_dtype), device=dev)
        self.xs = (self._layout(xs) if self._layout is not None
                   else xs).contiguous()
        self.ys = torch.zeros((self.capacity, b) + self.label_shape,
                              dtype=_torch_dtype(self.label_dtype),
                              device=dev)
        self.num_steps = torch.ones(self.capacity, dtype=torch.int32,
                                    device=dev)
        self.num_examples = torch.full((self.capacity,), b,
                                       dtype=torch.int32, device=dev)
        if self.storage == "int8":
            self.x_scale = torch.ones(self.capacity, dtype=torch.float32,
                                      device=dev)
            self.x_zero = torch.zeros(self.capacity, dtype=torch.float32,
                                      device=dev)
        else:
            self.x_scale = self.x_zero = None
        # centroids fitted ONCE on the initial population, so an admitted
        # client's cluster never depends on admission order
        if clusters is not None:
            if not init_items:
                raise ValueError("clusters needs initial_clients to fit "
                                 "centroids on")
            feats = client_cluster_features([p for _, p in init_items])
            _, self.cluster_centroids = kmeans_clusters(feats, clusters)
            self.num_clusters = int(self.cluster_centroids.shape[0])
            self.cluster_of = np.zeros(self.capacity, np.int32)
            self.cluster_of_device = torch.zeros(self.capacity,
                                                 dtype=torch.int32,
                                                 device=dev)
        else:
            self.cluster_centroids = self.cluster_of = None
            self.num_clusters = 0
            self.cluster_of_device = None
        self._buffer_names = ["xs", "ys", "num_steps", "num_examples"]
        if self.storage == "int8":
            self._buffer_names += ["x_scale", "x_zero"]
        if self.cluster_of_device is not None:
            self._buffer_names += ["cluster_of_device"]
        self.slot_of: Dict[object, int] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._host: Dict[object, tuple] = {}
        self._sizes = np.zeros(self.capacity, np.int32)
        for cid, (x, y) in init_items:
            self.admit(cid, x, y)

    # -- churn --------------------------------------------------------------

    def admit(self, client_id, x: np.ndarray, y: np.ndarray) -> int:
        """Bring a client resident: tile, quantize (int8), and write its
        rows into a free slot of the pool's tensors.  Returns the slot."""
        if client_id in self.slot_of:
            raise ValueError(f"client {client_id!r} is already resident "
                             f"(slot {self.slot_of[client_id]})")
        if not self._free:
            raise ValueError(f"pool is full ({self.capacity} slots) — "
                             f"evict before admitting")
        x, y = np.asarray(x), np.asarray(y)
        validate_client_data([(x, y)])
        if (x.dtype, x.shape[1:]) != (self.feature_dtype,
                                      self.feature_shape) or \
           (y.dtype, y.shape[1:]) != (self.label_dtype, self.label_shape):
            raise ValueError(
                f"client {client_id!r}: (x {x.dtype} {x.shape[1:]}, "
                f"y {y.dtype} {y.shape[1:]}) does not match the pool's "
                f"static spec (x {self.feature_dtype} {self.feature_shape},"
                f" y {self.label_dtype} {self.label_shape})")
        n = int(x.shape[0])
        if n > self.bucket_examples:
            raise ValueError(
                f"client {client_id!r}: {n} examples exceed the pool "
                f"bucket B={self.bucket_examples} — size the pool's "
                f"max_examples for the largest admissible client")
        px, py = pad_client_data(x, y, self.bucket_examples)
        rows = {"ys": py, "num_steps": np.int32(max(n // self.batch_size, 1)),
                "num_examples": np.int32(n)}
        if self.storage == "int8":
            q, scale, zero = quantize_stack(px[None])
            err = float(np.abs(dequantize_stack(q, scale, zero)
                               - px[None].astype(np.float32)).max())
            self.registry.histogram("pool.quant.abs_err").observe(err)
            rows["xs"] = q
            rows["x_scale"], rows["x_zero"] = scale[0], zero[0]
        else:
            rows["xs"] = px[None]
        slot = self._free.pop()
        if self.cluster_of_device is not None:
            cid = assign_clusters(client_cluster_features([(x, y)]),
                                  self.cluster_centroids)[0]
            self.cluster_of[slot] = cid
            rows["cluster_of_device"] = np.int32(cid)
        for name in self._buffer_names:
            row = upload(rows[name], self.device,
                         self._layout if name == "xs" else None, copy=False)
            getattr(self, name)[slot].copy_(row[0] if name == "xs" else row)
        if not self.traces:
            # the pool's cold write (the JAX package's scatter trace):
            # every admit writes rows of the same shapes
            self.registry.counter("pool.traces").inc()
        self.slot_of[client_id] = slot
        self._host[client_id] = (x.copy(), y.copy())
        self._sizes[slot] = n
        self.registry.counter("pool.admits").inc()
        self.registry.counter("pool.uploads").inc()
        self.registry.gauge("pool.resident").set(len(self.slot_of))
        return slot

    def evict(self, client_id) -> int:
        """Return a client's slot to the free list (no device work: the
        rows stay until a later admit overwrites them).  Returns it."""
        if client_id not in self.slot_of:
            raise ValueError(f"client {client_id!r} is not resident")
        slot = self.slot_of.pop(client_id)
        self._free.append(slot)
        self._host.pop(client_id, None)
        self._sizes[slot] = 0
        self.registry.counter("pool.evicts").inc()
        self.registry.gauge("pool.resident").set(len(self.slot_of))
        return slot

    def warmup(self) -> None:
        """Make the pool's first row write (admit and evict a sentinel
        client of zeros) so a strict watchdog can arm over a pool whose
        churn path is warm; a no-op when any admit already ran (a full
        pool has no slot for a sentinel).  The free list and the slots
        are as before (the sentinel's slot returns to the end it was
        taken from); ``pool.admits``, ``evicts`` and ``uploads`` count it,
        as in the JAX package.  Synchronizes the device either way."""
        if not self.uploads:
            sentinel = object()
            self.admit(sentinel,
                       np.zeros((1,) + self.feature_shape, self.feature_dtype),
                       np.zeros((1,) + self.label_shape, self.label_dtype))
            self.evict(sentinel)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def data_ptrs(self) -> Dict[str, int]:
        """Each device tensor's storage address: unchanged by any churn."""
        return {name: getattr(self, name).data_ptr()
                for name in self._buffer_names}

    # -- slot views ---------------------------------------------------------

    def slots_for(self, client_ids: Sequence) -> np.ndarray:
        """Resident clients' slots, in the given order ([K] int32)."""
        return np.asarray([self.slot_of[c] for c in client_ids], np.int32)

    def sample_slots(self, rng: np.random.Generator, k: int) -> np.ndarray:
        """``k`` distinct OCCUPIED slots, drawn from ``rng``."""
        occupied = np.asarray(sorted(self.slot_of.values()), np.int32)
        if k > occupied.size:
            raise ValueError(f"asked for {k} slots but only "
                             f"{occupied.size} are occupied")
        return np.asarray(rng.choice(occupied, size=k, replace=False),
                          np.int32)

    def client_view(self, client_id) -> Tuple[np.ndarray, np.ndarray]:
        """A resident client's true (x, y): the pool's host copy."""
        return self._host[client_id]

    # -- bank interface -----------------------------------------------------

    def device_args(self) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
        """(xs, ys, num_steps, num_examples); the masks are always
        present."""
        return self.xs, self.ys, self.num_steps, self.num_examples

    def quant_args(self) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
        return self.x_scale, self.x_zero

    @property
    def sizes(self) -> np.ndarray:
        """Per-SLOT true sizes ``n_i`` (0 for an empty slot; [N_cap])."""
        return self._sizes

    @property
    def true_examples(self) -> int:
        return int(self._sizes.sum())

    @property
    def padded_examples(self) -> int:
        return self.capacity * self.bucket_examples

    @property
    def nbytes(self) -> int:
        """Device bytes held — fixed at construction."""
        return _nbytes(getattr(self, name) for name in self._buffer_names)

    @property
    def bytes_per_client(self) -> float:
        """:attr:`nbytes` over CAPACITY (slots exist, occupied or not)."""
        return self.nbytes / self.capacity

    @property
    def num_resident(self) -> int:
        return len(self.slot_of)

    @property
    def admits(self) -> int:
        return int(self.registry.get("pool.admits"))

    @property
    def evicts(self) -> int:
        return int(self.registry.get("pool.evicts"))

    @property
    def uploads(self) -> int:
        return int(self.registry.get("pool.uploads"))

    @property
    def traces(self) -> int:
        """Cold row writes: 1 after the first admit (or :meth:`warmup`)
        for the pool's whole life, since every admit writes rows of the
        same shapes."""
        return int(self.registry.get("pool.traces"))
