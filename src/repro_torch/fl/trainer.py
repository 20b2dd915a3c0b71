"""The FL loop (Algorithm 1) under any controller of the paper's
comparison (``LROAController`` or a ``repro_torch.core.baselines``
controller), with wall-clock latency and energy accounting — the port of
``repro.fl.trainer``: the fused path and the sequential reference path.

All N clients' bucketed data is uploaded to the device once, when the
trainer is built: into the tier ladder
(:class:`~repro_torch.fl.client_bank.TieredClientBank`) when the partition
spans several size tiers (``bank_mode='auto'``, the default: a skewed
non-iid split, as the paper's testbed is), else into a single-bucket
:class:`~repro_torch.fl.client_bank.ClientBank`; ``bank_storage='int8'``
keeps its rows as per-client int8 codes.  Per round t:

  1. observe channel gains h^t (ChannelProcess)                      [host]
  2. the controller decides (f^t, p^t, q^t) — Algorithm 2 for LROA [device]
  3. sample K draws with replacement by q^t; DivFL picks its K
     clients by its greedy instead (``DivFLController.select``)     [host]
  4. + 5. ``RoundEngine.round_step``: gather the K selected clients from
     the bank, train them as one batch per tier they fall in (E epochs
     of masked mini-batch SGD), and apply the unbiased eq.-(4)
     aggregation through one launch of the hand-written CUDA
     ``fl_aggregate`` kernel                                      [device]
  6. the queues update; latency += max_{n in K^t} T_n^t (eq. 10)   [device]

``use_engine=False`` takes the sequential path instead of step 4 + 5:
one ``client.local_update`` per selected client on its true examples
(``bank.client_view``), DivFL observing each update's sketch
(``client.flatten_update``) before the next client trains — the
reference semantics of DivFL — and the eq.-(4) step as the list API
``server.aggregate`` (DivFL: ``server.fedavg_reference`` over the
selected clients' data weights), plain PyTorch on every device.

``mesh=`` (a ``launch.mesh`` mesh, one ``torch.distributed`` rank per
shard; every rank builds the same trainer) shards the client axis: the
bank's rows split over the ranks, each round's K slots trained K/shards
per rank, the eq.-(4) partials summed by one ``all_reduce`` (see
``fl.round_engine``).  The control plane runs on every rank with the same
bits, so every rank holds the same params, selections and records.

The same ``seed`` gives the JAX trainer's channel gains and selections
(numpy streams).  The model init and the per-client epoch keys come from
``torch.Generator``s; ``sort_keys_fn`` replaces the latter (the parity
tests pass the reference's keys through it).  The keys are ``[K, E, B]``
with ``B`` the bank's widest bucket; a client in a narrower tier reads
their first ``B_t`` columns.  The sequential path draws each client's
``[E, n']`` keys (``n'`` its rows after tiling to one batch) from the
same generator, one client after another; ``client_keys_fn(n')``
replaces them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import system_model as sm
from repro_torch.core.baselines import DivFLController
from repro_torch.core.controller import realized_round_time
from repro_torch.fl import client as fl_client
from repro_torch.fl import server as fl_server
from repro_torch.fl.client_bank import TieredClientBank, upload, widen
from repro_torch.fl.environment import ChannelProcess
from repro_torch.fl.round_engine import RoundEngine
from repro_torch.obs import trace as obs_trace

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class RoundRecord:
    round: int
    wall_time: float          # realised latency of this round (eq. 10)
    cum_time: float
    mean_loss: float
    selected: List[int]
    q_min: float
    q_max: float
    queue_mean: float
    energy_mean: float        # realised mean energy this round
    test_accuracy: Optional[float] = None


@dataclasses.dataclass
class FLRunResult:
    records: List[RoundRecord]
    params: Params
    controller_name: str

    @property
    def total_time(self) -> float:
        return self.records[-1].cum_time if self.records else 0.0

    def accuracy_curve(self) -> List[tuple]:
        """``(round, cum_time, test_accuracy)`` of every evaluated round."""
        return [(r.round, r.cum_time, r.test_accuracy)
                for r in self.records if r.test_accuracy is not None]


class FederatedTrainer:
    """Synchronous FL loop on one device, or on the ranks of ``mesh``:
    the fused round engine path (``use_engine=True``) or the sequential
    reference path."""

    def __init__(self, task, params: sm.SystemParams, controller,
                 channel: ChannelProcess, client_data: Sequence[tuple],
                 client_cfg: fl_client.ClientConfig,
                 lr_schedule: Callable[[int], float],
                 test_data: Optional[tuple] = None,
                 eval_every: int = 10, seed: int = 0,
                 bank_mode: str = "auto", impl: str = "auto", device="cuda",
                 sort_keys_fn: Optional[Callable[[int], np.ndarray]] = None,
                 bank_storage: str = "fp32", use_engine: bool = True,
                 client_keys_fn: Optional[Callable[[int], np.ndarray]]
                 = None, mesh=None):
        if len(client_data) != params.num_devices:
            raise ValueError(f"{len(client_data)} client datasets for "
                             f"{params.num_devices} devices")
        self.device = torch.device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"SystemParams live on {params.device}, the "
                             f"trainer on {self.device}")
        self.task = task
        self.params = params
        self.controller = controller
        self.channel = channel
        self.client_cfg = client_cfg
        self.lr_schedule = lr_schedule
        self.eval_every = eval_every
        self.use_engine = use_engine
        self.engine = RoundEngine(task, client_cfg, impl=impl,
                                  device=self.device, mesh=mesh)
        # the ONE upload of client data: every round reads the bank
        self.bank = self.engine.make_bank(client_data, tiered=bank_mode,
                                          storage=bank_storage)
        self.test_data = None
        if test_data is not None:
            # in the data's dtypes, as the JAX package holds it; widened
            # where evaluate reads it
            self.test_data = (upload(test_data[0], self.device,
                                     task.device_layout),
                              upload(test_data[1], self.device))
        self._np_rng = np.random.default_rng(seed)
        self._key_gen = torch.Generator(device=self.device)
        self._key_gen.manual_seed(seed)
        init_gen = torch.Generator(device=self.device)
        init_gen.manual_seed(seed + 1)
        self.global_params = task.init(init_gen)
        self._sort_keys_fn = sort_keys_fn
        self._client_keys_fn = client_keys_fn
        self.w = params.data_weights.cpu().numpy()
        self._records: List[RoundRecord] = []
        #: the most recent round's (f, p, q) decision
        self.last_decision = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _fused(self) -> bool:
        """True when rounds run on the fused engine path (the one rule
        ``run_round`` and ``warmup`` share)."""
        return self.use_engine

    # -- warmup -----------------------------------------------------------

    def warmup(self) -> None:
        """Run every code path a round takes once — the kernel build, the
        cuDNN/cuBLAS set-up, the solver — without changing any trainer
        state: keys from a throwaway generator, zero lr and zero
        coefficients, one decision.  Fused path: rounds on a copy of the
        params; on a ladder, one round per tier (each tier's SGD shape)
        and one whose slots cycle through the tiers (the routed round).
        Sequential path: one ``local_update`` per distinct effective
        client size (``max(n, bs)``), its update discarded."""
        k = self.params.sample_count
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        if self._fused:
            keys = torch.rand((k, self.client_cfg.local_epochs,
                               self.bank.bucket_examples), generator=gen,
                              device=self.device)
            sels = [np.zeros(k, np.int64)]
            if isinstance(self.bank, TieredClientBank) and \
                    self.bank.num_tiers > 1:
                reps = [int(m[0]) for m in self.bank.tier_members]
                sels = [np.full(k, r, np.int64) for r in reps]
                sels.append(np.asarray([reps[i % len(reps)]
                                        for i in range(k)], np.int64))
            p = {name: v.clone() for name, v in self.global_params.items()}
            for sel in sels:
                self.engine.round_step(p, self.bank, sel,
                                       np.zeros(k, np.float32), 0.0, keys)
        else:
            seen = set()
            bs = self.client_cfg.batch_size
            for i, n in enumerate(self.bank.sizes):
                eff = max(int(n), bs)   # local_update tiles n < bs up to bs
                if eff in seen:
                    continue
                seen.add(eff)
                x, y = self.bank.client_view(i)
                fl_client.local_update(self.task, self.global_params, x, y,
                                       0.0, self.client_cfg, generator=gen)
        self.controller.decide(torch.ones(self.params.num_devices,
                                          device=self.device))
        if self.test_data is not None:
            self.evaluate()
        self._sync()

    # -- evaluation -------------------------------------------------------

    def evaluate(self) -> float:
        if self.test_data is None:
            return float("nan")
        x, y = widen(*self.test_data)
        with torch.no_grad():
            m = self.task.metrics(self.global_params, {"x": x, "y": y})
        return float(m["accuracy"])

    # -- one round --------------------------------------------------------

    def _client_sort_keys(self, count: int) -> torch.Tensor:
        """[count, E, B] uniform epoch-order keys for this round's
        clients: from ``sort_keys_fn`` when given, else the trainer's
        generator."""
        shape = (count, self.client_cfg.local_epochs,
                 self.bank.bucket_examples)
        if self._sort_keys_fn is not None:
            return torch.as_tensor(np.asarray(self._sort_keys_fn(count),
                                              np.float32),
                                   device=self.device).reshape(shape)
        return torch.rand(shape, generator=self._key_gen,
                          device=self.device)

    def _train_fused(self, selected: np.ndarray, coeffs: np.ndarray,
                     lr: float) -> np.ndarray:
        """The fused path: one ``RoundEngine.round_step`` gathers the
        selected clients from the bank, trains all K and applies eq. (4)
        in one ``fl_aggregate`` launch on the card."""
        self.global_params, losses = self.engine.round_step(
            self.global_params, self.bank, selected, coeffs, lr,
            self._client_sort_keys(len(selected)))
        return losses.cpu().numpy()

    def _train_sequential(self, selected: np.ndarray, coeffs: np.ndarray,
                          lr: float) -> np.ndarray:
        """The sequential path: one ``local_update`` per selected client on
        its true examples; DivFL observes each update before the next
        client trains and averages by data weight."""
        divfl = isinstance(self.controller, DivFLController)
        deltas, losses = [], []
        for idx in selected:
            x, y = self.bank.client_view(int(idx))
            keys = None
            if self._client_keys_fn is not None:
                rows = max(x.shape[0], self.client_cfg.batch_size)
                keys = np.asarray(self._client_keys_fn(rows), np.float32)
            delta, loss = fl_client.local_update(
                self.task, self.global_params, x, y, lr, self.client_cfg,
                sort_keys=keys, generator=self._key_gen)
            deltas.append(delta)
            losses.append(loss)
            if divfl:
                self.controller.observe_updates(
                    np.asarray([idx]),
                    fl_client.flatten_update(delta, self.task)[None, :])
        if divfl:
            self.global_params = fl_server.fedavg_reference(
                self.global_params, deltas, self.w[np.asarray(selected)])
        else:
            self.global_params = fl_server.aggregate(self.global_params,
                                                     deltas, coeffs)
        return np.asarray(losses)

    def run_round(self, t: int) -> RoundRecord:
        with obs_trace.span("trainer.round", t=int(t)):
            return self._run_round_impl(t)

    def _run_round_impl(self, t: int) -> RoundRecord:
        k = self.params.sample_count
        h = torch.as_tensor(self.channel.sample(), device=self.device)
        with obs_trace.span("controller.decide"):
            decision = self.last_decision = self.controller.decide(h)
            q = decision.q.cpu().numpy()
        if isinstance(self.controller, DivFLController):
            selected = self.controller.select(h)
        else:
            selected = fl_server.sample_clients(self._np_rng, q, k)
        lr = float(self.lr_schedule(t))
        coeffs = fl_server.aggregation_weights(selected, q, self.w, k)
        train = self._train_fused if self._fused else self._train_sequential
        losses = train(selected, coeffs, lr)

        wall = realized_round_time(self.params, h, decision, selected)
        e_round = sm.round_energy(self.params, h, decision.p,
                                  decision.f).cpu().numpy()
        queues = self.controller.step_queues(h, decision)

        cum = (self._records[-1].cum_time if self._records else 0.0) + wall
        rec = RoundRecord(
            round=t, wall_time=wall, cum_time=cum,
            mean_loss=float(np.mean(losses)),
            selected=[int(i) for i in selected],
            q_min=float(q.min()), q_max=float(q.max()),
            queue_mean=float(queues.mean()),
            energy_mean=float(e_round[np.unique(selected)].mean()),
        )
        if self.test_data is not None and (t % self.eval_every == 0):
            rec.test_accuracy = self.evaluate()
        self._records.append(rec)
        return rec

    # -- full run ---------------------------------------------------------

    def run(self, num_rounds: int, verbose: bool = False) -> FLRunResult:
        self._records = []
        for t in range(num_rounds):
            rec = self.run_round(t)
            if verbose and (t % max(num_rounds // 10, 1) == 0):
                print(f"[{getattr(self.controller, 'name', '?')}] round {t} "
                      f"loss {rec.mean_loss:.4f} wall {rec.wall_time:.1f}s "
                      f"cum {rec.cum_time:.0f}s acc {rec.test_accuracy}")
        if self.test_data is not None and self._records:
            self._records[-1].test_accuracy = self.evaluate()
        params = {name: v.clone() for name, v in self.global_params.items()}
        return FLRunResult(records=self._records, params=params,
                           controller_name=getattr(self.controller, "name",
                                                   "unknown"))
