"""Device-resident FL round engine over a ClientBank — the port of
``repro.fl.round_engine.RoundEngine``'s single-round path.

A round is

    gather the K selected rows of the bank       (index_select on device)
      -> K-client batched E-epoch local SGD       (client.batched_local_sgd)
      -> eq.-(4) aggregation                      (server.aggregate_fused;
                                                   ONE hand-written CUDA
                                                   fl_aggregate launch)

with no per-round host-to-device transfer of client data.  One gather
core (:meth:`_gathered_round`) feeds one round core (:meth:`_round_core`),
as in the JAX package.

This slice ports the fused single-bucket round (``make_bank`` with
``'single'``, or ``'auto'`` when the partition fits one tier) without a
mesh.  The tier ladder, ``run_scan``, the host-stacked round and the
client-axis sharding are later slices (ROADMAP queue A) and raise or are
absent here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import assign_tiers, validate_client_data
from repro_torch.fl import client as fl_client
from repro_torch.fl import server as fl_server
from repro_torch.fl.client_bank import SCALE_PLANE, ClientBank
from repro_torch.kernels.ops import IMPLS
from repro_torch.obs import trace as obs_trace

Params = Dict[str, torch.Tensor]


class RoundEngine:
    """Executes FL rounds as device-resident computations on ``device``.

    ``impl`` selects the eq.-(4) path (see ``repro_torch.kernels.ops``):
    'auto' launches the CUDA kernel on a CUDA device and runs the plain
    per-leaf reduce on the CPU.
    """

    def __init__(self, task, client_cfg: fl_client.ClientConfig,
                 impl: str = "auto", device="cuda"):
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.task = task
        self.cfg = client_cfg
        self.impl = impl
        self.device = torch.device(device)

    def make_bank(self, client_data, tiered: str = "auto") -> ClientBank:
        """Build the device-resident bank this engine's rounds gather from.

        ``tiered``: 'single' forces the one-global-bucket
        :class:`ClientBank`; 'auto' builds it when the partition fits one
        size tier.  A multi-tier ladder ('tiered', or 'auto' on a
        partition spanning several tiers) raises ``NotImplementedError``.
        """
        if tiered not in ("auto", "single", "tiered"):
            raise ValueError(f"unknown bank mode {tiered!r}")
        if tiered == "tiered":
            raise NotImplementedError(f"TieredClientBank {SCALE_PLANE}")
        if tiered == "auto":
            validate_client_data(client_data)
            sizes = [int(np.asarray(x).shape[0]) for x, _ in client_data]
            _, buckets = assign_tiers(sizes, self.cfg.batch_size)
            if len(buckets) > 1:
                raise NotImplementedError(
                    f"this partition spans {len(buckets)} bucket tiers; "
                    f"the multi-tier TieredClientBank {SCALE_PLANE} — "
                    f"pass bank_mode='single' for one global bucket")
        return ClientBank(client_data, self.cfg, device=self.device,
                          x_layout=self.task.device_layout)

    # -- shared round core -------------------------------------------------

    def _round_core(self, params: Params, xs, ys, coeffs, lr, num_steps,
                    num_examples, steps: int, sort_keys
                    ) -> Tuple[Params, torch.Tensor]:
        """Train the stacked clients, then aggregate (eq. 4)."""
        deltas, losses = fl_client.batched_local_sgd(
            self.task.loss_fn, params, xs, ys, lr, self.cfg, steps,
            num_steps=num_steps, num_examples=num_examples,
            sort_keys=sort_keys)
        return fl_server.aggregate_fused(params, deltas, coeffs,
                                         impl=self.impl), losses

    def _gathered_round(self, params: Params, all_x, all_y, all_steps,
                        all_sizes, selected, coeffs, lr, steps: int,
                        sort_keys) -> Tuple[Params, torch.Tensor]:
        """THE gather core: take K clients' rows from the ``[N, ...]``
        bank stacks on the device and run the round on them."""
        xs = torch.index_select(all_x, 0, selected)
        ys = torch.index_select(all_y, 0, selected)
        ns = None if all_steps is None else torch.index_select(
            all_steps, 0, selected)
        ne = None if all_sizes is None else torch.index_select(
            all_sizes, 0, selected)
        return self._round_core(params, xs, ys, coeffs, lr, ns, ne, steps,
                                sort_keys)

    def round_step(self, global_params: Params, bank: ClientBank,
                   selected: np.ndarray, coeffs: np.ndarray, lr: float,
                   sort_keys: torch.Tensor) -> Tuple[Params, torch.Tensor]:
        """One round gathered from the device-resident bank.

        ``selected``: [K] client indices; ``coeffs``: [K] per-draw eq.-(4)
        weights; ``sort_keys``: [K, E, B] uniform epoch-order keys.
        Returns (new global params, per-client losses [K]); the launches
        are queued on the current stream and not waited for.
        """
        selected = np.asarray(selected)
        if selected.size and not (0 <= int(selected.min()) and
                                  int(selected.max()) < bank.num_clients):
            raise IndexError(
                f"selected indices {selected} out of range for bank of "
                f"{bank.num_clients} clients")
        all_x, all_y, all_steps, all_sizes = bank.device_args()
        dev = self.device
        with obs_trace.span("engine.round", k=int(selected.size)):
            return self._gathered_round(
                global_params, all_x, all_y, all_steps, all_sizes,
                torch.as_tensor(selected.astype(np.int64), device=dev),
                torch.as_tensor(np.asarray(coeffs, np.float32), device=dev),
                lr, bank.steps_per_epoch,
                torch.as_tensor(sort_keys, dtype=torch.float32, device=dev))
