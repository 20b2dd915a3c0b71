"""ClientBank — the device-resident FL data plane; the port of the
single-bucket ``repro.fl.client_bank.ClientBank``.

ALL N clients' bucketed data is tiled and stacked to ``[N, B, ...]`` once
at construction, uploaded once, and every round gathers its K selected
rows on the device (``index_select``) — no per-round host-to-device
transfer of client data.

* The inputs are stored in fp32, in the layout the task reads
  (``x_layout``, e.g. ``CNNTask.device_layout``: NHWC -> NCHW), applied
  once at upload so no SGD step permutes its batch.
* Labels are stored int64 (what ``F.cross_entropy`` takes), the
  ``num_steps`` / ``num_examples`` masks as int64 ``[N]``.
* One GLOBAL bucket ``B = bucket_num_batches(max_i ceil(n_i / bs)) * bs``
  covers every client (see ``repro_torch.data.pipeline``); the masks
  keep padded clients at their true step counts and examples.

This slice ports the single-bucket fp32 bank only: the multi-tier
``TieredClientBank``, ``storage='int8'`` and cluster routing are the
scale plane (ROADMAP A6) and raise here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import (stack_client_arrays,
                                       validate_client_data)
from repro_torch.fl.client import ClientConfig

SCALE_PLANE = ("is part of the scale plane (ROADMAP A6), not yet ported to "
               "repro_torch")


class ClientBank:
    """Device-resident ``[N, B, ...]`` stacks of every client's data."""

    def __init__(self, client_data: Sequence[tuple],
                 client_cfg: ClientConfig, device="cuda",
                 x_layout: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None,
                 storage: str = "fp32", clusters: Optional[int] = None):
        if storage != "fp32":
            raise NotImplementedError(f"storage={storage!r} {SCALE_PLANE}")
        if clusters is not None:
            raise NotImplementedError(f"clusters= {SCALE_PLANE}")
        validate_client_data(client_data)
        self.batch_size = client_cfg.batch_size
        self.storage = storage
        self.device = torch.device(device)
        host_x, host_y, num_steps, num_examples = stack_client_arrays(
            client_data, self.batch_size)
        self._num_examples = num_examples
        self.num_clients = host_x.shape[0]
        self.bucket_examples = host_x.shape[1]
        self.steps_per_epoch = self.bucket_examples // self.batch_size
        # every client exactly fills the bucket => the masks are inert and
        # the unmasked SGD path runs
        self.uniform = bool(np.all(num_examples == self.bucket_examples))
        xs = torch.as_tensor(host_x.astype(np.float32, copy=False),
                             device=self.device)
        self.xs = (x_layout(xs) if x_layout is not None else xs).contiguous()
        self.ys = torch.as_tensor(host_y.astype(np.int64),
                                  device=self.device)
        self.num_steps = torch.as_tensor(num_steps.astype(np.int64),
                                         device=self.device)
        self.num_examples = torch.as_tensor(num_examples.astype(np.int64),
                                            device=self.device)

    @property
    def sizes(self) -> np.ndarray:
        """True per-client dataset sizes ``n_i`` (host, [N])."""
        return self._num_examples

    @property
    def nbytes(self) -> int:
        """Device bytes held: the xs/ys stacks and the two masks."""
        arrs = [self.xs, self.ys, self.num_steps, self.num_examples]
        return int(sum(a.numel() * a.element_size() for a in arrs))

    def device_args(self) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """(xs, ys, num_steps, num_examples); the masks are None for a
        uniform bank (every client fills the bucket)."""
        if self.uniform:
            return self.xs, self.ys, None, None
        return self.xs, self.ys, self.num_steps, self.num_examples
