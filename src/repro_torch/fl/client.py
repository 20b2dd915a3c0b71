"""Client-side local training: E epochs of mini-batch SGD (Algorithm 1,
l.9) for K clients at once — the port of ``repro.fl.client``: the
batched path (``batched_local_sgd`` over ``_local_sgd_body``), the
one-client path (:func:`local_update`, the sequential reference and
DivFL's) and DivFL's update sketch (:func:`flatten_update`).

The K clients' parameters and momentum are ``[K, ...]`` stacks, and each
SGD step is ONE ``torch.func.vmap(torch.func.grad_and_value(loss_fn))``
call over them.  The function returns the stacked updates
``theta^{t,E} - theta^t`` (Algorithm 1, l.10) and per-client losses for
the server's eq.-(4) aggregation.

Padding / bucketing contract (the JAX package's, verbatim): every client
in the ``[K, B, ...]`` batch is cyclically tiled to the bank's bucket of
``B`` rows, and

* each epoch's order is a *stable* argsort of uniform keys; with
  ``num_examples`` given, padded rows (``j >= n_i``) get the sentinel key
  2.0 and sort last, so an epoch samples without replacement from the
  client's true examples;
* ``num_steps`` masks the parameters, the momentum and the loss of every
  step past a client's true ``max(n_i // bs, 1)`` steps, with ``where``;
* the epoch loss is ``sum / num_steps`` (masked) or the mean over steps
  (unmasked), and the client loss is the mean over epochs.

The uniform keys come in as ``sort_keys`` ``[K, E, B]`` or are drawn from
a ``torch.Generator``.  The JAX package draws them from threefry keys,
which torch cannot reproduce, so parity tests pass the reference's keys
in as data.  ``ClientConfig.max_grad_norm > 0`` clips each client's
gradient to that global norm before its SGD step.

:func:`local_update` trains ONE client on its true examples: a client
with fewer than ``bs`` examples is tiled up to one batch
(``pad_client_data``), every epoch takes ``max(n // bs, 1)`` unmasked
steps, and the body is :func:`batched_local_sgd` at K = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Protocol, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.convert import params_to_jax_layout
from repro_torch.data.pipeline import pad_client_data
from repro_torch.optim import (SGD, SGDState, apply_updates,
                               clip_by_global_norm)

Params = Dict[str, torch.Tensor]
LossFn = Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]

#: sort key of padded rows: after every uniform key in [0, 1)
_PAD_KEY = 2.0


class Task(Protocol):
    """Minimal model interface the FL substrate trains against (the
    port's tasks in ``repro_torch.models.cnn``)."""

    def init(self, generator: torch.Generator) -> Params: ...

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor: ...

    def metrics(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]: ...

    def device_layout(self, x: torch.Tensor) -> torch.Tensor: ...


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    local_epochs: int = 2
    batch_size: int = 32
    momentum: float = 0.9
    max_grad_norm: float = 0.0     # 0 => no clipping


def _keep(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor
          ) -> torch.Tensor:
    """``where(mask, new, old)`` with the ``[K]`` mask broadcast over the
    trailing axes of a ``[K, ...]`` leaf."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def _grad_fn(loss_fn: LossFn, max_grad_norm: float):
    """``grad_and_value(loss_fn)``, its gradient clipped to
    ``max_grad_norm`` when that is positive."""
    fn = grad_and_value(loss_fn)
    if max_grad_norm <= 0:
        return fn

    def clipped(params, batch):
        grads, loss = fn(params, batch)
        return clip_by_global_norm(grads, max_grad_norm), loss

    return clipped


def batched_local_sgd(loss_fn: LossFn, params: Params, xs: torch.Tensor,
                      ys: torch.Tensor, lr, cfg: ClientConfig,
                      steps_per_epoch: int,
                      num_steps: Optional[torch.Tensor] = None,
                      num_examples: Optional[torch.Tensor] = None,
                      sort_keys: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      per_client: bool = False
                      ) -> Tuple[Params, torch.Tensor]:
    """E epochs of shuffled mini-batch SGD for a stacked ``[K, B, ...]``
    client batch, all K clients starting from ``params`` — or, with
    ``per_client=True``, client i from ``{n: v[i]}`` of ``[K, ...]``
    leaves (the scenario arena's S lanes of K_max clients each, every
    lane's model repeated over its slots), each delta taken against the
    client's own start.

    ``num_steps`` / ``num_examples`` (``[K]`` int tensors or None) carry
    each client's true per-epoch step count and dataset size (see the
    module docstring); ``sort_keys`` (``[K, E, B]`` floats in [0, 1), or
    None to draw them from ``generator``) fixes every epoch's order.
    Returns stacked deltas (leaves ``[K, ...]``) and per-client losses
    ``[K]``.
    """
    k, n = xs.shape[0], xs.shape[1]
    bs = cfg.batch_size
    used = steps_per_epoch * bs
    dev = xs.device
    if sort_keys is None:
        sort_keys = torch.rand((k, cfg.local_epochs, n), generator=generator,
                               device=dev)
    if tuple(sort_keys.shape) != (k, cfg.local_epochs, n):
        raise ValueError(f"sort_keys must be [{k}, {cfg.local_epochs}, {n}],"
                         f" got {tuple(sort_keys.shape)}")
    opt = SGD(momentum=cfg.momentum)
    if per_client:
        bad = {name: tuple(v.shape) for name, v in params.items()
               if v.dim() < 1 or v.shape[0] != k}
        if bad:
            raise ValueError(f"per_client params must be [{k}, ...] "
                             f"leaves, got {bad}")
        p = {name: v.clone() for name, v in params.items()}
    else:
        p = {name: v.unsqueeze(0).expand((k,) + tuple(v.shape)).clone()
             for name, v in params.items()}
    m = opt.init(p).momentum
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    step_fn = vmap(_grad_fn(loss_fn, cfg.max_grad_norm))
    rows = torch.arange(k, device=dev)[:, None]
    padded = (None if num_examples is None else
              torch.arange(n, device=dev)[None, :] >= num_examples[:, None])
    keep = (None if num_steps is None else
            torch.arange(steps_per_epoch, device=dev)[None, :]
            < num_steps[:, None])                       # [K, steps]

    epoch_losses = []
    for e in range(cfg.local_epochs):
        scores = sort_keys[:, e]
        if padded is not None:
            scores = torch.where(padded, _PAD_KEY, scores)
        perm = torch.argsort(scores, dim=1, stable=True)[:, :used]
        xe = xs[rows, perm].reshape((k, steps_per_epoch, bs) + xs.shape[2:])
        ye = ys[rows, perm].reshape((k, steps_per_epoch, bs) + ys.shape[2:])
        losses = []
        for s in range(steps_per_epoch):
            grads, loss = step_fn(p, {"x": xe[:, s], "y": ye[:, s]})
            updates, new_state = opt.update(grads, SGDState(m), p, lr)
            new_p, new_m = apply_updates(p, updates), new_state.momentum
            if keep is None:
                p, m = new_p, new_m
            else:
                ks = keep[:, s]
                p = {name: _keep(ks, new_p[name], v) for name, v in p.items()}
                m = {name: _keep(ks, new_m[name], v) for name, v in m.items()}
                loss = torch.where(ks, loss, 0.0)
            losses.append(loss)
        losses = torch.stack(losses, dim=1)              # [K, steps]
        if num_steps is None:
            epoch_losses.append(losses.mean(dim=1))
        else:
            epoch_losses.append(losses.sum(dim=1)
                                / num_steps.to(torch.float32))
    deltas = {name: p[name] - v for name, v in params.items()}
    return deltas, torch.stack(epoch_losses, dim=1).mean(dim=1)


def local_update(task: Task, global_params: Params, data_x: np.ndarray,
                 data_y: np.ndarray, lr, cfg: ClientConfig,
                 sort_keys: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Params, float]:
    """Run E local epochs of one client on its true (x, y) (host arrays,
    the JAX package's NHWC layout); return (theta^{t,E} - theta^t, mean
    loss).  ``sort_keys`` ``[E, n']`` (``n'`` the rows after tiling a
    client of fewer than ``bs`` examples up to one batch), or None to
    draw them from ``generator`` on the params' device."""
    bs = cfg.batch_size
    steps = max(data_x.shape[0] // bs, 1)
    if data_x.shape[0] < steps * bs:
        data_x, data_y = pad_client_data(np.asarray(data_x),
                                         np.asarray(data_y), steps * bs)
    dev = next(iter(global_params.values())).device
    xs = task.device_layout(torch.as_tensor(
        np.asarray(data_x, np.float32), device=dev))[None]
    ys = torch.as_tensor(np.asarray(data_y).astype(np.int64),
                         device=dev)[None]
    if sort_keys is not None:
        sort_keys = torch.as_tensor(sort_keys, dtype=torch.float32,
                                    device=dev)[None]
    deltas, losses = batched_local_sgd(
        task.loss_fn, global_params, xs, ys, lr, cfg, steps,
        sort_keys=sort_keys, generator=generator)
    return {name: d[0] for name, d in deltas.items()}, float(losses[0])


def flatten_update(delta: Params, task: Task, proj_dim: int = 256,
                   seed: int = 0) -> np.ndarray:
    """Random-project an update dict to a small vector (DivFL similarity).

    A count-sketch style signed bucket projection — O(d) time,
    deterministic in ``seed`` — so similarity costs O(N^2 proj_dim)
    instead of O(N^2 d).  Its input is the JAX package's: the leaves in
    sorted-name order, each raveled in the JAX layout
    (``params_to_jax_layout`` of ``task``), so the sketch, and the
    selections DivFL makes from it, are the reference's.
    """
    leaves = params_to_jax_layout(delta, task)
    flat = (np.concatenate([leaves[n].ravel() for n in sorted(leaves)])
            if leaves else np.zeros((1,), np.float32))
    rng = np.random.default_rng(seed)
    buckets = rng.integers(0, proj_dim, flat.shape[0])
    signs = rng.choice(np.asarray([-1.0, 1.0], np.float32), flat.shape[0])
    out = np.zeros((proj_dim,), np.float32)
    np.add.at(out, buckets, flat * signs)
    return out
