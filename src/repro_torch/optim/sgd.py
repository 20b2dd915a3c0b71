"""Heavy-ball SGD over ``dict[str, Tensor]`` parameters — the port of the
SGD half of ``repro.optim.sgd`` (momentum only: the FL clients use no
weight decay and no Nesterov step) and of its global-norm clipping.

    state = opt.init(params)
    updates, state = opt.update(grads, state, lr)
    params = apply_updates(params, updates)

with ``m = momentum * m + g`` and ``update = -lr * m``, as in the JAX
package.  Works on stacked ``[K, ...]`` parameters unchanged (every op is
elementwise; ``lr`` may be a float or a tensor broadcastable to them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def apply_updates(params: Params, updates: Params) -> Params:
    return {name: (p + updates[name]).to(p.dtype)
            for name, p in params.items()}


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32), the leaves
    in sorted-name order as the JAX package flattens a dict."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[n].to(torch.float32)))
                          for n in sorted(tree)))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm(grads),
                                               min=1e-12), max=1.0)
    return {name: g * scale for name, g in grads.items()}


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with heavy-ball momentum (the paper's local optimizer:
    momentum 0.9)."""
    momentum: float = 0.9

    def init(self, params: Params) -> Params:
        return {name: torch.zeros_like(p, dtype=torch.float32)
                for name, p in params.items()}

    def update(self, grads: Params, momentum: Params, lr
               ) -> Tuple[Params, Params]:
        new_m = {name: self.momentum * m + grads[name].to(torch.float32)
                 for name, m in momentum.items()}
        updates = {name: -lr * m for name, m in new_m.items()}
        return updates, new_m
