"""SGD with momentum and AdamW over parameter trees, the port of
``repro.optim.sgd``, in its (init, update) style:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, lr)
    params = apply_updates(params, updates)

Trees are nested dicts / NamedTuples of tensors (``repro_torch.tree``):
a flat ``dict[str, Tensor]`` of an FL task or an LM's nested tree.  Every
op is elementwise, so stacked ``[K, ...]`` parameters work unchanged
(``lr`` a float or a tensor broadcastable to them).  The state is f32,
and :func:`apply_updates` casts back to each parameter's dtype, as the
JAX package does.

:meth:`SGD.step_` is the same update written into ``params`` and the
state in place, leaf by leaf, for the LM training steps: it never holds
a second copy of the parameters or the momentum (an f32 momentum of
gemma-2b is 10 GB).  The numbers are those of ``update`` followed by
``apply_updates``; on an H100 80GB it holds a gemma-2b train step at a
37.9 GB peak and an FL round at 48.6 GB, against 52.6 and 67.6 GB by
the functional path (``chip_smoke.py``, ``_step_peak``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``(p + u)`` cast to ``p``'s dtype, leaf by leaf."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (f32), the leaves
    in the JAX package's order (dict keys sorted)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``."""
    scale = torch.clamp(max_norm / torch.clamp(global_norm(grads),
                                               min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


class SGDState(NamedTuple):
    momentum: Tree


@dataclasses.dataclass(frozen=True)
class SGD:
    """SGD with (heavy-ball) momentum and optional weight decay.

    The paper's local optimizer: momentum 0.9, lr 0.05 (CIFAR-10) /
    0.1 (FEMNIST), halved at 50% and 75% of training.
    """
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params: Tree) -> SGDState:
        return SGDState(tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def _leaf(self, g, m, p, lr) -> Tuple[torch.Tensor, torch.Tensor]:
        """(update, new momentum) of one leaf."""
        if self.weight_decay:
            g = g + self.weight_decay * p.to(g.dtype)
        new_m = self.momentum * m + g.to(torch.float32)
        eff = (self.momentum * new_m + g.to(torch.float32)
               if self.nesterov else new_m)
        return -lr * eff, new_m

    def update(self, grads: Tree, state: SGDState, params: Tree, lr
               ) -> Tuple[Tree, SGDState]:
        pairs = tree_map(lambda g, m, p: self._leaf(g, m, p, lr), grads,
                         state.momentum, params)
        return (tree_map(lambda pair: pair[0], pairs),
                SGDState(tree_map(lambda pair: pair[1], pairs)))

    @torch.no_grad()
    def step_(self, grads: Tree, state: SGDState, params: Tree, lr) -> None:
        """:meth:`update` and :func:`apply_updates` in place: each leaf of
        ``state.momentum`` and ``params`` is overwritten before the next
        leaf is computed."""
        def leaf(g, m, p):
            u, new_m = self._leaf(g, m, p, lr)
            m.copy_(new_m)
            p.copy_((p + u).to(p.dtype))

        tree_map(leaf, grads, state.momentum, params)


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Tree) -> AdamWState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        device = next(tree_leaves(params)).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          tree_map(z, params), tree_map(z, params))

    def update(self, grads: Tree, state: AdamWState, params: Tree, lr
               ) -> Tuple[Tree, AdamWState]:
        f32 = torch.float32
        step = state.step + 1
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g.to(f32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v
                      + (1 - self.b2) * torch.square(g.to(f32)),
                      state.nu, grads)
        bc1 = 1 - self.b1 ** step.to(f32)
        bc2 = 1 - self.b2 ** step.to(f32)

        def upd(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.to(f32)
            return -lr * u

        return tree_map(upd, mu, nu, params), AdamWState(step, mu, nu)
