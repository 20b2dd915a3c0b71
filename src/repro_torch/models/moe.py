"""Mixture-of-Experts layer, ported from ``repro.models.moe``: a softmax
top-k router, the GShard/Switch capacity semantics and the Switch
load-balance loss.

Three dispatches, as in the JAX package:

* ``"sort"`` (train and prefill): per token group, the (token, slot)
  pairs are stably sorted by expert, the first ``capacity`` of each
  expert fill its buffer ``[E, C, d]``, the experts run as batched
  products, and the slots are gathered back;
* ``"capacity"``: the GShard one-hot einsum dispatch over all tokens
  (one group), the small-shape oracle; the same keep-set as ``"sort"``
  with one group;
* ``"dense"`` (decode): every expert computes every token, combined by
  the router's mass; drop-free.

The keep-set is the JAX package's exactly: the top k are taken from a
stable descending sort (``jax.lax.top_k`` breaks ties toward the lower
expert index; ``torch.topk`` promises no order), the slots from a stable
argsort, and the capacities from Python's ``round``.  The combine is
deterministic: no scatter-add (``index_add_`` on the card sums in a
different order every run); the slots are un-permuted to ``[T, k, d]``
and summed over k in rank order (the router's first choice first).

The experts' activation is ``silu`` whatever ``cfg.activation`` says, as
in the JAX package (grok-1's card says ``gelu``; ROADMAP.md §C).  The
expert products are ``einsum``s, as they are outside any Pallas kernel
in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]

DISPATCHES = ("sort", "capacity", "dense")


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    """Router ``[d, E]``, experts ``w_up`` / ``w_gate`` ``[E, d, ff]`` and
    ``w_down`` ``[E, ff, d]``, each expert's matrix drawn with the JAX
    package's fan-in (d for up and gate, ff for down) straight into its
    slot."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dev = gen.device

    def experts(rows, cols):
        w = torch.empty((e, rows, cols), dtype=dtype, device=dev)
        for i in range(e):
            L.dense_init(gen, rows, cols, dtype, out=w[i])
        return w

    p = {"router": L.dense_init(gen, d, e, dtype),
         "w_up": experts(d, ff),
         "w_down": experts(ff, d)}
    if cfg.gated_mlp:
        p["w_gate"] = experts(d, ff)
    return p


def router_probs(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Softmax router over experts in f32: x [..., d] -> [..., E]."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    return torch.softmax(logits, dim=-1)


def load_balance_loss(probs: torch.Tensor,
                      expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch aux loss: E * sum_e (fraction routed to e) * (mean prob
    of e)."""
    e = probs.shape[-1]
    density = expert_mask.to(torch.float32).reshape(-1, e).mean(dim=0)
    mean_prob = probs.reshape(-1, e).mean(dim=0)
    return e * torch.sum(density * mean_prob)


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_act(xe: torch.Tensor, params: Params, cfg: ModelConfig,
                spec: str) -> torch.Tensor:
    """The experts' hidden activation ``silu(x W_gate) * (x W_up)`` (or
    ``silu(x W_up)``) for ``einsum`` spec ``spec`` (input, expert
    weights -> hidden)."""
    up = torch.einsum(spec, xe, params["w_up"])
    if cfg.gated_mlp:
        return F.silu(torch.einsum(spec, xe, params["w_gate"])) * up
    return F.silu(up)


def _expert_ffn(params: Params, xe: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Batched per-expert FFN: xe [E, C, d] -> [E, C, d]."""
    return torch.einsum("ecf,efd->ecd", _expert_act(xe, params, cfg,
                                                    "ecd,edf->ecf"),
                        params["w_down"])


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens: Python's ``round`` (half to
    even) of ``capacity_factor * tokens * k / E``, at least 1."""
    return int(max(1, round(cfg.moe_capacity_factor * tokens
                            * cfg.experts_per_token / cfg.num_experts)))


def num_groups(cfg: ModelConfig, tokens: int) -> int:
    """Token groups of the sort dispatch: ``moe_groups`` lowered to a
    divisor of the token count."""
    g = max(1, min(cfg.moe_groups, tokens))
    while tokens % g:
        g -= 1
    return g


def sort_dispatch_plan(top_idx: torch.Tensor, cfg: ModelConfig):
    """The sort dispatch's routing from the router's choices ``[T, k]``:
    per group of ``tg`` tokens, ``order`` (the stable sort of the slots
    by expert), ``buf_idx`` (each sorted slot's row in the group's
    ``[E * C]`` buffer; ``E * C`` for a dropped slot) and ``keep``, all
    ``[G, tg * k]``, and the capacity C."""
    t, topk = top_idx.shape
    e = cfg.num_experts
    g = num_groups(cfg, t)
    cap = capacity(cfg, t // g)
    flat_expert = top_idx.reshape(g, (t // g) * topk)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    counts = F.one_hot(flat_expert, e).sum(dim=1)               # [G, E]
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(flat_expert.shape[1], device=top_idx.device) - \
        torch.gather(starts, 1, sorted_expert)
    keep = pos < cap
    buf_idx = torch.where(keep, sorted_expert * cap + pos, e * cap)
    return order, buf_idx, keep, cap


def apply_moe(params: Params, x: torch.Tensor, cfg: ModelConfig,
              dispatch: str = "sort") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (output [B, S, d] in x's dtype, aux loss scalar
    f32)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, topk = cfg.num_experts, cfg.experts_per_token

    probs = router_probs(params, xt)                            # [T, E]
    top_p, top_idx = top_k(probs, topk)                         # [T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)             # renormalise
    onehot = F.one_hot(top_idx, e).to(torch.float32)            # [T, k, E]
    aux = load_balance_loss(probs, onehot.amax(dim=1))

    if dispatch == "sort":
        order, buf_idx, keep, cap = sort_dispatch_plan(top_idx, cfg)
        g, slots = order.shape
        tg = t // g
        sorted_token = torch.div(order, topk, rounding_mode="floor")
        gate_s = torch.gather(top_p.reshape(g, slots), 1, order)
        xg = xt.reshape(g, tg, d)
        gathered = torch.gather(xg, 1, sorted_token[..., None].expand(
            g, slots, d))
        buf = xt.new_zeros((g, e * cap + 1, d))
        # kept rows are unique; every dropped slot lands on the spare row
        buf.scatter_(1, buf_idx[..., None].expand(g, slots, d),
                     torch.where(keep[..., None], gathered, 0.0))
        xe = buf[:, :-1].reshape(g, e, cap, d)
        ye = torch.einsum("gecf,efd->gecd",
                          _expert_act(xe, params, cfg, "gecd,edf->gecf"),
                          params["w_down"])
        out_slots = torch.gather(
            ye.reshape(g, e * cap, d), 1,
            torch.clamp(buf_idx, max=e * cap - 1)[..., None].expand(
                g, slots, d))
        # the gates are f32, so the combine is (the JAX package promotes)
        out_slots = out_slots.to(torch.float32) * (gate_s * keep)[..., None]
        # un-permute the slots to (token, rank) and sum the k ranks in
        # order, first choice first: the same sums on every run
        per_slot = torch.empty_like(out_slots)
        per_slot.scatter_(1, order[..., None].expand(g, slots, d),
                          out_slots)
        per_slot = per_slot.reshape(t, topk, d)
        y = per_slot[:, 0]
        for j in range(1, topk):
            y = y + per_slot[:, j]
        return y.reshape(b, s, d).to(x.dtype), aux

    if dispatch == "dense":
        weights = torch.einsum("tke,tk->te", onehot, top_p)     # [T, E]
        # the tokens broadcast over the experts, so each product is one
        # batched GEMM over E reading the weights where they lie
        xe = xt[None].expand(e, t, d)
        out = torch.einsum("etf,efd->etd",
                           _expert_act(xe, params, cfg, "etd,edf->etf"),
                           params["w_down"])
        y = torch.einsum("etd,te->td", out.to(torch.float32), weights)
        return y.reshape(b, s, d).to(x.dtype), aux

    # capacity (GShard): each expert processes at most C tokens
    cap = capacity(cfg, t)
    flat_onehot = onehot.reshape(t * topk, e)
    pos = ((torch.cumsum(flat_onehot, dim=0) - 1.0) * flat_onehot).sum(-1)
    keep = pos < cap
    cap_onehot = F.one_hot(pos.to(torch.int64).clamp(max=cap - 1), cap).to(
        torch.float32) * keep[:, None]
    disp = (flat_onehot[:, :, None] * cap_onehot[:, None, :]).reshape(
        t, topk, e, cap)
    combine = disp * top_p[:, :, None, None]
    # the f32 dispatch tensor promotes the whole path to f32, as in JAX
    f32 = {k: v.to(torch.float32) for k, v in params.items()}
    xe = torch.einsum("tkec,td->ecd", disp, xt.to(torch.float32))
    ye = _expert_ffn(f32, xe, cfg)
    y = torch.einsum("tkec,ecd->td", combine, ye)
    return y.reshape(b, s, d).to(x.dtype), aux
