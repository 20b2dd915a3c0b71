"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
ported from ``repro.models.rglru``.

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          # input gate
    a_t = a^(c * r_t),  a = sigmoid(lambda_param),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block: ``out = W_out (gelu(x W_y) * RG-LRU(conv(x W_u)))``.

Train and prefill evaluate the linear recurrence with a log-depth scan
(Hillis-Steele doubling over the sequence: ceil(log2 S) steps of
elementwise products and sums) where the JAX package uses
``jax.lax.associative_scan``: both combine (a, b) pairs with
``(a_l a_r, b_l a_r + b_r)``, in other tree orders, so the two agree to
f32 rounding (held within 1e-5 by the tests), not bitwise.  Decode is one
fused step.  Internals are f32 (the gates in the activations' dtype),
outputs in the input's dtype, the final state in f32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]

_C = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor          # [B, width] f32
    conv: torch.Tensor       # [B, conv_width - 1, width]: the pre-conv tail


def init_rglru(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Params:
    d = cfg.d_model
    width = cfg.rglru_width or d
    dev = gen.device
    # lambda so that a = sigmoid(lam)^c lies in (0.9, 0.999)
    u = torch.empty((width,), dtype=torch.float32, device=dev).uniform_(
        0.9, 0.999, generator=gen)
    root = u ** (1.0 / _C)
    lam = torch.log(root / (1.0 - root))
    conv_w = 0.1 * torch.randn((cfg.rglru_conv_width, width),
                               dtype=torch.float32, device=dev,
                               generator=gen)
    zeros = lambda: torch.zeros((width,), dtype=dtype, device=dev)  # noqa
    return {
        "w_y": L.dense_init(gen, d, width, dtype),      # gelu branch
        "w_u": L.dense_init(gen, d, width, dtype),      # recurrent branch
        "conv_w": conv_w.to(dtype),
        "conv_b": zeros(),
        "w_a": L.dense_init(gen, width, width, dtype),
        "b_a": zeros(),
        "w_x": L.dense_init(gen, width, width, dtype),
        "b_x": zeros(),
        "lam": lam.to(dtype),
        "w_out": L.dense_init(gen, width, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over [B, S, W] with the previous ``width - 1``
    inputs ``tail`` (zeros when None); returns (y, the new tail)."""
    width = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(width):                 # the reference's summation order
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    new_tail = xp[:, -(width - 1):, :] if width > 1 else tail
    return y + b, new_tail


def _gates(u: torch.Tensor, params: Params):
    """(a, sqrt(1 - a^2) * i * u) in f32 for inputs u [..., W]."""
    r = torch.sigmoid(u @ params["w_a"] + params["b_a"])
    i = torch.sigmoid(u @ params["w_x"] + params["b_x"])
    log_a0 = F.logsigmoid(params["lam"].to(torch.float32))
    a = torch.exp(_C * r.to(torch.float32) * log_a0)
    gated = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) * \
        (i.to(torch.float32) * u.to(torch.float32))
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1 of [B, S, W], by
    doubling: after the step of offset o each position holds the
    composition of its last 2o inputs."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def rglru_scan(u: torch.Tensor, params: Params,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u [B, S, W] -> (h [B, S, W] in u's dtype, h_last [B, W] f32)."""
    a, gated = _gates(u, params)
    if h0 is not None:
        # fold the initial state into the first step's additive term
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0.to(torch.float32)
                           [:, None], gated[:, 1:]], dim=1)
    h = linear_scan(a, gated)
    return h.to(u.dtype), h[:, -1, :]


def rglru_step(u: torch.Tensor, params: Params, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: u [B, W], h [B, W] -> (h_new in u's dtype, h_new
    f32)."""
    a, gated = _gates(u, params)
    h_new = a * h.to(torch.float32) + gated
    return h_new.to(u.dtype), h_new


def apply_rglru(params: Params, x: torch.Tensor, cfg: ModelConfig,
                cache: Optional[RGLRUCache] = None,
                return_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[RGLRUCache]]:
    """The Griffin recurrent block; decode when ``cache`` is given
    (S == 1).  ``return_cache`` (prefill): also the cache after the last
    position, the scan's final state and the conv's tail, from the one
    scan (the JAX package runs the scan a second time for it; the numbers
    are the same)."""
    y = F.gelu(x @ params["w_y"], approximate="tanh")
    u = x @ params["w_u"]
    tail = cache.conv if cache is not None else None
    u, new_tail = _causal_conv(u, params["conv_w"], params["conv_b"], tail)

    if cache is None:
        hseq, h_last = rglru_scan(u, params)
        out = (y * hseq) @ params["w_out"]
        return out, (RGLRUCache(h=h_last, conv=new_tail) if return_cache
                     else None)

    # the cache keeps the state in u's dtype after a step, as the
    # reference's does
    h_new, _ = rglru_step(u[:, 0, :], params, cache.h)
    out = (y[:, 0, :] * h_new)[:, None, :] @ params["w_out"]
    return out, RGLRUCache(h=h_new, conv=new_tail)


def init_rglru_cache(batch: int, cfg: ModelConfig, dtype=torch.float32,
                     device="cuda") -> RGLRUCache:
    width = cfg.rglru_width or cfg.d_model
    return RGLRUCache(
        h=torch.zeros((batch, width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.rglru_conv_width - 1, width),
                         dtype=dtype, device=device))
