"""Shared LM layers, ported from ``repro.models.layers``: initialisers,
norms, rotary embeddings, gated MLPs, soft-capping and the token NLL.

Plain functions on tensors over explicit parameter dicts, in the JAX
package's layouts (dense weights ``[in, out]``, activations
``[B, S, ...]``).  The models rotate through tables computed once per
step (:func:`rope_tables`, :func:`mrope_tables`) and
:func:`apply_rotary`, as the JAX package's attention does;
:func:`apply_rope` and :func:`apply_mrope` are the one-call forms of its
public API.  Whisper's encoder adds :func:`sinusoidal_positions`.
Initialisers draw from an explicit ``torch.Generator`` in float32 and
cast to the parameter dtype; they do not reproduce the JAX package's
threefry draws (the parity tests convert the reference's parameters
with ``repro_torch.convert.lm_params_from_jax``).

Left out: the mesh's sharding constraints (a JAX placement hint).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# Initialisers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype=torch.float32, scale: Optional[float] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Truncated-normal (±2 std) fan-in init ``[in_dim, out_dim]``, drawn
    in f32 on the generator's device.  ``out`` (a preallocated
    ``[in_dim, out_dim]`` tensor, e.g. one layer's slice of a stacked
    weight) receives the cast values in place of a new tensor."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.mul_(std)
    if out is None:
        return w.to(dtype)
    out.copy_(w)
    return out


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, dim), dtype=torch.float32, device=gen.device,
                    generator=gen)
    return w.div_(math.sqrt(dim)).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = True) -> torch.Tensor:
    """RMSNorm in f32 with the (1 + w) parameterisation (gemma); the
    ``1 + w`` is formed in w's dtype, as the reference does."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + weight) if plus_one else weight
    return (x * w.to(torch.float32)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


def apply_norm(x: torch.Tensor, params: Params, kind: str,
               eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


def init_norm(dim: int, kind: str, dtype=torch.float32,
              device="cuda") -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# Rotary embeddings (split-half RoPE)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device="cuda") -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                      # [head_dim/2]


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, S, D/2]`` for integer positions ``[B, S]``:
    layer-invariant, computed once per step."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def mrope_tables(positions_thw: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL's M-RoPE (cos, sin) ``[B, S, D/2]`` from ``[3, B, S]``
    (temporal, height, width) position ids: rotary pair i takes the id
    stream of the section it falls in (``sections`` split the D/2 pairs
    t, h, w)."""
    d_half = head_dim // 2
    if sum(sections) != d_half:
        raise ValueError(f"mrope sections {sections} do not sum to "
                         f"head_dim / 2 = {d_half}")
    dev = positions_thw.device
    freqs = rope_frequencies(head_dim, theta, dev)
    pair = torch.arange(d_half, device=dev)
    section_id = torch.zeros((d_half,), dtype=torch.int64, device=dev)
    acc = 0
    for s in sections[:-1]:
        acc += s
        section_id += (pair >= acc).to(torch.int64)
    pos = positions_thw[section_id]                        # [D/2, B, S]
    angles = torch.movedim(pos, 0, -1).to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: ``[B, S, H, D]``; cos/sin: ``[B, S, D/2]``; in f32, returned in
    x's dtype."""
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[B, S, H, D]``; positions: ``[B, S]`` (int).  Split-half RoPE
    in f32, returned in x's dtype."""
    return apply_rotary(x, *rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE.  x: ``[B, S, H, D]``; positions_thw:
    ``[3, B, S]`` temporal / height / width ids; ``sections`` split the
    D/2 rotary pairs (t, h, w), each rotated by its own id stream (text
    tokens carry t = h = w, which is plain RoPE).  In f32, returned in
    x's dtype."""
    return apply_rotary(x, *mrope_tables(positions_thw, x.shape[-1], theta,
                                         sections))


def sinusoidal_positions(seq_len: int, dim: int,
                         device="cuda") -> torch.Tensor:
    """Whisper's fixed sinusoidal position embeddings ``[S, D]`` (f32):
    sin then cos of ``pos * exp(-ln(1e4) i / max(D/2 - 1, 1))``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * idx / max(dim // 2 - 1, 1))
    angles = pos * inv
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# --------------------------------------------------------------------------
# MLPs, soft-cap, loss
# --------------------------------------------------------------------------

def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool,
             dtype=torch.float32) -> Params:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def apply_mlp(params: Params, x: torch.Tensor, activation: str,
              gated: bool) -> torch.Tensor:
    up = x @ params["w_up"]
    if gated:
        up = _act(x @ params["w_gate"], activation) * up
    else:
        up = _act(up, activation)
    return up @ params["w_down"]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy ``logsumexp(logits) - logits[label]`` in
    f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold
