"""Mamba-2 (SSD, state-space duality) block, arXiv:2405.21060, ported
from ``repro.models.ssm``.

The chunked SSD algorithm: within a chunk the recurrence is a
decay-masked, attention-like product, which on the card is the
hand-written SSD-chunk kernel (``kernels/csrc/ssd_chunk.cu``, one launch
per layer and prefill or train forward, through ``kernels.ops.ssd_chunk``;
its plain version on the CPU); across chunks a small ``[nh, hd, N]``
state recurrence runs as a PyTorch loop over the chunks.  Single-token
decode updates the state in O(d * N).

In training the intra-chunk part is the ``torch.autograd.Function``
:class:`SSDChunk`: the kernel's forward, and a backward that recomputes
the plain version (``kernels.ref.ssd_chunk_batched_reference``) from the
saved inputs and differentiates it with ``torch.autograd``, which is what
``jax.grad`` does through the JAX package's jnp ``ssd_chunked`` (its
training path reaches no Pallas kernel either).  A CUDA backward of the
chunk is later kernel work.

Structure per block (single-group Mamba-2):
  in_proj -> (z, x, B, C, dt); causal depthwise conv on (x|B|C);
  SSD(x, dt, A, B, C); gated RMSNorm with silu(z); out_proj.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


class SSMCache(NamedTuple):
    """Decode-time cache: recurrent state + conv tail."""
    state: torch.Tensor       # [B, nh, hd, N] f32
    conv: torch.Tensor        # [B, conv_width - 1, conv_channels]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    nh, hd, st = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state_dim
    assert nh * hd == inner, (nh, hd, inner)
    conv_ch = inner + 2 * st
    return inner, nh, hd, st, conv_ch


def init_ssd(gen: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> Params:
    d = cfg.d_model
    inner, nh, hd, st, conv_ch = _dims(cfg)
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv_width, conv_ch), dtype=torch.float32,
                         device=dev, generator=gen)
    return {
        # order: z | x | B | C | dt
        "in_proj": L.dense_init(gen, d, 2 * inner + 2 * st + nh, dtype),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh,
                                          device=dev)).to(dtype),
        "d_skip": torch.ones((nh,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.linspace(
            1e-3, 1e-1, nh, device=dev))).to(dtype),
        "norm": torch.zeros((inner,), dtype=dtype, device=dev),
        "out_proj": L.dense_init(gen, inner, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time.  x: [B, S, C]; w: [W, C].
    Returns (silu(conv + b), the last W - 1 inputs for decode)."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    new_tail = xp[:, -(width - 1):, :] if width > 1 else tail
    return F.silu(y + b), new_tail


class SSDChunk(torch.autograd.Function):
    """``ops.ssd_chunk`` with a backward: (y_diag, states) of f32 x, dt,
    a_log, b_in, c_in; the backward differentiates the plain version,
    recomputed from the saved inputs (memory of one layer's chunk
    products at a time)."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_in, c_in, chunk: int):
        ctx.save_for_backward(x, dt, a_log, b_in, c_in)
        ctx.chunk = chunk
        return ops.ssd_chunk(x, dt, a_log, b_in, c_in, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstates):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, states = ref.ssd_chunk_batched_reference(*ins, ctx.chunk)
        grads = torch.autograd.grad((y, states), ins, (dy, dstates))
        return (*grads, None)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: [B, S, nh, hd], dt: [B, S, nh] (post-softplus), b_in/c_in:
    [B, S, N].  Returns (y [B, S, nh, hd] in x's dtype, final_state
    [B, nh, hd, N] f32).  The intra-chunk part (y_diag and the chunk
    states) is one ``ops.ssd_chunk`` call on the f32-cast inputs, through
    :class:`SSDChunk` where an input requires grad under grad mode.
    """
    bsz, s_orig, nh, hd = x.shape
    n = b_in.shape[-1]
    f32 = torch.float32
    # pad the tail to a chunk multiple: dt == 0 on padding makes the padded
    # steps exact no-ops (decay 1, zero input)
    pad = (-s_orig) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // chunk

    ins = [t.to(f32).contiguous() for t in (x, dt, a_log, b_in, c_in)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        y_diag, s_chunk = SSDChunk.apply(*ins, chunk)
    else:
        y_diag, s_chunk = ops.ssd_chunk(*ins, chunk=chunk)

    a = -torch.exp(a_log.to(f32))                            # [nh]
    dac = (dt.to(f32) * a).reshape(bsz, nc, chunk, nh)
    cum = torch.cumsum(dac, dim=2)                           # [B,nc,L,nh]
    cc = c_in.reshape(bsz, nc, chunk, n).to(f32)

    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(cum[:, :, -1, :])                # [B,nc,nh]
    h = (torch.zeros((bsz, nh, hd, n), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    h_before = []
    for c in range(nc):
        h_before.append(h)                                   # state BEFORE c
        h = chunk_decay[:, c, :, None, None] * h + s_chunk[:, c]
    h_before = torch.stack(h_before, dim=1)                  # [B,nc,nh,hd,N]

    # off-diagonal contribution: y_off[i] = C_i . (exp(cum_i) * H_prev)
    in_decay = torch.exp(cum)                                # [B,nc,L,nh]
    y_off = torch.einsum("bcln,bchdn->bclhd", cc, h_before) \
        * in_decay[..., None]
    y = (y_diag.reshape(bsz, nc, chunk, nh, hd) + y_off)
    y = y.reshape(bsz, s, nh, hd)[:, :s_orig]
    return y.to(x.dtype), h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b_in: torch.Tensor, c_in: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.  x: [B, nh, hd], dt: [B, nh], b/c: [B, N]."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    decay = torch.exp(dt.to(f32) * a)                        # [B, nh]
    add = (dt[..., None].to(f32) * x.to(f32))[..., None] \
        * b_in[:, None, None, :].to(f32)
    new_state = decay[:, :, None, None] * state + add        # [B,nh,hd,N]
    y = torch.einsum("bhdn,bn->bhd", new_state, c_in.to(f32))
    return y.to(x.dtype), new_state


def apply_ssd(params: Params, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[SSMCache] = None, return_cache: bool = False
              ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """The full Mamba-2 block.  Train/prefill when ``cache`` is None (with
    ``return_cache`` the prefill's final state and conv tail come back as
    an :class:`SSMCache`, from the same single SSD pass); decode (S == 1)
    otherwise."""
    bsz, s, d = x.shape
    inner, nh, hd, st, conv_ch = _dims(cfg)
    proj = x @ params["in_proj"]
    z, xin, b_in, c_in, dt = torch.split(proj, [inner, inner, st, st, nh],
                                         dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                  # [B,S,nh]

    conv_in = torch.cat([xin, b_in, c_in], dim=-1)
    tail = cache.conv if cache is not None else None
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"],
                                      params["conv_b"], tail)
    xin, b_in, c_in = torch.split(conv_out, [inner, st, st], dim=-1)

    if cache is None:
        xh = xin.reshape(bsz, s, nh, hd)
        y, final_state = ssd_chunked(xh, dt, params["a_log"], b_in, c_in,
                                     min(cfg.ssm_chunk, s))
        new_cache = (SSMCache(state=final_state, conv=new_tail)
                     if return_cache else None)
    else:
        xh = xin.reshape(bsz, nh, hd)
        y, new_state = ssd_decode_step(xh, dt[:, 0], params["a_log"],
                                       b_in[:, 0], c_in[:, 0], cache.state)
        y = y[:, None]                                       # [B,1,nh,hd]
        xh = xh[:, None]
        new_cache = SSMCache(state=new_state, conv=new_tail)

    y = y + params["d_skip"][None, None, :, None] * xh
    y = y.reshape(bsz, s, inner)
    y = L.rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], new_cache


def init_ssm_cache(batch: int, cfg: ModelConfig, dtype=torch.float32,
                   device="cuda") -> SSMCache:
    inner, nh, hd, st, conv_ch = _dims(cfg)
    return SSMCache(
        state=torch.zeros((batch, nh, hd, st), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                         dtype=dtype, device=device))
