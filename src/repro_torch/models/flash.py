"""Flash attention in the model's ``[B, S, H, D]`` layout, ported from
``repro.models.flash``.

* :func:`flash_attention` — train and prefill.  On a CUDA device the
  forward launches the hand-written flash kernel
  (``kernels/csrc/flash_attention.cu``) once, on ``transpose(1, 2)``
  views of q, k and v (the kernel reads their strides, so nothing is
  copied) and returns ``[B, S, H, D]``; on the CPU it runs the kernel's
  plain version (``kernels.ref.mha_reference``).  Where q, k or v
  require grad under grad mode it is the ``torch.autograd.Function``
  :class:`FlashAttention`, the counterpart of the JAX package's
  ``custom_vjp``: its forward also asks the kernel for each row's
  log-sum-exp, and its backward is :func:`flash_backward`, a plain
  PyTorch port of the JAX package's ``_backward`` (blockwise over
  ``FlashConfig.block_q`` / ``block_kv``, P recomputed from the saved
  lse, f32 accumulation).  The JAX package differentiates its jnp
  ``_forward`` / ``_backward`` and never the Pallas kernel, so it has no
  backward kernel to port; a CUDA backward is later kernel work.  Without
  grad (serving) the kernel runs without the lse output.
* :func:`flash_decode` — one query token against a long KV cache, the
  blockwise online softmax of the JAX version in plain PyTorch (it is a
  jnp scan outside any Pallas kernel there, so it has no kernel here).
  An int8 cache passes its per-(token, head) scales and each block is
  dequantized before its scores, as the JAX version does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.profiler

from repro_torch.kernels import ops
from repro_torch.launch import op_cost

NEG_INF = -2.0e38
#: the ``torch.profiler`` range around :class:`FlashAttention`'s backward
BACKWARD_RANGE = "flash_attention.backward"


@dataclasses.dataclass(frozen=True)
class FlashConfig:
    block_q: int = 512
    block_kv: int = 512
    causal: bool = True
    window: int = 0              # 0 => unbounded
    softcap: float = 0.0
    scale: float = 1.0
    q_offset: int = 0            # decode: query position offset
    kv_valid_len: int = -1       # decode: valid cache length (-1 => all)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             cfg: FlashConfig, return_lse: bool):
    """The kernel (the plain version on the CPU) in the model's layout:
    out ``[B, Sq, nq, D]`` and, with ``return_lse``, lse f32
    ``[B, nq, Sq]``."""
    if cfg.q_offset != 0 or cfg.kv_valid_len >= 0:
        raise ValueError("the flash kernel takes no q_offset or "
                         "kv_valid_len (train and prefill never set them)")
    res = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=cfg.window, softcap=cfg.softcap,
        scale=cfg.scale, return_lse=return_lse)
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """``out = softmax(mask(cap(q k^T * scale))) v`` with a blockwise
    backward: the forward saves (q, k, v, out, lse), as the JAX package's
    ``_fa_fwd`` does, and the backward is :func:`flash_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: FlashConfig):
        out, lse = _forward(q, k, v, cfg, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # a profiler range, so a trace can attribute the plain backward's
        # device time (chip_smoke.py's train.gemma2b reads it)
        with torch.profiler.record_function(BACKWARD_RANGE):
            grads = flash_backward(q, k, v, out, lse, dout, ctx.cfg)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: FlashConfig) -> torch.Tensor:
    """``softmax(mask(cap(q k^T * scale))) v``; q ``[B, Sq, nq, D]``, k/v
    ``[B, Sk, nkv, D]`` -> ``[B, Sq, nq, D]`` in q's dtype;
    differentiable (:class:`FlashAttention`) where an input requires
    grad under grad mode."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, cfg)
    return _forward(q, k, v, cfg, return_lse=False)


def _block_visible(q0: int, q1: int, k0: int, k1: int,
                   cfg: FlashConfig) -> bool:
    """Whether the mask lets any (query, key) pair of rows q0..q1-1 and
    keys k0..k1-1 through; a block it empties contributes exactly 0 in
    the JAX package's ``_backward`` (P = exp(NEG_INF - lse)), so it is
    skipped."""
    if cfg.causal and k0 > q1 - 1:
        return False
    return not (cfg.window > 0 and k1 - 1 <= q0 - cfg.window)


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   cfg: FlashConfig):
    """(dq, dk, dv) of :func:`flash_attention`, the FlashAttention-2
    recipe of the JAX package's ``_backward``
    (``src/repro/models/flash.py:159-239``) in plain PyTorch.

    For each kv block of ``cfg.block_kv`` keys and each query block of
    ``cfg.block_q`` rows (the last of each ragged, so nothing is padded):
    P = exp(cap(q k^T scale) - lse) under the mask, dP = dout v^T,
    dS = P (dP - rowsum(out * dout)), times the soft-cap's derivative
    ``1 - tanh^2`` and the scale, then dv += P^T dout, dk += dS^T q,
    dq += dS k, with GQA's query heads summed into their kv head.
    Everything is f32 and only one block's [B, nq, bq, bkv] scores exist
    at a time: memory O(block^2), never O(S^2).  Blocks the causal or
    window mask empties are skipped (they add exactly 0).  dq, dk and dv
    come back in q's, k's and v's dtypes."""
    f32 = torch.float32
    b, sq, nq, d = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    bq, bkv = cfg.block_q, cfg.block_kv
    delta = (out.to(f32) * dout.to(f32)).sum(dim=-1)          # [B, Sq, nq]
    dq = torch.zeros((b, sq, nq, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, sk, nkv, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, sk, nkv, d), dtype=f32, device=q.device)
    pos = torch.arange(max(sq, sk), device=q.device)
    call = (tuple(q.shape), tuple(k.shape), q.dtype, k.dtype, dout.dtype,
            cfg)
    for k0 in range(0, sk, bkv):
        k1 = min(k0 + bkv, sk)
        kb, vb = k[:, k0:k1].to(f32), v[:, k0:k1].to(f32)
        for q0 in range(0, sq, bq):
            q1 = min(q0 + bq, sq)
            if not _block_visible(q0, q1, k0, k1, cfg):
                continue
            with op_cost.trip(call + (q1 - q0, k1 - k0), q.device) as done:
                if not done:
                    _backward_block(q, k0, k1, q0, q1, kb, vb, pos, lse,
                                    delta, dout, dq, dk, dv, cfg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _backward_block(q, k0, k1, q0, q1, kb, vb, pos, lse, delta, dout, dq,
                    dk, dv, cfg: FlashConfig) -> None:
    """One (query block, kv block) of :func:`flash_backward`: adds its
    terms to dq, dk and dv."""
    f32 = torch.float32
    b, _, nq, d = q.shape
    nkv = kb.shape[2]
    group = nq // nkv
    qpos, kpos = pos[q0:q1, None], pos[None, k0:k1]
    mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                      device=q.device)
    if cfg.causal:
        mask &= kpos <= qpos
    if cfg.window > 0:
        mask &= kpos > qpos - cfg.window
    qg = q[:, q0:q1].to(f32).reshape(b, q1 - q0, nkv, group, d)
    dog = dout[:, q0:q1].to(f32).reshape(b, q1 - q0, nkv, group, d)
    raw = torch.einsum("bsngd,btnd->bngst", qg, kb) * cfg.scale
    capped = (cfg.softcap * torch.tanh(raw / cfg.softcap)
              if cfg.softcap > 0 else raw)
    capped = torch.where(mask, capped, NEG_INF)
    lse_b = lse[:, :, q0:q1].reshape(b, nkv, group, q1 - q0)
    p = torch.exp(capped - lse_b[..., None])         # [B,n,g,bq,bkv]
    dp = torch.einsum("bsngd,btnd->bngst", dog, vb)
    delta_b = delta[:, q0:q1].permute(0, 2, 1).reshape(
        b, nkv, group, q1 - q0)
    ds = p * (dp - delta_b[..., None])
    if cfg.softcap > 0:
        ds = ds * (1.0 - torch.square(capped / cfg.softcap))
    ds = torch.where(mask, ds, 0.0) * cfg.scale
    dv[:, k0:k1] += torch.einsum("bngst,bsngd->btnd", p, dog)
    dk[:, k0:k1] += torch.einsum("bngst,bsngd->btnd", ds, qg)
    dq[:, q0:q1] += torch.einsum("bngst,btnd->bsngd", ds, kb
                                 ).reshape(b, q1 - q0, nq, d)


def _scores(q: torch.Tensor, kb: torch.Tensor, scale: float) -> torch.Tensor:
    """q: [B, 1, nq, D], kb: [B, bkv, nkv, D] -> f32 logits
    [B, nq, 1, bkv]."""
    b, sq, nq, d = q.shape
    nkv = kb.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, d).to(torch.float32)
    s = torch.einsum("bsngd,btnd->bngst", qg, kb.to(torch.float32)) * scale
    return s.reshape(b, nq, sq, kb.shape[1])


def _pv(p: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """p: [B, nq, 1, bkv], vb: [B, bkv, nkv, D] -> [B, 1, nq, D]."""
    b, nq, sq, bkv = p.shape
    nkv = vb.shape[2]
    pg = p.reshape(b, nkv, nq // nkv, sq, bkv)
    out = torch.einsum("bngst,btnd->bsngd", pg, vb.to(torch.float32))
    return out.reshape(b, sq, nq, vb.shape[3])


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, *, scale: float, cache_index: int,
                 window: int = 0, softcap: float = 0.0,
                 block_kv: int = 512,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token decode against a cache, scanning KV blocks.

    q: [B, 1, nq, D]; caches [B, S, nkv, D]; positions after
    ``cache_index`` (and outside the window) carry zero mass.  int8
    caches: pass the f32 scales ``[B, S, nkv]`` of each (token, head).
    """
    b, _, nq, d = q.shape
    sk = k_cache.shape[1]
    kpos_all = torch.arange(sk, device=q.device)
    m = torch.full((b, nq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, nq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, 1, nq, d), dtype=torch.float32, device=q.device)
    call = (tuple(q.shape), tuple(k_cache.shape), q.dtype, k_cache.dtype,
            k_scale is not None, window, softcap)
    for start in range(0, sk, block_kv):
        with op_cost.trip(call + (min(block_kv, sk - start),),
                          q.device) as done:
            if not done:
                m, l, acc = _decode_block(q, k_cache, v_cache, k_scale,
                                          v_scale, kpos_all, start,
                                          block_kv, scale, cache_index,
                                          window, softcap, m, l, acc)
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _decode_block(q, k_cache, v_cache, k_scale, v_scale, kpos_all, start,
                  block_kv, scale, cache_index, window, softcap, m, l, acc):
    """One cache block of :func:`flash_decode`'s online softmax: the
    updated (m, l, acc)."""
    kb = k_cache[:, start:start + block_kv]
    vb = v_cache[:, start:start + block_kv]
    if k_scale is not None:
        kb = kb.to(torch.float32) * \
            k_scale[:, start:start + block_kv, :, None]
        vb = vb.to(torch.float32) * \
            v_scale[:, start:start + block_kv, :, None]
    kpos = kpos_all[start:start + block_kv]
    logits = _scores(q, kb, scale)                    # [B, nq, 1, bkv]
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = kpos <= cache_index
    if window > 0:
        mask &= kpos > cache_index - window
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(logits - m_new[..., None])
    l = alpha * l + p.sum(dim=-1)
    acc = acc * alpha.transpose(1, 2)[..., None] + _pv(p, vb)
    return m_new, l, acc
