"""Flash attention in the model's ``[B, S, H, D]`` layout, ported from
``repro.models.flash``.

* :func:`flash_attention` — the forward for train and prefill.  On a
  CUDA device it launches the hand-written flash kernel
  (``kernels/csrc/flash_attention.cu``) once, on ``transpose(1, 2)``
  views of q, k and v (the kernel reads their strides, so nothing is
  copied) and returns ``[B, S, H, D]``; on the CPU it runs the kernel's
  plain version (``kernels.ref.mha_reference``).  The JAX package's
  blockwise jnp scan is the XLA lowering of the same function; its block
  sizes (``FlashConfig.block_q``/``block_kv``) were chosen for the TPU
  and the CUDA kernel picks its own tiles.  No backward yet: the training
  slice ports it.
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

from repro_torch.kernels import ops

NEG_INF = -2.0e38


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: FlashConfig) -> torch.Tensor:
    """``softmax(mask(cap(q k^T * scale))) v``; q ``[B, Sq, nq, D]``, k/v
    ``[B, Sk, nkv, D]`` -> ``[B, Sq, nq, D]`` in q's dtype."""
    if cfg.q_offset != 0 or cfg.kv_valid_len >= 0:
        raise ValueError("the flash kernel takes no q_offset or "
                         "kv_valid_len (prefill never sets them)")
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal, window=cfg.window, softcap=cfg.softcap,
        scale=cfg.scale)
    return out.transpose(1, 2)


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
    for start in range(0, sk, block_kv):
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
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)
