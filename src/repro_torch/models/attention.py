"""Grouped-query attention with causal / sliding-window masking, logit
soft-capping (gemma2), RoPE and M-RoPE (qwen2-vl), KV caches for decode
(int8 with per-(token, head) scales when ``quantized_kv``) and
cross-attention (whisper), ported from ``repro.models.attention``.

The plain path (:func:`attend`) is PyTorch; with ``attn_impl='flash'``
(or ``'auto'`` above 2^21 score entries) train, prefill and
cross-attention go through :func:`repro_torch.models.flash.flash_attention`,
which launches the hand-written flash kernel on the card (cross-attention
at every query length, one decode token included, as the JAX package
does), and decode on a global cache through
:func:`~repro_torch.models.flash.flash_decode`.  Decode updates the caches
in place (the JAX package returns new arrays; here the same tensors are
written and returned, which saves copying the caches every token).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import (FlashConfig, flash_attention,
                                      flash_decode)

Params = Dict[str, torch.Tensor]

NEG_INF = -2.0e38


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": L.dense_init(gen, d, nq * hd, dtype),
        "wk": L.dense_init(gen, d, nkv * hd, dtype),
        "wv": L.dense_init(gen, d, nkv * hd, dtype),
        "wo": L.dense_init(gen, nq * hd, d, dtype),
    }


def init_kv_cache(batch: int, seq_len: int, cfg: ModelConfig,
                  dtype=torch.float32, quantized: bool = False,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zero K/V caches ``[B, S, Hkv, D]``; ``quantized``: int8 values and
    f32 scales ``[B, S, Hkv]`` (symmetric per (token, head))."""
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    if quantized:
        sshape = shape[:-1]
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, D] -> (int8 values, f32 scales [B, S, H]): the scale
    is ``max(amax, 1e-8) / 127`` and the codes ``round(x / scale)``
    (half to even, as ``jnp.round``) clipped to +-127."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, num_heads, -1)


def gqa_scores(q: torch.Tensor, k: torch.Tensor,
               scale: float) -> torch.Tensor:
    """q: [B, Sq, nq, D], k: [B, Sk, nkv, D] -> f32 logits
    [B, nq, Sq, Sk]."""
    b, sq, nq, d = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, d)
    logits = torch.einsum("bsngd,btnd->bngst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    return logits.reshape(b, nq, sq, k.shape[1])


def gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B, nq, Sq, Sk], v: [B, Sk, nkv, D] -> [B, Sq, nq, D]."""
    b, nq, sq, sk = probs.shape
    nkv = v.shape[2]
    pg = probs.reshape(b, nkv, nq // nkv, sq, sk)
    out = torch.einsum("bngst,btnd->bsngd", pg, v.to(torch.float32))
    return out.reshape(b, sq, nq, v.shape[3])


def make_mask(sq: int, sk: int, *, causal: bool, window: int,
              q_offset: int = 0, kv_valid_len: Optional[int] = None,
              device="cuda") -> torch.Tensor:
    """Boolean [Sq, Sk] mask, True = attendable.  ``q_offset`` shifts the
    query positions (decode: the cache position); ``window`` <= 0
    disables the sliding window."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_valid_len is not None:
        mask &= kpos < kv_valid_len
    return mask


def make_rope_tables(cfg: ModelConfig, positions: Optional[torch.Tensor],
                     positions_thw: Optional[torch.Tensor] = None):
    """(cos, sin) [B, S, D/2] for this step (layer-invariant), or None
    when the model has no rotary embedding.  M-RoPE reads the
    ``[3, B, S]`` ids ``positions_thw``, RoPE the ``[B, S]``
    ``positions``."""
    if cfg.rope_type == "mrope":
        assert positions_thw is not None
        return L.mrope_tables(positions_thw, cfg.resolved_head_dim,
                              cfg.rope_theta, cfg.mrope_sections)
    if cfg.rope_type == "rope":
        assert positions is not None
        return L.rope_tables(positions, cfg.resolved_head_dim,
                             cfg.rope_theta)
    return None


_FLASH_THRESHOLD = 1 << 21     # Sq*Sk above which "auto" picks the flash path


def _use_flash(cfg: ModelConfig, sq: int, sk: int) -> bool:
    if cfg.attn_impl == "flash":
        return True
    if cfg.attn_impl == "naive":
        return False
    return sq * sk > _FLASH_THRESHOLD


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], scale: float,
           softcap: float = 0.0) -> torch.Tensor:
    logits = gqa_scores(q, k, scale)
    if softcap > 0.0:
        logits = L.softcap(logits, softcap)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return gqa_combine(probs, v).to(q.dtype)


def _flash(q, k, v, cfg: ModelConfig, *, causal: bool, window: int,
           scale: float) -> torch.Tensor:
    sq, sk = q.shape[1], k.shape[1]
    fcfg = FlashConfig(
        block_q=min(cfg.flash_block_q, max(sq, 16)),
        block_kv=min(cfg.flash_block_kv, max(sk, 16)),
        causal=causal, window=window, softcap=cfg.attn_logit_softcap,
        scale=scale)
    return flash_attention(q, k, v, fcfg)


def attention(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
              kind: str = "global",
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              positions: Optional[torch.Tensor] = None,
              positions_thw: Optional[torch.Tensor] = None,
              kv_cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_index: Optional[int] = None,
              kv_source: Optional[torch.Tensor] = None,
              causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The attention block body: projections, rope, attention, out-proj.

    * train/prefill (``kv_cache is None``): self-attention over x
      (``causal=False``: bidirectional, Whisper's encoder); returns
      ``(out, {"k": k, "v": v})`` with this layer's rotated keys and
      values, from which prefill builds its cache (the JAX package
      computes them a second time; the numbers are the same);
    * decode (``kv_cache`` given, one token): writes k/v at
      ``cache_index`` in place (int8 codes and scales into a quantized
      cache) and attends over the cache.  "local" blocks keep a ring
      buffer of ``window`` slots written at ``cache_index % ring_len``;
    * cross-attention (``kv_source`` given, the encoder states): keys and
      values from ``kv_source``, no rope, no mask; returns ``(out,
      None)``.
    """
    hd = cfg.resolved_head_dim
    scale = cfg.query_scale if cfg.query_scale else hd ** -0.5
    window = cfg.window_size if kind == "local" else 0
    softcap = cfg.attn_logit_softcap

    src = kv_source if kv_source is not None else x
    q = _split_heads(x @ params["wq"], cfg.num_heads)
    k = _split_heads(src @ params["wk"], cfg.num_kv_heads)
    v = _split_heads(src @ params["wv"], cfg.num_kv_heads)
    b, s = q.shape[:2]

    if kv_source is not None:
        sk = k.shape[1]
        if _use_flash(cfg, s, sk):
            out = _flash(q, k, v, cfg, causal=False, window=0, scale=scale)
        else:
            out = attend(q, k, v, None, scale, softcap)
        return out.reshape(b, s, -1) @ params["wo"], None

    if cfg.rope_type != "none":
        if rope is None:
            rope = make_rope_tables(cfg, positions, positions_thw)
        q = L.apply_rotary(q, *rope)
        k = L.apply_rotary(k, *rope)

    if kv_cache is None:
        if _use_flash(cfg, s, s):
            out = _flash(q, k, v, cfg, causal=causal, window=window,
                         scale=scale)
        else:
            mask = make_mask(s, s, causal=causal, window=window,
                             device=x.device)
            out = attend(q, k, v, mask, scale, softcap)
        return out.reshape(b, s, -1) @ params["wo"], {"k": k, "v": v}

    assert cache_index is not None and s == 1
    ck, cv = kv_cache["k"], kv_cache["v"]
    ring_len = ck.shape[1]
    if kind == "local" and ring_len <= cfg.window_size:
        # ring buffer: the cache holds exactly the last `ring_len`
        # positions; keys carry their rope, so order is irrelevant
        write = cache_index % ring_len
        ck[:, write] = k[:, 0].to(ck.dtype)
        cv[:, write] = v[:, 0].to(cv.dtype)
        valid = torch.arange(ring_len, device=x.device) < min(
            cache_index + 1, ring_len)
        out = attend(q, ck, cv, valid[None], scale, softcap)
        return out.reshape(b, s, -1) @ params["wo"], kv_cache
    scales = {}
    if "k_scale" in kv_cache:                      # int8 quantized cache
        for name, t in (("k", k), ("v", v)):
            codes, sc = quantize_kv(t)
            kv_cache[name][:, cache_index] = codes[:, 0]
            kv_cache[f"{name}_scale"][:, cache_index] = sc[:, 0]
        scales = dict(k_scale=kv_cache["k_scale"],
                      v_scale=kv_cache["v_scale"])
    else:
        ck[:, cache_index] = k[:, 0].to(ck.dtype)
        cv[:, cache_index] = v[:, 0].to(cv.dtype)
    if _use_flash(cfg, 1, ring_len):
        out = flash_decode(q, ck, cv, scale=scale, cache_index=cache_index,
                           window=window, softcap=softcap,
                           block_kv=cfg.flash_block_kv, **scales)
    else:
        if scales:
            ck = dequantize_kv(ck, scales["k_scale"])
            cv = dequantize_kv(cv, scales["v_scale"])
        mask = make_mask(1, ring_len, causal=causal, window=window,
                         q_offset=cache_index, kv_valid_len=cache_index + 1,
                         device=x.device)
        out = attend(q, ck, cv, mask, scale, softcap)
    return out.reshape(b, s, -1) @ params["wo"], kv_cache
