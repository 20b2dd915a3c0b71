"""Whisper's encoder-decoder backbone (arXiv:2212.04356), ported from
``repro.models.encdec``.

The mel-spectrogram and conv front end are a stub, as in the JAX package:
the model takes frame embeddings ``[B, T_enc, d]``.  The encoder is
bidirectional self-attention over them plus fixed sinusoidal positions;
the decoder is causal self-attention with learned positions (``dec_pos``)
and a KV cache, then cross-attention over the encoder states in every
layer.  Whisper's MHA, LayerNorm and plain GELU MLPs come from the config
(``norm="layernorm"``, ``gated_mlp=False``, ``rope_type="none"``).

Parameters keep the JAX package's tree: ``embed`` [V, d], ``dec_pos``,
``enc_layers`` / ``dec_layers`` (every leaf stacked over
``encoder_layers`` / ``num_layers``), ``enc_final_norm`` and
``final_norm``.  The layers run as a Python loop over ``[l]`` views, the
decoder's self-attention caches are stacked ``{"k", "v": [L, B, S, Hkv,
D]}`` and decode writes them in place.  With ``attn_impl='flash'`` every
attention launches the flash kernel on the card: the encoder's
(non-causal), the decoder's causal self-attention in train and prefill,
and the cross-attention at every query length, so a decode step launches
it once per decoder layer (the JAX package recomputes the cross K/V from
the encoder states every step too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (layer_slice, torch_dtype,
                                            tree_map, tree_map_pair)

PyTree = Any


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    dev = gen.device
    return {
        "attn_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "attn": attn.init_attention(gen, cfg, dtype),
        "mlp_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype),
    }


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig, dtype) -> PyTree:
    dev = gen.device
    return {
        "self_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "self_attn": attn.init_attention(gen, cfg, dtype),
        "cross_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "cross_attn": attn.init_attention(gen, cfg, dtype),
        "mlp_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype),
    }


def _stacked(n: int, make: Callable[[], PyTree]) -> PyTree:
    """``n`` layers from ``make``, every leaf stacked on a leading axis,
    built one layer at a time."""
    out = None
    for i in range(n):
        one = make()
        if out is None:
            out = tree_map(lambda t: t.new_empty((n,) + t.shape), one)
        tree_map_pair(lambda dst, src, i=i: dst[i].copy_(src), out, one)
    return out


@dataclasses.dataclass(frozen=True)
class EncoderDecoderLM:
    """Whisper's backbone over explicit parameter trees (see the module
    docstring); ``device`` is where :meth:`init` and :meth:`init_cache`
    place their tensors."""
    cfg: ModelConfig
    device: Any = "cuda"

    # -- params ------------------------------------------------------------

    @property
    def dec_positions(self) -> int:
        """Rows of the learned decoder positions (at most 2^16)."""
        return min(self.cfg.max_position, 1 << 16)

    def init(self, gen: torch.Generator) -> PyTree:
        cfg = self.cfg
        if torch.device(gen.device) != torch.device(self.device):
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        dtype = torch_dtype(cfg.param_dtype)
        dev = self.device
        dec_pos = 0.01 * torch.randn((self.dec_positions, cfg.d_model),
                                     dtype=torch.float32, device=dev,
                                     generator=gen)
        return {
            "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
            "dec_pos": dec_pos.to(dtype),
            "enc_layers": _stacked(cfg.encoder_layers,
                                   lambda: _init_enc_layer(gen, cfg, dtype)),
            "dec_layers": _stacked(cfg.num_layers,
                                   lambda: _init_dec_layer(gen, cfg, dtype)),
            "enc_final_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
            "final_norm": L.init_norm(cfg.d_model, cfg.norm, dtype, dev),
        }

    # -- encoder -----------------------------------------------------------

    def encode(self, params: PyTree, frame_embeds: torch.Tensor
               ) -> torch.Tensor:
        """frame_embeds [B, T_enc, d] (the stubbed front end's output) ->
        the encoder states [B, T_enc, d]."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        _, t, d = frame_embeds.shape
        x = frame_embeds.to(dtype) + L.sinusoidal_positions(
            t, d, frame_embeds.device).to(dtype)[None]
        for i in range(cfg.encoder_layers):
            p = layer_slice(params["enc_layers"], i)
            h = L.apply_norm(x, p["attn_norm"], cfg.norm, cfg.norm_eps)
            out, _ = attn.attention(p["attn"], h, cfg, causal=False)
            x = x + out
            h = L.apply_norm(x, p["mlp_norm"], cfg.norm, cfg.norm_eps)
            x = x + L.apply_mlp(p["mlp"], h, cfg.activation, cfg.gated_mlp)
        return L.apply_norm(x, params["enc_final_norm"], cfg.norm,
                            cfg.norm_eps)

    # -- decoder -----------------------------------------------------------

    def _dec_embed(self, params, tokens, offset: int) -> torch.Tensor:
        """Token embeddings plus the learned positions from ``offset``,
        the start clamped to the table as ``dynamic_slice_in_dim`` does."""
        dtype = torch_dtype(self.cfg.dtype)
        x = params["embed"][tokens].to(dtype)
        s = tokens.shape[1]
        start = min(max(int(offset), 0), params["dec_pos"].shape[0] - s)
        return x + params["dec_pos"][start:start + s].to(dtype)[None]

    def decode_hidden(self, params: PyTree, tokens: torch.Tensor,
                      enc_states: torch.Tensor, *, mode: str = "train",
                      self_cache: Optional[PyTree] = None,
                      cache_index: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Optional[PyTree]]:
        """The decoder's residual stream after its last layer (before the
        final norm) and the self-attention caches: filled in prefill,
        updated in place in decode (``self_cache`` and ``cache_index``
        given, one token), None in train."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"mode must be 'train', 'prefill' or "
                             f"'decode', got {mode!r}")
        cfg = self.cfg
        decode = mode == "decode"
        if decode:
            cache_index = int(cache_index)
        x = self._dec_embed(params, tokens, cache_index if decode else 0)
        caches = self_cache if decode else None
        for i in range(cfg.num_layers):
            p = layer_slice(params["dec_layers"], i)
            h = L.apply_norm(x, p["self_norm"], cfg.norm, cfg.norm_eps)
            out, kv = attn.attention(
                p["self_attn"], h, cfg,
                kv_cache=layer_slice(self_cache, i) if decode else None,
                cache_index=cache_index)
            if mode == "prefill":
                if caches is None:
                    caches = tree_map(lambda t: t.new_empty(
                        (cfg.num_layers,) + t.shape), kv)
                tree_map_pair(lambda dst, src, i=i: dst[i].copy_(src),
                              caches, kv)
            x = x + out
            h = L.apply_norm(x, p["cross_norm"], cfg.norm, cfg.norm_eps)
            out, _ = attn.attention(p["cross_attn"], h, cfg,
                                    kv_source=enc_states, causal=False)
            x = x + out
            h = L.apply_norm(x, p["mlp_norm"], cfg.norm, cfg.norm_eps)
            x = x + L.apply_mlp(p["mlp"], h, cfg.activation, cfg.gated_mlp)
        return x, caches

    def logits(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        """Final norm, the tied vocabulary projection in f32 and the
        padded-vocabulary mask."""
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        logits = x.to(torch.float32) @ params["embed"].to(torch.float32).T
        if cfg.padded_vocab != cfg.vocab_size:
            iota = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return logits

    def decode(self, params: PyTree, tokens: torch.Tensor,
               enc_states: torch.Tensor, *, mode: str = "train",
               self_cache: Optional[PyTree] = None,
               cache_index: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[PyTree]]:
        """(logits [B, S, V], the caches as :meth:`decode_hidden`)."""
        x, caches = self.decode_hidden(params, tokens, enc_states, mode=mode,
                                       self_cache=self_cache,
                                       cache_index=cache_index)
        return self.logits(params, x), caches

    # -- task API ------------------------------------------------------------

    def apply(self, params: PyTree, tokens: torch.Tensor, *,
              frame_embeds: torch.Tensor, mode: str = "train"
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[PyTree]]:
        """Encode, then decode the whole sequence: (logits, aux loss 0,
        the prefill caches or None)."""
        enc = self.encode(params, frame_embeds)
        logits, cache = self.decode(params, tokens, enc, mode=mode)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return logits, aux, cache

    def init_cache(self, batch: int, seq_len: int,
                   dtype=torch.float32) -> PyTree:
        one = attn.init_kv_cache(batch, seq_len, self.cfg, dtype,
                                 device=self.device)
        return tree_map(lambda t: t.new_zeros((self.cfg.num_layers,)
                                              + t.shape), one)

    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, cache_index: int,
                    enc_states: torch.Tensor) -> Tuple[torch.Tensor, PyTree]:
        """One-token decode: tokens [B, 1]; ``cache`` is updated in place
        and returned."""
        return self.decode(params, tokens, enc_states, mode="decode",
                           self_cache=cache, cache_index=cache_index)

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        logits, _, _ = self.apply(params, batch["tokens"],
                                  frame_embeds=batch["frame_embeds"])
        return L.token_nll(logits, batch["labels"]).mean()
