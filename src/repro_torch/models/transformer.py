"""Decoder-only LM assembly, ported from ``repro.models.transformer`` for
every block kind: ``global`` and ``local`` attention (with a dense MLP or,
in the ``moe`` family, a mixture of experts), ``recurrent`` (RG-LRU,
recurrentgemma) and ``ssd`` (Mamba-2), with M-RoPE positions and vision
embeddings for the ``vlm`` family.  Whisper's encoder-decoder is
``repro_torch.models.encdec``.

Parameters keep the JAX package's tree, so the parity tests convert it
leaf for leaf (``repro_torch.convert.lm_params_from_jax``):

  {"embed": [V, d], "blocks": {"b0": stacked tree, "b1": ...},
   "final_norm": {...}, optional "lm_head": [d, V],
   optional "suffix_blocks": {"s0": tree, ...}}

where each ``blocks/b{j}`` leaf carries a leading ``num_groups`` axis
(pattern position j of every group).  The JAX package scans over the
groups; here the layers run as a Python loop, each reading its
``[g]`` slice (a view).  Caches are stacked the same way.  Decode writes
the caches in place and returns them.

One code path serves train, prefill (which also returns the filled
caches) and decode.  Prefill computes each attention layer's K/V, each
SSD layer's scan and each recurrent layer's scan once (the JAX package
computes them a second time for the cache; the numbers are the same), so
on the card a prefill launches the flash kernel exactly once per
attention layer and the SSD-chunk kernel once per SSD layer, and decode
launches neither.  The MoE layers' aux losses are summed over the layers
and returned by :meth:`TransformerLM.apply`; :meth:`TransformerLM.loss`
adds ``router_aux_loss_coef`` times the sum, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401 (re-export)

PyTree = Any

def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


def layer_slice(tree: PyTree, g: Optional[int]) -> PyTree:
    """Layer ``g``'s views of a tree stacked over layers (the tree itself
    for ``g=None``, an unstacked suffix block)."""
    return tree if g is None else tree_map(lambda t: t[g], tree)


# --------------------------------------------------------------------------
# Per-kind block: init and apply (one layer)
# --------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                dtype) -> Dict[str, PyTree]:
    dev = gen.device
    p: Dict[str, PyTree] = {"pre_norm": L.init_norm(cfg.d_model, cfg.norm,
                                                    dtype, dev)}
    if kind in ("global", "local"):
        p["attn"] = attn.init_attention(gen, cfg, dtype)
        p["mlp_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        if cfg.family == "moe":
            p["moe"] = moe_lib.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                  dtype)
        if cfg.post_attn_norm:
            p["post_attn_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype,
                                              dev)
        if cfg.post_ffn_norm:
            p["post_ffn_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype,
                                             dev)
    elif kind == "recurrent":
        p["rglru"] = rglru_lib.init_rglru(gen, cfg, dtype)
        p["mlp_norm"] = L.init_norm(cfg.d_model, cfg.norm, dtype, dev)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                              dtype)
    elif kind == "ssd":
        p["ssd"] = ssm_lib.init_ssd(gen, cfg, dtype)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return p


def _prefill_kv_cache(kv: Dict[str, torch.Tensor], cfg: ModelConfig,
                      kind: str) -> Dict[str, torch.Tensor]:
    """This layer's serving cache from its prefill K/V: local layers keep
    the last ``window`` positions in a ring buffer (slot = pos % ring);
    global layers of a ``quantized_kv`` model int8 codes and scales."""
    if kind == "global" and cfg.quantized_kv:
        (kq, ks), (vq, vs) = (attn.quantize_kv(kv[n]) for n in ("k", "v"))
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    if kind != "local" or not cfg.local_ring_cache:
        return kv
    s = kv["k"].shape[1]
    ring = min(s, cfg.window_size)
    ring_pos = torch.arange(s - ring, s, device=kv["k"].device) % ring
    out = {}
    for name, t in kv.items():
        buf = torch.zeros((t.shape[0], ring) + t.shape[2:], dtype=t.dtype,
                          device=t.device)
        buf[:, ring_pos] = t[:, s - ring:]
        out[name] = buf
    return out


def _apply_block(p: Dict[str, PyTree], x: torch.Tensor, cfg: ModelConfig,
                 kind: str, *, rope, cache, cache_index: Optional[int],
                 mode: str
                 ) -> Tuple[torch.Tensor, Optional[PyTree],
                            Optional[torch.Tensor]]:
    """One layer.  Returns (x, this layer's cache: the filled cache in
    prefill, the updated cache in decode, None in train; the MoE aux loss
    or None)."""
    aux = None
    h = L.apply_norm(x, p["pre_norm"], cfg.norm, cfg.norm_eps)

    if kind in ("global", "local"):
        out, new_cache = attn.attention(
            p["attn"], h, cfg, kind=kind, rope=rope,
            kv_cache=cache if mode == "decode" else None,
            cache_index=cache_index)
        if mode == "prefill":
            new_cache = _prefill_kv_cache(new_cache, cfg, kind)
        elif mode == "train":
            new_cache = None
        if cfg.post_attn_norm:
            out = L.apply_norm(out, p["post_attn_norm"], cfg.norm,
                               cfg.norm_eps)
        x = x + out
        h2 = L.apply_norm(x, p["mlp_norm"], cfg.norm, cfg.norm_eps)
        if cfg.family == "moe":
            # decode is drop-free (dense); train and prefill dispatch as
            # the config says
            dispatch = "dense" if mode == "decode" else cfg.moe_dispatch
            out2, aux = moe_lib.apply_moe(p["moe"], h2, cfg, dispatch)
        else:
            out2 = L.apply_mlp(p["mlp"], h2, cfg.activation, cfg.gated_mlp)
        if cfg.post_ffn_norm:
            out2 = L.apply_norm(out2, p["post_ffn_norm"], cfg.norm,
                                cfg.norm_eps)
        return x + out2, new_cache, aux

    if kind == "recurrent":
        out, new_cache = rglru_lib.apply_rglru(
            p["rglru"], h, cfg, cache if mode == "decode" else None,
            return_cache=mode == "prefill")
        x = x + out
        h2 = L.apply_norm(x, p["mlp_norm"], cfg.norm, cfg.norm_eps)
        return x + L.apply_mlp(p["mlp"], h2, cfg.activation,
                               cfg.gated_mlp), new_cache, aux

    if kind == "ssd":
        out, new_cache = ssm_lib.apply_ssd(
            p["ssd"], h, cfg, cache if mode == "decode" else None,
            return_cache=mode == "prefill")
        return x + out, new_cache, aux

    raise ValueError(f"unknown block kind {kind!r}")


def init_block_cache(batch: int, seq_len: int, cfg: ModelConfig, kind: str,
                     dtype, device) -> PyTree:
    if kind == "local":
        # ring buffer: window-sized cache regardless of context length
        ring = min(seq_len, cfg.window_size) if cfg.local_ring_cache \
            else seq_len
        return attn.init_kv_cache(batch, ring, cfg, dtype, device=device)
    if kind == "global":
        return attn.init_kv_cache(batch, seq_len, cfg, dtype,
                                  quantized=cfg.quantized_kv, device=device)
    if kind == "recurrent":
        return rglru_lib.init_rglru_cache(batch, cfg, dtype, device=device)
    if kind == "ssd":
        return ssm_lib.init_ssm_cache(batch, cfg, dtype, device=device)
    raise ValueError(f"unknown block kind {kind!r}")


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformerLM:
    """A decoder-only LM over explicit parameter trees (see the module
    docstring); ``device`` is where :meth:`init` and :meth:`init_cache`
    place their tensors.  ``remat``: in ``mode="train"`` each block of
    the stacked groups runs under ``torch.utils.checkpoint``
    (non-reentrant), as the JAX package wraps it in ``jax.checkpoint``:
    the backward recomputes the block's forward, flash and SSD kernel
    launches included, and keeps only its input."""
    cfg: ModelConfig
    device: Any = "cuda"
    remat: bool = False

    def layers(self) -> Iterator[Tuple[str, Optional[int], str]]:
        """(cache/param key, group index or None for a suffix block,
        kind) for every layer, in order."""
        cfg = self.cfg
        for g in range(cfg.num_groups):
            for j, kind in enumerate(cfg.block_pattern):
                yield f"b{j}", g, kind
        for j, kind in enumerate(cfg.block_pattern_suffix):
            yield f"s{j}", None, kind

    # -- params ------------------------------------------------------------

    def init(self, gen: torch.Generator) -> PyTree:
        """Random parameters from ``gen`` (on ``self.device``), drawn layer
        by layer in f32 and cast to ``param_dtype`` as they are stored, so
        no f32 copy of the whole model ever exists."""
        cfg = self.cfg
        if torch.device(gen.device) != torch.device(self.device):
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        dtype = torch_dtype(cfg.param_dtype)
        params: Dict[str, PyTree] = {
            "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
            "final_norm": L.init_norm(cfg.d_model, cfg.norm, dtype,
                                      self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, dtype)
        blocks: Dict[str, PyTree] = {}
        for key, g, kind in self.layers():
            if g is None:
                continue
            one = _init_block(gen, cfg, kind, dtype)
            if g == 0:
                blocks[key] = tree_map(lambda t: t.new_empty(
                    (cfg.num_groups,) + t.shape), one)
            tree_map_pair(lambda dst, src: dst[g].copy_(src), blocks[key],
                          one)
            del one
        params["blocks"] = blocks
        if cfg.block_pattern_suffix:
            params["suffix_blocks"] = {
                f"s{j}": _init_block(gen, cfg, kind, dtype)
                for j, kind in enumerate(cfg.block_pattern_suffix)}
        return params

    # -- caches --------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int,
                   dtype=torch.float32) -> PyTree:
        cfg = self.cfg
        cache = {}
        for j, kind in enumerate(cfg.block_pattern):
            one = init_block_cache(batch, seq_len, cfg, kind, dtype,
                                   self.device)
            cache[f"b{j}"] = tree_map(lambda t: t.new_zeros(
                (cfg.num_groups,) + t.shape), one)
        for j, kind in enumerate(cfg.block_pattern_suffix):
            cache[f"s{j}"] = init_block_cache(batch, seq_len, cfg, kind,
                                              dtype, self.device)
        return cache

    # -- forward ---------------------------------------------------------------

    def _run_blocks(self, params, x, *, rope, cache, cache_index,
                    mode: str):
        """(x after the last block, the MoE aux losses summed over the
        layers (f32 scalar), the caches)."""
        cfg = self.cfg
        caches_out: Dict[str, PyTree] = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        train = mode == "train"
        if train:
            # one unbind per stacked leaf: its backward stacks the layers'
            # gradients once, where a view per layer would add a zero-filled
            # full-size gradient per layer
            unbound = {key: tree_map(lambda t: t.unbind(0), tree)
                       for key, tree in params["blocks"].items()}
        for key, g, kind in self.layers():
            if g is None:
                p = params["suffix_blocks"][key]
            elif train:
                p = tree_map(lambda ts, g=g: ts[g], unbound[key])
            else:
                p = layer_slice(params["blocks"][key], g)
            c_in = layer_slice(cache[key], g) if mode == "decode" else None
            if self.remat and train and g is not None:
                x, nc, a = torch.utils.checkpoint.checkpoint(
                    _apply_block, p, x, cfg, kind, rope=rope, cache=None,
                    cache_index=None, mode=mode, use_reentrant=False)
            else:
                x, nc, a = _apply_block(p, x, cfg, kind, rope=rope,
                                        cache=c_in, cache_index=cache_index,
                                        mode=mode)
            if a is not None:
                aux = aux + a
            if mode == "train":
                continue
            if g is None:
                caches_out[key] = nc
                continue
            if key not in caches_out:
                caches_out[key] = cache[key] if mode == "decode" else \
                    tree_map(lambda t: t.new_empty(
                        (cfg.num_groups,) + t.shape), nc)
            # decode's KV writes already landed in the stacked cache (views)
            tree_map_pair(lambda dst, src: None if dst[g].data_ptr() ==
                          src.data_ptr() else dst[g].copy_(src),
                          caches_out[key], nc)
        return x, aux, caches_out

    def _embed(self, params, tokens, vision_embeds=None):
        """Token embeddings (scaled by sqrt(d) where the config says);
        ``vision_embeds`` [B, P, d], scaled alike, overwrite the first P
        positions."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        x = params["embed"][tokens].to(dtype)
        root_d = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=dtype,
                                         device=x.device))
        if cfg.embedding_scale:
            x = x * root_d
        if vision_embeds is not None:
            ve = vision_embeds.to(dtype)
            if cfg.embedding_scale:
                ve = ve * root_d
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
        return x

    def logits(self, params, x):
        """Final norm, the (tied) vocabulary projection in f32, the final
        soft-cap and the padded-vocabulary mask."""
        cfg = self.cfg
        x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = x.to(torch.float32) @ params["embed"].to(
                torch.float32).T
        else:
            logits = x.to(torch.float32) @ params["lm_head"].to(
                torch.float32)
        if cfg.final_logit_softcap > 0:
            logits = L.softcap(logits, cfg.final_logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            iota = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(iota < cfg.vocab_size, logits, -1e30)
        return logits

    def hidden(self, params: PyTree, tokens: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None,
               positions_thw: Optional[torch.Tensor] = None,
               vision_embeds: Optional[torch.Tensor] = None,
               mode: str = "train"
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[PyTree]]:
        """The residual stream after the last block (before the final
        norm), the summed MoE aux loss and, in prefill, the filled caches.
        ``positions_thw`` [3, B, S]: M-RoPE ids (the ``vlm`` family);
        ``vision_embeds`` [B, P, d]: patch embeddings for the first P
        positions."""
        if mode not in ("train", "prefill"):
            raise ValueError(f"mode must be 'train' or 'prefill', got "
                             f"{mode!r}")
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        rope = attn.make_rope_tables(self.cfg, positions, positions_thw)
        x = self._embed(params, tokens, vision_embeds)
        x, aux, caches = self._run_blocks(params, x, rope=rope, cache=None,
                                          cache_index=None, mode=mode)
        return x, aux, (caches if mode == "prefill" else None)

    def apply(self, params: PyTree, tokens: torch.Tensor, *,
              positions: Optional[torch.Tensor] = None,
              positions_thw: Optional[torch.Tensor] = None,
              vision_embeds: Optional[torch.Tensor] = None,
              mode: str = "train"
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[PyTree]]:
        """Full-sequence forward.  Returns (logits, aux_loss, cache|None)."""
        x, aux, caches = self.hidden(
            params, tokens, positions=positions, positions_thw=positions_thw,
            vision_embeds=vision_embeds, mode=mode)
        return self.logits(params, x), aux, caches

    def decode_step(self, params: PyTree, cache: PyTree,
                    tokens: torch.Tensor, cache_index: int, *,
                    positions_thw: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One-token decode.  tokens: [B, 1]; ``cache`` is updated in place
        and returned; ``positions_thw`` [3, B, 1] for M-RoPE."""
        b, s = tokens.shape
        assert s == 1
        cache_index = int(cache_index)
        positions = torch.full((b, 1), cache_index, dtype=torch.int64,
                               device=tokens.device)
        rope = attn.make_rope_tables(self.cfg, positions, positions_thw)
        x = self._embed(params, tokens)
        x, _, new_cache = self._run_blocks(params, x, rope=rope, cache=cache,
                                           cache_index=cache_index,
                                           mode="decode")
        return self.logits(params, x), new_cache

    # -- losses -------------------------------------------------------------

    def loss(self, params: PyTree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        logits, aux, _ = self.apply(params, batch["tokens"])
        nll = L.token_nll(logits, batch["labels"])
        mask = batch.get("mask")
        if mask is not None:
            nll = nll * mask
            denom = torch.clamp(mask.sum(), min=1.0)
        else:
            denom = nll.numel()
        return nll.sum() / denom + self.cfg.router_aux_loss_coef * aux


def tree_map_pair(fn, a: PyTree, b: PyTree) -> None:
    """Call ``fn(a_leaf, b_leaf)`` over two trees of the same structure."""
    if isinstance(a, dict):
        for k in a:
            tree_map_pair(fn, a[k], b[k])
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for x, y in zip(a, b):
            tree_map_pair(fn, x, y)
    else:
        fn(a, b)


def param_count(params: PyTree) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def param_bytes(params: PyTree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))

