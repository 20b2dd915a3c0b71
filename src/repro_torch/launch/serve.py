"""Greedy batched serving: prefill a prompt batch, pad the caches to the
horizon, then argmax-decode one token at a time — the loop of the JAX
package's ``examples/serve_decode.py``, through the port's
``make_prefill_step`` / ``make_serve_step``, for every family (Whisper
takes its audio frames as ``frame_embeds`` and encodes them once;
qwen2-vl its patch embeddings as ``vision_embeds``).

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.launch.steps import build_model
    model = build_model(get_smoke_config("gemma2-27b"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens, logits = greedy_generate(model, model.init(gen), prompts, 16)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.launch.steps import (LM, make_prefill_step,
                                      make_serve_step)
from repro_torch.models.transformer import tree_map

PyTree = Any


def _grow(tree: PyTree, target: int, seq_axis: int) -> PyTree:
    """Every leaf of ``tree`` zero-padded along ``seq_axis`` to
    ``target``."""
    def grow(t):
        have = t.shape[seq_axis]
        if have == target:
            return t
        shape = list(t.shape)
        shape[seq_axis] = target
        big = t.new_zeros(shape)
        big.narrow(seq_axis, 0, have).copy_(t)
        return big

    return tree_map(grow, tree)


def pad_cache(model: LM, cache: PyTree, total: int) -> PyTree:
    """Grow the prefill caches to a ``total``-token horizon with zeros, as
    ``serve_decode.py`` pads them against ``init_cache(batch, total)``:
    global KV caches (an int8 cache's scales too) and an encoder-decoder's
    stacked self-attention caches to ``total`` positions, local rings to
    ``min(total, window)`` slots; SSD and RG-LRU states keep their
    shape."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        return _grow(cache, total, 2)
    out: Dict[str, PyTree] = {}
    kinds = {f"b{j}": k for j, k in enumerate(cfg.block_pattern)}
    kinds.update({f"s{j}": k for j, k in enumerate(cfg.block_pattern_suffix)})
    for key, leaf in cache.items():
        kind = kinds[key]
        if kind in ("ssd", "recurrent"):
            out[key] = leaf
            continue
        target = min(total, cfg.window_size) \
            if kind == "local" and cfg.local_ring_cache else total
        out[key] = _grow(leaf, target, 2 if key.startswith("b") else 1)
    return out


@torch.no_grad()
def greedy_generate(model: LM, params: PyTree, prompts: torch.Tensor,
                    new_tokens: int,
                    mark: Optional[Callable[[str], None]] = None, *,
                    frame_embeds: Optional[torch.Tensor] = None,
                    vision_embeds: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """prompts [B, P] (integer, on the model's device) -> (generated
    tokens [B, new_tokens], the logits [B, V] each token was drawn from).
    ``frame_embeds`` [B, T_enc, d]: an encoder-decoder's audio frames,
    encoded once before prefill and attended by every step;
    ``vision_embeds`` [B, P_v, d]: a VLM's patch embeddings for the first
    P_v prompt positions.  ``mark``, when given, is called with
    ``"prefill"`` once the caches are prefilled and padded and with
    ``"decode"`` after the last token, so a caller can time the two
    phases."""
    cfg = model.cfg
    prefill = make_prefill_step(cfg, model.device)
    serve = make_serve_step(cfg, model.device)
    prompt_len = prompts.shape[1]
    batch: Dict[str, torch.Tensor] = {"tokens": prompts}
    extra: Dict[str, torch.Tensor] = {}
    if cfg.is_encoder_decoder:
        if frame_embeds is None:
            raise ValueError(f"{cfg.name} needs frame_embeds")
        extra["enc_states"] = model.encode(params, frame_embeds)
        batch.update(extra)
    elif cfg.family == "vlm":
        if vision_embeds is None:
            raise ValueError(f"{cfg.name} needs vision_embeds")
        batch["vision_embeds"] = vision_embeds
    logits, cache = prefill(params, batch)
    cache = pad_cache(model, cache, prompt_len + new_tokens)
    if mark is not None:
        mark("prefill")
    tok = torch.argmax(logits, dim=-1)[:, None]
    generated, all_logits = [tok], [logits]
    for i in range(new_tokens - 1):
        logits, cache = serve(params, cache, {
            "tokens": tok, "cache_index": prompt_len + i, **extra})
        tok = torch.argmax(logits, dim=-1)[:, None]
        generated.append(tok)
        all_logits.append(logits)
    if mark is not None:
        mark("decode")
    return torch.cat(generated, dim=1), all_logits
