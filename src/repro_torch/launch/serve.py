"""Greedy batched serving: prefill a prompt batch, pad the caches to the
horizon, then argmax-decode one token at a time — the loop of the JAX
package's ``examples/serve_decode.py``, through the port's
``make_prefill_step`` / ``make_serve_step``.

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

from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.transformer import TransformerLM, tree_map

PyTree = Any


def pad_cache(model: TransformerLM, cache: PyTree, total: int) -> PyTree:
    """Grow the prefill caches to a ``total``-token horizon with zeros, as
    ``serve_decode.py`` pads them against ``init_cache(batch, total)``:
    global KV caches to ``total`` positions, local rings to
    ``min(total, window)`` slots; SSD states keep their shape."""
    cfg = model.cfg
    out: Dict[str, PyTree] = {}
    kinds = {f"b{j}": k for j, k in enumerate(cfg.block_pattern)}
    kinds.update({f"s{j}": k for j, k in enumerate(cfg.block_pattern_suffix)})
    for key, leaf in cache.items():
        kind = kinds[key]
        if kind == "ssd":
            out[key] = leaf
            continue
        target = min(total, cfg.window_size) \
            if kind == "local" and cfg.local_ring_cache else total
        seq_axis = 2 if key.startswith("b") else 1

        def grow(t, target=target, seq_axis=seq_axis):
            have = t.shape[seq_axis]
            if have == target:
                return t
            shape = list(t.shape)
            shape[seq_axis] = target
            big = t.new_zeros(shape)
            big.narrow(seq_axis, 0, have).copy_(t)
            return big

        out[key] = tree_map(grow, leaf)
    return out


@torch.no_grad()
def greedy_generate(model: TransformerLM, params: PyTree,
                    prompts: torch.Tensor, new_tokens: int,
                    mark: Optional[Callable[[str], None]] = None
                    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """prompts [B, P] (integer, on the model's device) -> (generated
    tokens [B, new_tokens], the logits [B, V] each token was drawn from).
    ``mark``, when given, is called with ``"prefill"`` once the caches
    are prefilled and padded and with ``"decode"`` after the last token,
    so a caller can time the two phases."""
    cfg = model.cfg
    prefill = make_prefill_step(cfg, model.device)
    serve = make_serve_step(cfg, model.device)
    prompt_len = prompts.shape[1]
    logits, cache = prefill(params, {"tokens": prompts})
    cache = pad_cache(model, cache, prompt_len + new_tokens)
    if mark is not None:
        mark("prefill")
    tok = torch.argmax(logits, dim=-1)[:, None]
    generated, all_logits = [tok], [logits]
    for i in range(new_tokens - 1):
        logits, cache = serve(params, cache, {
            "tokens": tok, "cache_index": prompt_len + i})
        tok = torch.argmax(logits, dim=-1)[:, None]
        generated.append(tok)
        all_logits.append(logits)
    if mark is not None:
        mark("decode")
    return torch.cat(generated, dim=1), all_logits
