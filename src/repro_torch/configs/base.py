"""Architecture registry infrastructure: ArchSpec + smoke-variant builder
(a copy of ``repro.configs.base``).

Each ``repro_torch/configs/<arch>.py`` defines ``CONFIG`` (the exact assigned
full-size configuration, with the source citation) and registers an
``ArchSpec`` carrying shape-coverage metadata (which input shapes lower which
step; long_500k requires a sub-quadratic mechanism — see DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    citation: str
    long_context_ok: bool = False     # may lower long_500k
    decode_ok: bool = True            # decoder exists (encoder-only: False)
    skip_note: str = ""               # DESIGN.md note for skipped shapes


_SMOKE_PATTERNS = {
    # reduced block pattern per family (2 layers, d<=512, <=4 experts)
    ("recurrent", "recurrent", "local"): ("recurrent", "local"),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    pattern = cfg.block_pattern
    if len(pattern) > 2:
        uniq = tuple(dict.fromkeys(pattern))       # preserve order
        pattern = uniq[:2] if len(uniq) >= 2 else uniq * 2
    if len(pattern) == 1:
        pattern = pattern
        layers = 2
    else:
        pattern = pattern[:2]
        layers = 2
    d_model = min(cfg.d_model, 256)
    num_heads = min(cfg.num_heads, 4)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    while num_heads % num_kv:
        num_kv -= 1
    head_dim = 64
    ssm_heads = 4
    ssm_head_dim = (cfg.ssm_expand * d_model) // ssm_heads
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        block_pattern_suffix=(),
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        block_pattern=pattern,
        window_size=min(cfg.window_size, 64),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=(min(cfg.experts_per_token, 2)
                           if cfg.experts_per_token else 0),
        ssm_heads=ssm_heads,
        ssm_head_dim=ssm_head_dim,
        ssm_state_dim=min(cfg.ssm_state_dim, 32),
        ssm_chunk=16,
        rglru_width=min(cfg.rglru_width or d_model, 256),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 32),
        vision_patches=min(cfg.vision_patches, 16) if cfg.vision_patches else 0,
        mrope_sections=(8, 12, 12) if cfg.rope_type == "mrope" else
        cfg.mrope_sections,
        attn_impl="naive",
    )
