"""qwen2-vl-7b — VLM backbone with M-RoPE; vision encoder STUBBED.

Assigned: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
input_specs supplies ViT patch embeddings [B, P, d]; the language decoder
applies M-RoPE (t/h/w split 16/24/24 of the 64 rotary slot pairs).
[arXiv:2409.12191]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    activation="silu",
    gated_mlp=True,
    vision_patches=256,           # stub dynamic-resolution grid 16x16
    tie_embeddings=False,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2409.12191",
    long_context_ok=False,
    skip_note="full quadratic attention; long_500k skipped (DESIGN.md §4)",
)
