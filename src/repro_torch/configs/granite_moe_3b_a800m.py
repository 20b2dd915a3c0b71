"""granite-moe-3b-a800m — IBM Granite 3.0 MoE family.

Assigned: 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155,
MoE 40 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    activation="silu",
    gated_mlp=True,
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    long_context_ok=False,
    skip_note="full quadratic attention; long_500k skipped (DESIGN.md §4)",
)
