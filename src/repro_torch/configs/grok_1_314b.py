"""grok-1-314b — xAI Grok-1 MoE.

Assigned: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    activation="gelu",
    gated_mlp=True,
    attn_logit_softcap=30.0,      # grok uses attn logit capping
    final_logit_softcap=30.0,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="hf:xai-org/grok-1",
    long_context_ok=False,
    skip_note="full quadratic attention; long_500k skipped (DESIGN.md §4)",
)
