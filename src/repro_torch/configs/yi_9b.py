"""yi-9b — llama-architecture GQA dense model.

Assigned: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
[arXiv:2403.04652]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    activation="silu",
    gated_mlp=True,               # SwiGLU
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2403.04652",
    long_context_ok=False,
    skip_note="full quadratic attention; long_500k skipped (DESIGN.md §4)",
)
