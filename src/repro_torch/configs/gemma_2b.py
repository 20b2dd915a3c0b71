"""gemma-2b — GeGLU, head_dim=256, MQA.

Assigned: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.
[arXiv:2403.08295]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,               # MQA on the 2b variant
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="gelu",
    gated_mlp=True,               # GeGLU
    embedding_scale=True,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2403.08295",
    long_context_ok=False,
    skip_note="full quadratic attention; long_500k skipped (DESIGN.md §4)",
)
