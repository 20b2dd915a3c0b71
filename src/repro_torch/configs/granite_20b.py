"""granite-20b — llama-architecture MQA code model.

Assigned: 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
[arXiv:2405.04324]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,               # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    gated_mlp=False,              # GPT-BigCode style plain MLP
    tie_embeddings=False,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2405.04324",
    long_context_ok=False,
    skip_note="full quadratic attention; long_500k skipped (DESIGN.md §4)",
)
