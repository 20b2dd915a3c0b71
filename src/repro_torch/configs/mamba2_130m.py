"""mamba2-130m — SSD (state-space duality), attention-free.

Assigned: 24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
[arXiv:2405.21060]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,                  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm_state_dim=128,
    ssm_expand=2,
    ssm_heads=24,                 # inner 1536 / head_dim 64
    ssm_head_dim=64,
    ssm_chunk=256,
    rope_type="none",
    norm="rmsnorm",
    tie_embeddings=True,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2405.21060",
    long_context_ok=True,         # constant-state decode
)
