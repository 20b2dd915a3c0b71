"""gemma2-27b — local/global alternating attention with logit softcaps.

Assigned: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Sliding window 4096 on local layers, attn softcap 50, final softcap 30,
query scale (d_model/num_heads)^-0.5 = 144^-0.5. [arXiv:2408.00118]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    block_pattern=("local", "global"),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=144.0 ** -0.5,    # d_model / num_heads = 144
    activation="gelu",
    gated_mlp=True,
    embedding_scale=True,
    post_attn_norm=True,
    post_ffn_norm=True,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2408.00118",
    # half the layers are windowed; global layers decode with flash-decode
    # over a sharded cache -> linear per-step cost: we run long_500k.
    long_context_ok=True,
)
