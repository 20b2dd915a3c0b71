"""recurrentgemma-2b — RG-LRU + local attention, 1:2 pattern (Griffin).

Assigned: 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
26 layers follow the (recurrent, recurrent, local) x 8 + (recurrent,
recurrent) layout of the released model: the repeat is scanned (8 groups)
and the two trailing layers live in ``block_pattern_suffix`` so the HLO
stays O(pattern) in depth. [arXiv:2402.19427]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

_PATTERN = ("recurrent", "recurrent", "local")

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,               # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=_PATTERN,              # scanned 8x
    block_pattern_suffix=("recurrent", "recurrent"),
    window_size=2048,
    rglru_width=2560,
    activation="gelu",
    gated_mlp=True,
    embedding_scale=True,
    tie_embeddings=True,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2402.19427",
    long_context_ok=True,         # RG-LRU state + windowed local attention
)
