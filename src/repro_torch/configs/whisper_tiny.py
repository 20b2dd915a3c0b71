"""whisper-tiny — enc-dec speech model, transformer backbone only.

Assigned: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865, enc-dec with a
STUBBED conv/mel frontend (input_specs supplies 1500 frame embeddings).
[arXiv:2212.04356]
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,                 # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_seq_len=1500,
    norm="layernorm",
    norm_eps=1e-5,
    activation="gelu",
    gated_mlp=False,
    rope_type="none",             # whisper: learned/sinusoidal positions
    tie_embeddings=True,
    max_position=1 << 16,
)

SPEC = ArchSpec(
    config=CONFIG,
    citation="arXiv:2212.04356",
    long_context_ok=False,
    skip_note=("decoder context beyond model card; decode_32k lowered "
               "structurally, long_500k skipped (full attention)"),
)
