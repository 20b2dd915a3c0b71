"""Unified model configuration covering all assigned architecture families
(a copy of ``repro.models.config``, pure Python).

One dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM backbones;
family-specific fields are ignored by families that do not use them. The
per-architecture instantiations live in ``repro_torch.configs``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // num_heads

    # --- block pattern -----------------------------------------------------
    # Repeating per-layer block pattern; (num_layers - len(suffix)) must be
    # divisible by its length. Entries: "global" (full attn), "local"
    # (sliding window), "recurrent" (RG-LRU), "ssd" (Mamba-2 SSD block).
    # ``block_pattern_suffix`` holds trailing layers that do not fit the
    # repeat (e.g. recurrentgemma's 26 = 8 x (r,r,l) + (r,r)) so the scanned
    # HLO stays O(pattern) instead of O(num_layers) — compile-time critical.
    block_pattern: Tuple[str, ...] = ("global",)
    block_pattern_suffix: Tuple[str, ...] = ()
    window_size: int = 4096           # for "local" blocks

    # --- attention ----------------------------------------------------------
    rope_theta: float = 10_000.0
    rope_type: str = "rope"           # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w head_dim split
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)

    # --- FFN ----------------------------------------------------------------
    activation: str = "silu"          # silu | gelu
    gated_mlp: bool = True            # GeGLU / SwiGLU

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # token groups for the sort dispatch. Grouping keeps the argsort /
    # scatter / gather *local to a data shard* (set = number of data shards
    # by the launcher): without it GSPMD lowers cross-shard token gathers
    # into O(T^2) masked contractions — see EXPERIMENTS.md §Perf.
    moe_groups: int = 1
    moe_dispatch: str = "sort"        # sort | capacity (ablation toggle)
    local_ring_cache: bool = True     # window-sized local KV (ablation)
    quantized_kv: bool = False        # int8 global-layer KV caches (+scales)

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state_dim: int = 128
    ssm_expand: int = 2
    ssm_heads: int = 24               # v-heads of SSD
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv_width: int = 4

    # --- recurrent (RG-LRU / Griffin) ----------------------------------------
    rglru_width: Optional[int] = None  # default d_model
    rglru_conv_width: int = 4

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500       # whisper: 30 s of audio frames
    frontend_dim: Optional[int] = None  # stubbed frontend embedding width

    # --- VLM ------------------------------------------------------------------
    vision_patches: int = 0           # stub patch-embedding count per sample
    vision_dim: Optional[int] = None

    # --- misc ------------------------------------------------------------------
    attn_impl: str = "auto"           # auto | naive | flash
    flash_block_q: int = 512
    flash_block_kv: int = 512

    # --- distribution hints ---------------------------------------------------
    # When non-empty, the model inserts with_sharding_constraint on the
    # large activations (residual stream, logits). Set by the launcher to
    # the mesh's data axes; empty for single-device runs.
    batch_axes: Tuple[str, ...] = ()
    model_axis: str = "model"

    # pad the embedding/vocab dim to this multiple for shardability (0 =
    # exact vocab). Padded logit slots are masked to -inf so the softmax
    # is unchanged; labels never index them. Standard MaxText practice —
    # set by the launcher for vocabs not divisible by the model axis.
    vocab_pad_multiple: int = 0

    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embedding_scale: bool = False     # gemma: scale embeddings by sqrt(d)
    post_attn_norm: bool = False      # gemma2 sandwich norms
    post_ffn_norm: bool = False
    dtype: str = "float32"            # activation/computation dtype
    param_dtype: str = "float32"
    max_position: int = 1 << 20

    def __post_init__(self):
        body = self.num_layers - len(self.block_pattern_suffix)
        if body < 0 or body % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} minus suffix "
                f"{len(self.block_pattern_suffix)} not divisible by "
                f"block pattern length {len(self.block_pattern)}")
        if self.family == "moe" and (self.num_experts <= 0
                                     or self.experts_per_token <= 0):
            raise ValueError(f"{self.name}: MoE family needs experts")

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_multiple <= 0:
            return self.vocab_size
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def num_groups(self) -> int:
        return (self.num_layers - len(self.block_pattern_suffix)) \
            // len(self.block_pattern)

    @property
    def all_blocks(self) -> Tuple[str, ...]:
        return self.block_pattern * self.num_groups + \
            self.block_pattern_suffix

    @property
    def is_attention_free(self) -> bool:
        return all(b == "ssd" for b in self.all_blocks)

    @property
    def supports_long_context(self) -> bool:
        """True if no block needs quadratic global attention over the cache.

        Pure SSM and recurrent+local hybrids decode in O(window); gemma2's
        alternating local/global still holds a full global KV cache but the
        per-step decode cost is linear in cache length (flash-decode), so we
        treat 'has at least one sub-quadratic mechanism AND explicit support
        flag' in the arch config — see repro.configs.
        """
        return all(b in ("ssd", "recurrent", "local")
                   for b in self.all_blocks)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + norms), exact for
        our parameterisation; used for model-size M in the LROA system model
        and for MODEL_FLOPS in the roofline."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += v * d

        def attn_params() -> int:
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def mlp_params(ff: int) -> int:
            return d * ff * (3 if self.gated_mlp else 2)

        def moe_params() -> int:
            expert = mlp_params(self.d_ff)
            return self.num_experts * expert + d * self.num_experts

        def ssd_params() -> int:
            inner = self.ssm_expand * d
            nh, st = self.ssm_heads, self.ssm_state_dim
            in_proj = d * (2 * inner + 2 * st + nh)
            conv = (inner + 2 * st) * self.ssm_conv_width
            out = inner * d
            return in_proj + conv + out + 2 * nh + inner

        def rglru_params() -> int:
            width = self.rglru_width or d
            return (d * width * 2 + width * d + width * self.rglru_conv_width
                    + 2 * width * width + 2 * width)

        def block_params(kind: str) -> int:
            per = 2 * d                       # pre-norms (attn/mix + mlp)
            if kind in ("global", "local"):
                per += attn_params()
                per += moe_params() if self.family == "moe" \
                    else mlp_params(self.d_ff)
            elif kind == "recurrent":
                per += rglru_params()
                per += mlp_params(self.d_ff)
            elif kind == "ssd":
                per += ssd_params()
            else:
                raise ValueError(kind)
            return per

        total += sum(block_params(kind) for kind in self.all_blocks)
        total += d                            # final norm
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (2 * d + attn_params()
                                         + mlp_params(self.d_ff))
            cross = self.num_layers * (d + attn_params())
            total += enc + cross + self.encoder_seq_len * d  # enc pos-embed
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        expert = d * self.d_ff * (3 if self.gated_mlp else 2)
        inactive = (self.num_experts - self.experts_per_token) * expert
        return int(self.param_count() - self.num_layers * inactive)
