"""Step builders for the LM serving path, ported from
``repro.launch.steps``: ``build_model``, ``dryrun_config`` (without the
mesh fields) and the prefill / one-token serve steps for every family.

Training steps (``make_train_step``, ``make_fl_round_step``) wait for the
training slice, which also ports the flash backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncoderDecoderLM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.vlm import mrope_decode_positions, mrope_positions

PyTree = Any
LM = Union[TransformerLM, EncoderDecoderLM]


def build_model(cfg: ModelConfig, device="cuda") -> LM:
    """The LM for ``cfg`` on ``device``: an :class:`EncoderDecoderLM` for
    an encoder-decoder (whisper), a :class:`TransformerLM` otherwise."""
    if cfg.is_encoder_decoder:
        return EncoderDecoderLM(cfg, device=device)
    return TransformerLM(cfg, device=device)


def dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """Accelerator dtypes: bf16 parameters and activations and the flash
    attention path; the MoE family routes in 16 token groups, the JAX
    version's value for one pod's data axis (the groups set the capacity
    per group, and so which tokens drop).  The JAX version also binds
    activation sharding to a mesh and pads the vocabulary for it; one card
    has no mesh, so ``batch_axes`` stays empty and the vocabulary exact."""
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", dtype="bfloat16", attn_impl="flash",
        batch_axes=(),
        moe_groups=16 if cfg.family == "moe" else cfg.moe_groups,
        vocab_pad_multiple=0)


def make_prefill_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``(params, batch) -> (last-position logits [B, V], cache)``.

    ``batch`` holds ``tokens`` and, for the audio family, ``frame_embeds``
    (encoded here, as the JAX step does) or the already encoded
    ``enc_states``; for the VLM family ``vision_embeds``, with M-RoPE
    positions in the vision-prefix layout.  Only the last position's
    logits are returned (serving), so only its row goes through the
    vocabulary projection: the output equals the JAX step's
    ``logits[:, -1]``."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, PyTree]:
        tokens = batch["tokens"]
        if cfg.is_encoder_decoder:
            enc = batch.get("enc_states")
            if enc is None:
                enc = model.encode(params, batch["frame_embeds"])
            x, cache = model.decode_hidden(params, tokens, enc,
                                           mode="prefill")
        else:
            kw = {}
            if cfg.family == "vlm":
                b, s = tokens.shape
                kw = dict(positions_thw=mrope_positions(
                    b, s, cfg.vision_patches, device=tokens.device),
                    vision_embeds=batch["vision_embeds"])
            x, _, cache = model.hidden(params, tokens, mode="prefill", **kw)
        return model.logits(params, x[:, -1:])[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``(params, cache, batch) -> (logits [B, V], cache)``: one-token
    decode against a prefilled cache (updated in place); ``batch`` holds
    ``tokens`` [B, 1], the int ``cache_index`` and, for the audio family,
    ``enc_states``."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        tokens, idx = batch["tokens"], batch["cache_index"]
        if cfg.is_encoder_decoder:
            logits, cache = model.decode_step(params, cache, tokens, idx,
                                              batch["enc_states"])
        else:
            kw = {}
            if cfg.family == "vlm":
                kw = dict(positions_thw=mrope_decode_positions(
                    tokens.shape[0], idx, cfg.vision_patches,
                    device=tokens.device))
            logits, cache = model.decode_step(params, cache, tokens, idx,
                                              **kw)
        return logits[:, -1, :], cache

    return serve_step
