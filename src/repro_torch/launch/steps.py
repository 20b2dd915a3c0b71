"""Step builders for the LM serving path, ported from
``repro.launch.steps``: ``build_model``, ``dryrun_config`` (without the
mesh fields) and the prefill / one-token serve steps.

Training steps (``make_train_step``, ``make_fl_round_step``) wait for the
training slice, which also ports the flash backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import UNPORTED, TransformerLM

PyTree = Any

#: model families this slice runs
FAMILIES = ("dense", "ssm")


def build_model(cfg: ModelConfig, device="cuda") -> TransformerLM:
    """The LM for ``cfg`` on ``device``; raises for the families this
    slice does not run (``moe``, ``hybrid`` with recurrent blocks,
    ``audio`` encoder-decoders, ``vlm``)."""
    if cfg.family not in FAMILIES or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is {UNPORTED}")
    return TransformerLM(cfg, device=device)


def dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """Accelerator dtypes: bf16 parameters and activations and the flash
    attention path.  The JAX version also binds activation sharding to a
    mesh and pads the vocabulary for it; one card has no mesh, so
    ``batch_axes`` stays empty and the vocabulary exact."""
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", dtype="bfloat16", attn_impl="flash",
        batch_axes=(), vocab_pad_multiple=0)


def make_prefill_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``(params, batch) -> (last-position logits [B, V], cache)``.  Only
    the last position's logits are returned (serving), so only its row
    goes through the vocabulary projection: the output equals the JAX
    step's ``logits[:, -1]``."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, PyTree]:
        x, cache = model.hidden(params, batch["tokens"], mode="prefill")
        return model.logits(params, x[:, -1:])[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``(params, cache, batch) -> (logits [B, V], cache)``: one-token
    decode against a prefilled cache (updated in place); ``batch`` holds
    ``tokens`` [B, 1] and the int ``cache_index``."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        logits, cache = model.decode_step(params, cache, batch["tokens"],
                                          batch["cache_index"])
        return logits[:, -1, :], cache

    return serve_step
