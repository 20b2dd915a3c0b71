"""repro_torch.configs — the architecture registry, copied from
``repro.configs`` (data only; the port imports nothing of the JAX
package).  Each entry cites its source model card or paper.

``repro_torch.launch.steps.build_model`` builds every family registered
here: ``dense``, ``ssm``, ``moe``, ``hybrid`` (RG-LRU), ``vlm`` (M-RoPE)
and ``audio`` (the encoder-decoder).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec, smoke_config

from repro_torch.configs import (gemma2_27b, gemma_2b, granite_20b,
                                 granite_moe_3b_a800m, grok_1_314b,
                                 mamba2_130m, qwen2_vl_7b,
                                 recurrentgemma_2b, whisper_tiny, yi_9b)

ARCHS: Dict[str, ArchSpec] = {
    "granite-moe-3b-a800m": granite_moe_3b_a800m.SPEC,
    "whisper-tiny": whisper_tiny.SPEC,
    "mamba2-130m": mamba2_130m.SPEC,
    "recurrentgemma-2b": recurrentgemma_2b.SPEC,
    "grok-1-314b": grok_1_314b.SPEC,
    "gemma-2b": gemma_2b.SPEC,
    "yi-9b": yi_9b.SPEC,
    "qwen2-vl-7b": qwen2_vl_7b.SPEC,
    "granite-20b": granite_20b.SPEC,
    "gemma2-27b": gemma2_27b.SPEC,
}


def get_spec(arch: str) -> ArchSpec:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_config(arch: str):
    return get_spec(arch).config


def get_smoke_config(arch: str):
    return smoke_config(get_config(arch))
