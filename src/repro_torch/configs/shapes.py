"""The four input shapes of the launch layer and the per-(arch, shape)
coverage rule: a copy of ``repro.configs.shapes`` (data only)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def covered_shapes(spec) -> List[InputShape]:
    """The shapes an architecture must run: train and prefill always,
    decode where the arch decodes, the 500k-token decode where it also
    takes long contexts."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if spec.decode_ok:
        out.append(SHAPES["decode_32k"])
        if spec.long_context_ok:
            out.append(SHAPES["long_500k"])
    return out
