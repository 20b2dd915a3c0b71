"""Qwen2-VL's M-RoPE position ids, ported from ``repro.models.vlm``
(arXiv:2409.12191).

The vision encoder is a stub, as in the JAX package: callers supply patch
embeddings ``[B, P, d_model]`` that overwrite the first P token slots
(``TransformerLM`` ``vision_embeds``).  What is ported is the language
decoder's 3-D (temporal, height, width) position ids: vision patches walk
the patch grid at temporal position 0, text tokens resume ordinary
sequential positions past the grid.  The ids are integers and equal the
JAX package's bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _grid(num_patches: int, grid_hw: Optional[Tuple[int, int]]
          ) -> Tuple[int, int]:
    if grid_hw is None:
        side = int(math.ceil(math.sqrt(max(num_patches, 1))))
        return side, side
    return grid_hw


def mrope_positions(batch: int, seq_len: int, num_patches: int,
                    grid_hw: Optional[Tuple[int, int]] = None,
                    device="cuda") -> torch.Tensor:
    """``[3, B, S]`` (t, h, w) int32 ids in the vision-prefix layout.

    Patches occupy positions ``[0, P)``: t = 0, (h, w) walk the grid
    (h clamped to its last row).  Text token i >= P gets t = h = w =
    ``t0 + (i - P)`` with ``t0 = max(gh, gw)``.  Without patches every
    stream is ``arange(S)``.
    """
    idx = torch.arange(seq_len, dtype=torch.int32, device=device)
    if num_patches == 0:
        pos = torch.stack([idx, idx, idx])
    else:
        gh, gw = _grid(num_patches, grid_hw)
        is_vision = idx < num_patches
        vh = torch.clamp(torch.div(idx, gw, rounding_mode="floor"),
                         max=gh - 1)
        vw = torch.remainder(idx, gw)
        text = max(gh, gw) + (idx - num_patches)
        pos = torch.stack([torch.where(is_vision, 0, text),
                           torch.where(is_vision, vh, text),
                           torch.where(is_vision, vw, text)])   # [3, S]
    return pos[:, None, :].expand(3, batch, seq_len)


def mrope_decode_positions(batch: int, cache_index: int, num_patches: int,
                           grid_hw: Optional[Tuple[int, int]] = None,
                           device="cuda") -> torch.Tensor:
    """``[3, B, 1]`` int32 ids of the one decode token at
    ``cache_index``: ``max(grid) + (cache_index - P)`` on every stream."""
    t0 = max(_grid(num_patches, grid_hw))
    pos = torch.full((3, batch, 1), t0 + (int(cache_index) - num_patches),
                     dtype=torch.int32, device=device)
    return pos
