"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function is the specification its CUDA kernel is held against on
the card (``chip_smoke.py``, the ``cuda``-marked tests) and the path the
CPU tests take; the CPU tests in turn hold it against the JAX package's
Pallas kernel run in interpret mode.
"""

from __future__ import annotations

import torch


def aggregate_reference(theta: torch.Tensor, deltas: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """theta: [N]; deltas: [K, N]; coeffs: [K] — eq. (4) fused update,
    summed in f32 and returned in theta's dtype."""
    upd = torch.tensordot(coeffs.to(torch.float32),
                          deltas.to(torch.float32), dims=1)
    return (theta.to(torch.float32) + upd).to(theta.dtype)


def delta_reduce_reference(deltas: torch.Tensor, coeffs: torch.Tensor
                           ) -> torch.Tensor:
    """deltas: [K, N]; coeffs: [K] -> f32 [N], ``sum_k coeffs_k delta_k``."""
    return torch.tensordot(coeffs.to(torch.float32),
                           deltas.to(torch.float32), dims=1)
