"""Public wrappers around the port's kernels (``fl_aggregate``,
``fl_aggregate_pytree``, ``fl_aggregate_leaves``, ``fl_aggregate_lanes``,
``fl_delta_reduce``, ``fl_delta_reduce_leaves``, ``flash_attention``,
``ssd_chunk``), with one dispatch rule.

``impl`` mirrors ``repro.kernels.ops.use_pallas_kernel``:

* ``'cuda'`` forces the hand-written kernel (CUDA tensors required);
* ``'auto'`` takes the kernel when the tensors lie on a CUDA device and
  the plain version (``kernels.ref``) when they lie on the CPU;
* ``'ref'`` takes the plain version, on the CPU only.

Nothing falls back: ``impl='cuda'`` on CPU tensors raises, ``impl='ref'``
on CUDA tensors raises (on the card the plain version runs only as the
kernel's yardstick, called from ``kernels.ref`` directly), and a failed
build or launch raises from the kernel wrapper.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.kernels import ref

IMPLS = ("auto", "cuda", "ref")


def use_cuda_kernel(impl: str, device: torch.device) -> bool:
    """THE kernel-dispatch predicate: True when the call must launch the
    CUDA kernel for tensors on ``device``; raises where the request and
    the device disagree."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    on_cuda = torch.device(device).type == "cuda"
    if impl == "cuda" and not on_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got device "
                         f"{device}")
    if impl == "ref" and on_cuda:
        raise ValueError("impl='ref' is the CPU path; on a CUDA device the "
                         "kernel runs (impl='auto' or 'cuda')")
    return on_cuda


def fl_aggregate(theta: torch.Tensor, deltas: torch.Tensor,
                 coeffs: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Fused eq.-(4) aggregation over flattened parameters:
    theta [N] + sum_k coeffs[k] * deltas[k] ([K, N]), in theta's dtype."""
    if use_cuda_kernel(impl, theta.device):
        from repro_torch.kernels.fl_aggregate import fl_aggregate_cuda
        return fl_aggregate_cuda(theta, deltas, coeffs)
    return ref.aggregate_reference(theta, deltas, coeffs)


def fl_aggregate_pytree(global_params: Dict[str, torch.Tensor],
                        stacked_deltas: Dict[str, torch.Tensor],
                        coeffs: torch.Tensor, impl: str = "auto"
                        ) -> Dict[str, torch.Tensor]:
    """eq. (4) over a params dict, one leaf at a time: per leaf the flat
    :func:`fl_aggregate` of ``p.reshape(-1)`` and ``d.reshape(K, -1)`` —
    one kernel launch per leaf on a CUDA device.  The round's path is
    ``fl.server.aggregate_fused`` (one launch over all the leaves); this
    per-leaf form is the JAX package's ``fl_aggregate_pytree``."""
    return {name: fl_aggregate(p.reshape(-1),
                               stacked_deltas[name].reshape(
                                   stacked_deltas[name].shape[0], -1),
                               coeffs, impl=impl).reshape(p.shape)
            for name, p in global_params.items()}


def fl_aggregate_leaves(thetas: Sequence[torch.Tensor],
                        deltas: Sequence[torch.Tensor], coeffs: torch.Tensor,
                        impl: str = "auto") -> List[torch.Tensor]:
    """eq.-(4) aggregation over a model's leaves where they lie: per leaf
    thetas[i] + sum_k coeffs[k] * deltas[i][k] (deltas[i] of shape
    ``(K,) + thetas[i].shape``), in theta's dtype; one kernel launch per
    table of leaves on a CUDA device."""
    if use_cuda_kernel(impl, thetas[0].device):
        from repro_torch.kernels.fl_aggregate import fl_aggregate_leaves_cuda
        return fl_aggregate_leaves_cuda(thetas, deltas, coeffs)
    return ref.aggregate_leaves_reference(thetas, deltas, coeffs)


def fl_aggregate_lanes(thetas: Sequence[torch.Tensor],
                       deltas: Sequence[torch.Tensor], coeffs: torch.Tensor,
                       impl: str = "auto") -> List[torch.Tensor]:
    """eq.-(4) aggregation of S lanes of one model (the scenario arena's
    round): thetas[i] ``[S, ...]``, deltas[i] ``[S, K, ...]``, coeffs
    ``[S, K]`` -> per leaf ``[S, ...]``, lane s summed with ``coeffs[s]``;
    one kernel launch per table of (lane, leaf) segments on a CUDA
    device."""
    if use_cuda_kernel(impl, thetas[0].device):
        from repro_torch.kernels.fl_aggregate import fl_aggregate_lanes_cuda
        return fl_aggregate_lanes_cuda(thetas, deltas, coeffs)
    return ref.aggregate_lanes_reference(thetas, deltas, coeffs)


def fl_delta_reduce(deltas: torch.Tensor, coeffs: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Partial eq.-(4) reduce ``sum_k coeffs[k] * deltas[k]`` -> f32 [N]
    (no theta add): the per-shard term of a client-sharded aggregation."""
    if use_cuda_kernel(impl, deltas.device):
        from repro_torch.kernels.fl_aggregate import fl_delta_reduce_cuda
        return fl_delta_reduce_cuda(deltas, coeffs)
    return ref.delta_reduce_reference(deltas, coeffs)


def fl_delta_reduce_leaves(deltas: Sequence[torch.Tensor],
                           coeffs: torch.Tensor,
                           outs: Sequence[torch.Tensor],
                           impl: str = "auto") -> List[torch.Tensor]:
    """Partial eq.-(4) reduce over a model's leaves: per leaf f32
    ``sum_k coeffs[k] * deltas[i][k]`` (deltas[i] of shape ``(K,) +
    shape_i``), written into ``outs``; one kernel launch per table of
    leaves on a CUDA device."""
    if use_cuda_kernel(impl, deltas[0].device):
        from repro_torch.kernels.fl_aggregate import (
            fl_delta_reduce_leaves_cuda)
        return fl_delta_reduce_leaves_cuda(deltas, coeffs, outs=outs)
    parts = ref.delta_reduce_leaves_reference(deltas, coeffs)
    for out, part in zip(outs, parts):
        out.copy_(part)
    return list(outs)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None,
                    return_lse: bool = False, impl: str = "auto"):
    """q: [B, H, Sq, D]; k, v: [B, Hkv, Sk, D] -> [B, H, Sq, D] (the
    kernel reads strided views, so ``[B, S, H, D]`` tensors may pass as
    ``transpose(1, 2)``); with ``return_lse``, ``(out, lse)``, lse f32
    ``[B, H, Sq]``."""
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              return_lse=return_lse)
    if use_cuda_kernel(impl, q.device):
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        return flash_attention_cuda(q, k, v, **kw)
    return ref.mha_reference(q, k, v, **kw)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int,
              impl: str = "auto"):
    """Intra-chunk SSD: x [B, S, nh, hd], dt [B, S, nh], a_log [nh],
    b_in/c_in [B, S, N] -> (y_diag [B, S, nh, hd], states
    [B, nc, nh, hd, N] f32)."""
    if use_cuda_kernel(impl, x.device):
        from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
        return ssd_chunk_cuda(x, dt, a_log, b_in, c_in, chunk=chunk)
    return ref.ssd_chunk_batched_reference(x, dt, a_log, b_in, c_in, chunk)
