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

Every wrapper reports its kernel's work to an active
``launch.op_cost.OpCounter`` (``op_cost.kernel``), by the formulas
PERF.md's kernel table uses: ``fl_aggregate`` (and its lane and reduce
forms) 2 flops per (k, element) and each theta, delta and output byte
once; flash attention ``flash_attention.flash_attention_flops`` over the
visible (query, key) pairs, q, k, v and out (and lse) once, one exp per
visible pair (two with a soft-cap); the SSD chunk
``ssd_scan.ssd_chunk_flops`` (C B^T once per (batch, chunk), W X, the
states) and its inputs and outputs once.  A plain version run in the
kernel's place is not counted, so a count is the same on every device.
On the ``meta`` device a wrapper returns empty outputs of the kernel's
shapes, and only under an active counter (the dry run,
``launch.dryrun``); elsewhere ``meta`` raises.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.launch import op_cost

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


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _aggregate_region(name: str, thetas, deltas):
    """The op-count region of an eq.-(4) launch: 2 flops per (k,
    element); each theta and delta byte read once and the output (theta's
    type) written once."""
    return op_cost.kernel(name, deltas[0].device, lambda: (
        2.0 * sum(d.numel() for d in deltas),
        2 * _nbytes(thetas) + _nbytes(deltas), 0.0))


def _reduce_region(deltas, outs):
    """The op-count region of a partial reduce: 2 flops per (k, element),
    each delta byte read once, the f32 partial written once."""
    return op_cost.kernel("fl_delta_reduce", deltas[0].device, lambda: (
        2.0 * sum(d.numel() for d in deltas),
        _nbytes(deltas) + 4 * sum(o.numel() for o in outs), 0.0))


def fl_aggregate(theta: torch.Tensor, deltas: torch.Tensor,
                 coeffs: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Fused eq.-(4) aggregation over flattened parameters:
    theta [N] + sum_k coeffs[k] * deltas[k] ([K, N]), in theta's dtype."""
    with _aggregate_region("fl_aggregate", [theta], [deltas]):
        if theta.is_meta:
            return torch.empty_like(theta)
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
    with _aggregate_region("fl_aggregate", thetas, deltas):
        if thetas[0].is_meta:
            return [torch.empty_like(t) for t in thetas]
        if use_cuda_kernel(impl, thetas[0].device):
            from repro_torch.kernels.fl_aggregate import (
                fl_aggregate_leaves_cuda)
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
    with _aggregate_region("fl_aggregate_lanes", thetas, deltas):
        if thetas[0].is_meta:
            return [torch.empty_like(t) for t in thetas]
        if use_cuda_kernel(impl, thetas[0].device):
            from repro_torch.kernels.fl_aggregate import (
                fl_aggregate_lanes_cuda)
            return fl_aggregate_lanes_cuda(thetas, deltas, coeffs)
        return ref.aggregate_lanes_reference(thetas, deltas, coeffs)


def fl_delta_reduce(deltas: torch.Tensor, coeffs: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
    """Partial eq.-(4) reduce ``sum_k coeffs[k] * deltas[k]`` -> f32 [N]
    (no theta add): the per-shard term of a client-sharded aggregation."""
    with _reduce_region([deltas], [deltas[0]]):
        if deltas.is_meta:
            return torch.empty(deltas.shape[1:], dtype=torch.float32,
                               device="meta")
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
    with _reduce_region(deltas, outs):
        if deltas[0].is_meta:
            return list(outs)
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
    from repro_torch.kernels import flash_attention as fa
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              return_lse=return_lse)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]

    def work():
        pairs = b * h * fa.visible_pairs(sq, sk, causal, window)
        return (4.0 * d * pairs,
                2 * (b * h * sq * d + b * hkv * sk * d) * q.element_size()
                + (4 * b * h * sq if return_lse else 0),
                pairs * (2 if softcap > 0 else 1))

    with op_cost.kernel("flash_attention", q.device, work):
        if q.is_meta:
            out = torch.empty_like(q)
            if not return_lse:
                return out
            return out, torch.empty((b, h, sq), dtype=torch.float32,
                                    device="meta")
        if use_cuda_kernel(impl, q.device):
            return fa.flash_attention_cuda(q, k, v, **kw)
        return ref.mha_reference(q, k, v, **kw)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int,
              impl: str = "auto"):
    """Intra-chunk SSD: x [B, S, nh, hd], dt [B, S, nh], a_log [nh],
    b_in/c_in [B, S, N] -> (y_diag [B, S, nh, hd], states
    [B, nc, nh, hd, N] f32)."""
    from repro_torch.kernels import ssd_scan
    b, s, nh, hd = x.shape
    n = b_in.shape[-1]
    nc = s // chunk

    def work():
        return (ssd_scan.ssd_chunk_flops(b, s, nh, hd, n, chunk),
                (2 * b * s * nh * hd + b * s * nh + nh + 2 * b * s * n)
                * x.element_size() + b * nc * nh * hd * n * 4, 0.0)

    with op_cost.kernel("ssd_chunk", x.device, work):
        if x.is_meta:
            return (torch.empty_like(x),
                    torch.empty((b, nc, nh, hd, n), dtype=torch.float32,
                                device="meta"))
        if use_cuda_kernel(impl, x.device):
            return ssd_scan.ssd_chunk_cuda(x, dt, a_log, b_in, c_in,
                                           chunk=chunk)
        return ref.ssd_chunk_batched_reference(x, dt, a_log, b_in, c_in,
                                               chunk)
