"""Server-side FL logic: sampling K-with-replacement and the unbiased
aggregation rule (paper eq. (4)) — the port of ``repro.fl.server``.

    theta^{t+1} = theta^t
                  + sum_{n in K^t} w_n / (K q_n^t) (theta_n^{t,E} - theta^t)

Parameters are ``dict[str, Tensor]``; stacked client deltas carry a
leading ``[K, ...]`` axis on every leaf.

* ``sample_clients`` / ``aggregation_weights`` are numpy, verbatim from
  the JAX package, so the same ``np.random.Generator`` state gives the
  same selection.
* ``aggregate_stacked`` is the plain form: a broadcast-multiply plus a
  sum over the client axis in f32, per leaf; ``aggregate`` (the list
  API of the sequential path) stacks K update dicts and takes it, on
  every device, as the JAX package computes it in jnp outside any
  kernel.
* ``aggregate_fused`` is the round engine's path.  On a CUDA device the
  hand-written ``fl_aggregate`` kernel reads every leaf where it lies, in
  one launch (no ravel, no unravel); on the CPU it is the same per-leaf
  arithmetic as ``aggregate_stacked`` (the JAX package's off-TPU
  branch), which the tests hold against the reference.
* ``aggregate_fused_lanes`` is the scenario arena's round: the eq.-(4)
  step of S lanes of one model (``[S, ...]`` params, ``[S, K, ...]``
  deltas, ``[S, K]`` coeffs), one lane-batched ``fl_aggregate`` launch
  on a CUDA device, and on the CPU :func:`aggregate_fused`'s arithmetic
  per lane.
* ``aggregate_hierarchical`` is eq. (4) as a cluster-then-global
  reduce (the scale plane's routing, ``index_add_`` for the segment
  sum); plain PyTorch on every device, as the JAX package's
  ``segment_sum`` form is plain XLA.
* ``aggregate_fused_psum`` / ``aggregate_hierarchical_psum`` are the
  client-sharded forms (the JAX package's ``shard_map`` bodies, here one
  ``torch.distributed`` rank per shard over ``launch.mesh``): each rank
  reduces its slice of the client axis (one ``fl_delta_reduce`` launch
  over its leaves on a CUDA device, into views of one flat f32 buffer;
  or ``[C, ...]`` cluster partials), ONE ``all_reduce`` sums the flat
  buffer over the mesh axis, and theta is added once per leaf.  Every
  rank receives the same sum, so the params stay bitwise replicated;
  with one rank each is bitwise its unsharded form (the same order of
  arithmetic: the sum, then theta).
* ``ParamRavel`` is the JAX package's flat-vector adapter, kept for the
  flat entry points (``ops.fl_aggregate``, ``ops.fl_delta_reduce``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as mesh_lib

Params = Dict[str, torch.Tensor]


def sample_clients(rng: np.random.Generator, q: np.ndarray,
                   sample_count: int) -> np.ndarray:
    """Draw K client indices with replacement according to q (Alg. 1, l.5)."""
    q = np.asarray(q, np.float64)
    q = q / q.sum()
    return rng.choice(q.shape[0], size=sample_count, replace=True, p=q)


def aggregation_weights(selected: np.ndarray, q: np.ndarray, w: np.ndarray,
                        sample_count: int) -> np.ndarray:
    """Per-draw coefficients w_n / (K q_n) for the selected multiset."""
    sel = np.asarray(selected)
    return (np.asarray(w)[sel] /
            (float(sample_count) * np.asarray(q)[sel])).astype(np.float32)


def stack_deltas(deltas: Sequence[Params]) -> Params:
    """List of K update dicts -> one dict with leading [K, ...] leaves."""
    return {name: torch.stack([d[name] for d in deltas])
            for name in deltas[0]}


def aggregate_stacked(global_params: Params, stacked_deltas: Params,
                      coeffs: torch.Tensor) -> Params:
    """eq. (4) over deltas stacked on a leading K axis: per leaf,
    ``p + sum_k c_k d_k`` as a broadcast-multiply and a sum over axis 0,
    in f32, cast back to the leaf's dtype."""
    names = list(global_params)
    return dict(zip(names, ref.aggregate_leaves_reference(
        [global_params[n] for n in names],
        [stacked_deltas[n] for n in names], coeffs)))


def aggregate(global_params: Params, deltas: Sequence[Params],
              coeffs: np.ndarray) -> Params:
    """theta + sum_i coeff_i * delta_i — eq. (4), the list API: stacks
    onto a client axis and reduces as :func:`aggregate_stacked`."""
    device = next(iter(global_params.values())).device
    return aggregate_stacked(global_params, stack_deltas(deltas),
                             torch.as_tensor(np.asarray(coeffs, np.float32),
                                             device=device))


class ParamRavel:
    """Ravel/unravel adapter between a params dict and one flat vector.

    Built once from a template dict (names in sorted order, as JAX
    flattens a dict; shapes; dtypes).  ``ravel`` concatenates every leaf
    (cast to f32) into one ``[N]`` vector for the flat kernel entry
    points, ``ravel_stacked`` maps ``[K, ...]`` leaves to ``[K, N]``, and
    ``unravel`` splits, reshapes and casts back.
    """

    def __init__(self, template: Params):
        self.names = sorted(template)
        self.shapes = [tuple(template[n].shape) for n in self.names]
        self.dtypes = [template[n].dtype for n in self.names]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.cumsum([0] + self.sizes).tolist()
        self.total = self.offsets[-1]

    def ravel(self, tree: Params) -> torch.Tensor:
        return torch.cat([tree[n].to(torch.float32).reshape(-1)
                          for n in self.names])

    def ravel_stacked(self, tree: Params) -> torch.Tensor:
        k = tree[self.names[0]].shape[0]
        return torch.cat([tree[n].to(torch.float32).reshape(k, -1)
                          for n in self.names], dim=1)

    def unravel(self, vec: torch.Tensor) -> Params:
        return {n: vec[self.offsets[i]:self.offsets[i + 1]]
                .reshape(self.shapes[i]).to(self.dtypes[i])
                for i, n in enumerate(self.names)}


def aggregate_fused(global_params: Params, stacked_deltas: Params,
                    coeffs: torch.Tensor, impl: str = "auto",
                    adapter: ParamRavel | None = None) -> Params:
    """eq. (4) through the fused kernel on CUDA.

    On a CUDA device (``impl`` 'auto' or 'cuda') the leaves, in
    ``ParamRavel``'s sorted-name order (``adapter.names`` when given),
    go to ONE ``fl_aggregate`` kernel launch that reads each where it
    lies (up to 64 leaves of one dtype pair per launch); on the CPU the
    same per-leaf arithmetic as :func:`aggregate_stacked` runs.
    ``impl='cuda'`` on CPU tensors raises (see ``kernels.ops``).
    """
    device = next(iter(global_params.values())).device
    coeffs = coeffs.to(device=device, dtype=torch.float32).contiguous()
    names = adapter.names if adapter is not None else sorted(global_params)
    return dict(zip(names, ops.fl_aggregate_leaves(
        [global_params[n] for n in names],
        [stacked_deltas[n] for n in names], coeffs, impl=impl)))


def _flat_views(buffer: torch.Tensor, shapes) -> list:
    """Contiguous views of ``buffer`` with the given shapes, in order."""
    views, off = [], 0
    for shape in shapes:
        size = int(np.prod(shape)) if shape else 1
        views.append(buffer[off:off + size].view(shape))
        off += size
    return views


def aggregate_fused_psum(global_params: Params, stacked_deltas: Params,
                         coeffs: torch.Tensor, mesh, axis_name: str = "data",
                         impl: str = "auto") -> Params:
    """Mesh-sharded eq. (4): per-rank partial reduce, one cross-rank sum.

    ``stacked_deltas`` holds this rank's slice ``[K/shards, ...]`` of
    the client axis and ``coeffs`` the matching ``[K/shards]``.  The
    rank's partial ``sum_k c_k d_k`` of every leaf (sorted names) is
    written in f32 into views of ONE flat buffer
    by one ``ops.fl_delta_reduce_leaves`` call (one kernel launch per
    table of leaves on a CUDA device, the broadcast-multiply and sum on
    the CPU), the buffer is summed over ``axis_name`` by one
    ``all_reduce``, and theta is added once per leaf in f32 and cast to
    its dtype."""
    device = next(iter(global_params.values())).device
    coeffs = coeffs.to(device=device, dtype=torch.float32).contiguous()
    names = sorted(global_params)
    shapes = [tuple(global_params[n].shape) for n in names]
    flat = torch.empty(sum(int(np.prod(s)) if s else 1 for s in shapes),
                       dtype=torch.float32, device=device)
    parts = _flat_views(flat, shapes)
    ops.fl_delta_reduce_leaves([stacked_deltas[n] for n in names], coeffs,
                               outs=parts, impl=impl)
    mesh_lib.all_reduce_sum_(flat, mesh, axis_name)
    return {n: (global_params[n].to(torch.float32) + parts[i]).to(
        global_params[n].dtype) for i, n in enumerate(names)}


def aggregate_fused_lanes(params_stacked: Params, deltas_stacked: Params,
                          coeffs: torch.Tensor, impl: str = "auto"
                          ) -> Params:
    """eq. (4) for S lanes at once: per leaf and lane s,
    ``params_stacked[n][s] + sum_k coeffs[s, k] * deltas_stacked[n][s, k]``.

    On a CUDA device the leaves (sorted names) of every lane go to ONE
    lane-batched ``fl_aggregate`` launch per table of (lane, leaf)
    segments; on the CPU lane s is :func:`aggregate_fused` on lane s's
    tensors, bit for bit.  ``impl='cuda'`` on CPU tensors raises."""
    device = next(iter(params_stacked.values())).device
    coeffs = coeffs.to(device=device, dtype=torch.float32).contiguous()
    names = sorted(params_stacked)
    return dict(zip(names, ops.fl_aggregate_lanes(
        [params_stacked[n] for n in names],
        [deltas_stacked[n] for n in names], coeffs, impl=impl)))


def aggregate_hierarchical(global_params: Params, stacked_deltas: Params,
                           coeffs: torch.Tensor, cluster_sel: torch.Tensor,
                           num_clusters: int) -> Params:
    """eq. (4) as cluster partials, then one global sum.

    ``cluster_sel[k]`` names the cluster of the k-th selected client; per
    leaf the weighted deltas ``c_k d_k`` (f32) are summed into
    ``[num_clusters, ...]`` partials with ``index_add_``, the partials
    summed over the cluster axis and added to theta in f32, then cast to
    theta's dtype.  The same sum as :func:`aggregate_stacked`,
    reassociated: equal to it within f32 resolution, not bitwise."""
    device = next(iter(global_params.values())).device
    coeffs = coeffs.to(device=device, dtype=torch.float32)
    sel = cluster_sel.to(device=device, dtype=torch.int64)
    out = {}
    for name, p in global_params.items():
        d = stacked_deltas[name].to(torch.float32)
        c = coeffs.reshape((-1,) + (1,) * (d.dim() - 1))
        partials = torch.zeros((num_clusters,) + tuple(d.shape[1:]),
                               dtype=torch.float32, device=device)
        partials.index_add_(0, sel, c * d)
        out[name] = (p.to(torch.float32) + partials.sum(dim=0)).to(p.dtype)
    return out


def aggregate_hierarchical_psum(global_params: Params,
                                stacked_deltas: Params, coeffs: torch.Tensor,
                                cluster_sel: torch.Tensor, num_clusters: int,
                                mesh, axis_name: str = "data") -> Params:
    """Mesh-sharded :func:`aggregate_hierarchical`: each rank sums its
    slice of the client axis into ``[num_clusters, ...]`` f32 partials
    per leaf (``index_add_``), every leaf's partials packed into one flat
    buffer, ONE ``all_reduce`` over ``axis_name`` (the traffic is cluster
    rows, not client rows), then per leaf the cluster axis summed and
    added to theta."""
    device = next(iter(global_params.values())).device
    coeffs = coeffs.to(device=device, dtype=torch.float32)
    sel = cluster_sel.to(device=device, dtype=torch.int64)
    names = list(global_params)
    shapes = [(num_clusters,) + tuple(global_params[n].shape) for n in names]
    flat = torch.zeros(sum(int(np.prod(s)) for s in shapes),
                       dtype=torch.float32, device=device)
    parts = _flat_views(flat, shapes)
    for name, part in zip(names, parts):
        d = stacked_deltas[name].to(torch.float32)
        c = coeffs.reshape((-1,) + (1,) * (d.dim() - 1))
        part.index_add_(0, sel, c * d)
    mesh_lib.all_reduce_sum_(flat, mesh, axis_name)
    return {n: (global_params[n].to(torch.float32) + parts[i].sum(dim=0)).to(
        global_params[n].dtype) for i, n in enumerate(names)}


def fedavg_reference(global_params: Params, deltas: Sequence[Params],
                     w_sel: np.ndarray) -> Params:
    """Plain FedAvg (weights proportional to data sizes) for comparison."""
    coeffs = np.asarray(w_sel, np.float32)
    coeffs = coeffs / coeffs.sum()
    device = next(iter(global_params.values())).device
    return aggregate_stacked(global_params, stack_deltas(deltas),
                             torch.as_tensor(coeffs, device=device))
