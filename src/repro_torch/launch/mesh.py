"""The meshes over ``torch.distributed`` and the card's roofline
constants — the port of ``repro.launch.mesh``.

A JAX ``shard_map`` over a 1-D ``("data",)`` mesh becomes SPMD
processes, one rank per shard.  :func:`make_fl_mesh` returns a 1-D
``torch.distributed.device_mesh.DeviceMesh`` named ``("data",)`` over
the initialised process group; the axis NAME is the contract, as in the
reference, and two consumers share it:

* the round engine splits the K sampled slots (and the client bank its
  N rows) over ``data`` — ``RoundEngine(mesh=)``;
* the scenario arena splits its lanes over ``data``, whole rollouts per
  rank — ``Arena(mesh=)``, over a mesh-free engine.

Everything that talks to the group goes through the helpers here
(:func:`axis_size`, :func:`axis_rank`, :func:`axis_group` and the
collectives :func:`all_reduce_sum_`, :func:`all_gather_cat`,
:func:`all_to_all_rows`): the engine, the banks and the arena never call
``torch.distributed`` themselves.

The backend is the caller's: NCCL for one rank per card, gloo for the
CPU tests (and for several ranks sharing one card, which NCCL refuses).
Gloo takes CUDA tensors for the three collectives used here
(``all_reduce``, ``all_gather``, ``all_to_all_single``; checked on an
H100 with torch 2.11), so no exchange is staged through host memory by
this module.  Nothing here turns a mesh into ``None`` or moves work to
the CPU: a missing group, a size that differs from it, or a mesh
without the axis raises.

Each collective records a ``launch.roofline.CollectiveOp`` with an
active ``launch.op_cost.OpCounter`` (the reference reads its collectives
off the HLO).  :func:`make_production_mesh` is the reference's pod mesh,
``(16, 16)`` over ``("data", "model")`` or ``(2, 16, 16)`` over
``("pod", "data", "model")``, over a world of that many ranks that
exists (the reference forces 512 placeholder host devices; the port's
dry run counts one device's step and needs no mesh).

The roofline constants are the H100 SXM's, from NVIDIA's H100 Tensor
Core GPU data sheet (dense rates, without sparsity): 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s of HBM3,
and NVLink's 900 GB/s as 450 GB/s per direction (the counterpart of the
reference's per-link ``ICI_BW``).  The card every chip run of this repo
measured on is an NVIDIA H100 80GB HBM3 with a 700 W power limit
(``nvidia-smi``); ``chip_smoke.py``'s ``PEAKS`` row for it holds the same
numbers.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

#: the axis name both consumers shard over
AXIS = "data"

# Roofline hardware constants (H100 SXM, per card; module docstring)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12          # FLOP/s, CUDA cores
HBM_BW = 3.35e12                # bytes/s
LINK_BW = 450e9                 # bytes/s, NVLink per direction


def _device_mesh_cls():
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh


def make_fl_mesh(num_shards: int | None = None, device_type: str = "cuda",
                 device=None):
    """1-D ``("data",)`` mesh over every rank of the initialised process
    group (its size the world size; ``num_shards``, when given, must
    equal it).

    On ``device_type='cuda'`` the process's current device is set first:
    ``device`` when the caller names one (several ranks may share a
    card under gloo), else ``cuda:LOCAL_RANK`` as ``torchrun`` sets it.
    Raises when no process group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_fl_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group with its "
                           "backend, rank and world size)")
    world = dist.get_world_size()
    shards = world if num_shards is None else int(num_shards)
    if shards != world:
        raise ValueError(f"num_shards={shards} differs from the process "
                         f"group's world size {world} (one rank per shard)")
    if device_type == "cuda":
        dev = (torch.device(device) if device is not None else
               torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
        if dev.type != "cuda":
            raise ValueError(f"device_type 'cuda' with device {dev}")
        torch.cuda.set_device(dev)
    return _device_mesh_cls()(device_type, list(range(shards)),
                              mesh_dim_names=(AXIS,))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's pod mesh: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``
    with ``multi_pod``, as a ``DeviceMesh`` over the initialised process
    group, whose world size must be 256 (512).  Raises without a group
    or when its size differs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_production_mesh needs an initialised "
                           "process group of one rank per device")
    size = 1
    for d in shape:
        size *= d
    if dist.get_world_size() != size:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs "
                         f"{size} ranks; the process group has "
                         f"{dist.get_world_size()}")
    return _device_mesh_cls()(device_type,
                              torch.arange(size).reshape(shape),
                              mesh_dim_names=axes)


def make_host_mesh():
    """A one-rank CPU ``("data",)`` mesh for the CPU tests.  Without an
    initialised group it initialises a one-rank gloo world over an
    in-process store (no socket, no file); a group of more ranks
    raises (use :func:`make_fl_mesh`)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"make_host_mesh is the one-rank mesh; the group "
                         f"has {dist.get_world_size()} ranks")
    return _device_mesh_cls()("cpu", [0], mesh_dim_names=(AXIS,))


def check_mesh(mesh, axis: str = AXIS):
    """``mesh`` if it is a ``DeviceMesh`` with the axis ``axis``, else
    raise."""
    if not isinstance(mesh, _device_mesh_cls()):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_fl_mesh), got "
                        f"{type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (its axes: {names})")
    return mesh


def axis_size(mesh, axis: str = AXIS) -> int:
    """Ranks along ``axis``."""
    check_mesh(mesh, axis)
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_rank(mesh, axis: str = AXIS) -> int:
    """This process's coordinate along ``axis``."""
    check_mesh(mesh, axis)
    return int(mesh.get_local_rank(axis))


def axis_group(mesh, axis: str = AXIS):
    """The process group of ``axis``."""
    check_mesh(mesh, axis)
    return mesh.get_group(axis)


def all_reduce_sum_(t: torch.Tensor, mesh, axis: str = AXIS
                    ) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (every rank receives the same
    bits); returns ``t``."""
    dist.all_reduce(t, group=axis_group(mesh, axis))
    _record("all-reduce", t, mesh, axis)
    return t


def all_gather_cat(t: torch.Tensor, mesh, axis: str = AXIS) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along
    dim 0 in rank order."""
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(outs, t, group=axis_group(mesh, axis))
    out = torch.cat(outs)
    _record("all-gather", out, mesh, axis)
    return out


def all_to_all_rows(send: torch.Tensor, send_counts: Sequence[int],
                    recv_counts: Sequence[int], mesh, axis: str = AXIS
                    ) -> torch.Tensor:
    """One exchange of rows: ``send`` holds ``send_counts[r]`` rows for
    rank r, in rank order; returns the ``sum(recv_counts)`` rows received,
    ``recv_counts[r]`` of them from rank r, in rank order.  Every rank
    must know both count lists (no handshake)."""
    send = send.contiguous()
    recv = send.new_empty((int(sum(recv_counts)),) + tuple(send.shape[1:]))
    dist.all_to_all_single(recv, send, [int(c) for c in recv_counts],
                           [int(c) for c in send_counts],
                           group=axis_group(mesh, axis))
    _record("all-to-all", recv, mesh, axis)
    return recv


def _record(kind: str, result: torch.Tensor, mesh, axis: str) -> None:
    """Tell an active op counter of one collective (its result's bytes
    over the axis's group)."""
    from repro_torch.launch import op_cost
    op_cost.record_collective(kind, result.numel() * result.element_size(),
                              axis_size(mesh, axis))


def contiguous_block(count: int, mesh, axis: str = AXIS) -> Tuple[int, int]:
    """``(start, stop)`` of this rank's contiguous block of ``count``
    items split evenly over ``axis`` (``count`` a multiple of its
    size)."""
    size, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
    per = count // size
    return rank * per, (rank + 1) * per
