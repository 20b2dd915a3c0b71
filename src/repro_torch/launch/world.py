"""Spawned worlds of ranks on one machine: :func:`run_world` starts one
process per rank (``torch.multiprocessing``, spawn), each running
``job(payload, rank=r, world_size=W)`` inside an initialised process
group, and returns every rank's result.

    results = run_world(my_module.job, 2, backend="gloo", workdir=tmp,
                        payload={"seed": 0}, timeout=120)

``job`` is a module-level function (each rank imports its module; keep
what it returns to numpy and Python values).  The group is initialised
over ``file://<workdir>/rendezvous`` (a file, so concurrent worlds never
race for a port) with ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` set as
``torchrun`` sets them.  ``timeout`` is the deadline of the rendezvous,
of every collective and of the join: a rank that raises or exits
non-zero, or a world that outlives the deadline, kills every rank still
running and raises.  Nothing is caught and nothing runs in a rank's
place.

On several cards one rank per card under NCCL is ``torchrun
--nproc-per-node <cards>`` on a script that calls
``init_process_group("nccl")`` and ``launch.mesh.make_fl_mesh()``; this
module is what the tests (gloo on the CPU) and ``chip_smoke.py``
(several gloo ranks on one card, one NCCL rank) use.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
from pathlib import Path
from typing import Any, Callable, List


def _rank(rank: int, job: Callable, world_size: int, backend: str,
          workdir: str, payload: bytes, timeout: float) -> None:
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    dist.init_process_group(backend, init_method=f"file://{workdir}/"
                            "rendezvous", rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    result = job(pickle.loads(payload), rank=rank, world_size=world_size)
    Path(workdir, f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    dist.destroy_process_group()


def run_world(job: Callable, world_size: int, *, backend: str, workdir,
              payload: Any = None, timeout: float = 300.0) -> List[Any]:
    """Run ``job`` on ``world_size`` ranks and return their results in
    rank order.  Raises (the rank's own error, or ``TimeoutError`` at
    the deadline) after killing every rank."""
    import torch.multiprocessing as mp

    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "rendezvous").unlink(missing_ok=True)
    ctx = mp.start_processes(
        _rank, args=(job, world_size, backend, str(workdir),
                     pickle.dumps(payload), float(timeout)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + float(timeout)
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} {backend} ranks outlived "
                                   f"their {timeout} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [pickle.loads((workdir / f"rank{r}.pkl").read_bytes())
            for r in range(world_size)]
