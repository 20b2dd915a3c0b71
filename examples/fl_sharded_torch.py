"""Algorithm 1 under LROA with the client axis sharded over ranks, in the
PyTorch port (``repro_torch``): every rank builds the same
``FederatedTrainer(mesh=...)``; the bank's rows split over the ranks, each
round's K slots train K/ranks per rank, and one ``all_reduce`` sums the
ranks' eq.-(4) partials (one ``fl_delta_reduce`` launch a rank on the
card).  Each rank writes a flight-recorder file (``JsonlSink``); rank 0
prints its rounds and exports its Chrome trace.

One rank per card under NCCL:

    PYTHONPATH=src torchrun --nproc-per-node 4 examples/fl_sharded_torch.py

Two gloo ranks on the CPU (K must divide by the ranks):

    PYTHONPATH=src torchrun --nproc-per-node 2 \\
        examples/fl_sharded_torch.py --device cpu [--rounds 4]
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (LROAController, estimate_hyperparams,
                              paper_default_params)
from repro_torch.data import (dirichlet_partition, make_client_datasets,
                              synthetic_image_classification)
from repro_torch.fl import (ChannelConfig, ChannelProcess, ClientConfig,
                            FederatedTrainer)
from repro_torch.launch.mesh import make_fl_mesh
from repro_torch.models import CNNTask
from repro_torch.obs import trace
from repro_torch.optim import paper_step_decay


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--devices", type=int, default=24)
    ap.add_argument("--sample-count", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (NCCL, cuda:LOCAL_RANK) or 'cpu' (gloo)")
    ap.add_argument("--logdir", default="runlogs/fl_sharded")
    args = ap.parse_args(argv)

    on_card = args.device == "cuda"
    dist.init_process_group("nccl" if on_card else "gloo")
    mesh = make_fl_mesh(device_type="cuda" if on_card else "cpu")
    rank = dist.get_rank()
    device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
              if on_card else torch.device("cpu"))

    n = args.devices
    x, y = synthetic_image_classification(40 * n, (16, 16, 3), 10, seed=0)
    parts = dirichlet_partition(y, n, 0.5, seed=2)
    clients = make_client_datasets(x, y, parts)
    sp = paper_default_params(
        num_devices=n, sample_count=args.sample_count,
        data_sizes=np.asarray([len(p) for p in parts], np.float32),
        device=device)
    sink = trace.install_sink(trace.JsonlSink(
        os.path.join(args.logdir, f"rank{rank}.jsonl")))
    trainer = FederatedTrainer(
        CNNTask(image_shape=(16, 16, 3), num_classes=10, width=8), sp,
        LROAController(sp, estimate_hyperparams(sp, 0.1, loss_scale=1.5)),
        ChannelProcess(n, ChannelConfig(seed=0)), clients,
        ClientConfig(batch_size=16), paper_step_decay(0.1, args.rounds),
        device=device, mesh=mesh)
    for t in range(args.rounds):
        rec = trainer.run_round(t)
        if rank == 0:
            print(f"round {t}: clients {rec.selected} loss "
                  f"{rec.mean_loss:.4f} modelled {rec.wall_time:.1f} s",
                  flush=True)
    trace.remove_sink(sink)
    sink.close()
    if rank == 0:
        path = trace.export_chrome_trace(
            trace.load_jsonl(sink.path),
            os.path.join(args.logdir, "rank0.chrome.json"), "rank 0")
        print(f"bank bytes on rank 0: {trainer.bank.nbytes}; trace: {path}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
