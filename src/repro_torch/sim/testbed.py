"""The paper's FL testbed as the drivers build it: the counterpart of the
JAX package's ``benchmarks/common.py`` (scaled down by default so a run
finishes on a CPU; ``BenchConfig.paper_scale()`` is the 120-device
configuration).  The data layer is the port's numpy copy, so the client
arrays, the test split and the sizes are bitwise the reference's;
``SystemParams`` and the trainer live on the requested device.

    from repro_torch.sim.testbed import BenchConfig, run_controller
    result = run_controller("lroa", BenchConfig(rounds=5), device="cpu")
"""

from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core import (DivFLController, LROAController,
                              UniformDynamicController,
                              UniformStaticController, estimate_hyperparams,
                              paper_default_params)
from repro_torch.data import (dirichlet_partition, make_client_datasets,
                              synthetic_image_classification,
                              train_test_split)
from repro_torch.fl import (ChannelConfig, ChannelProcess, ClientConfig,
                            FederatedTrainer)
from repro_torch.models import CNNTask, MLPTask
from repro_torch.optim import paper_step_decay

CONTROLLERS = {
    "lroa": LROAController,
    "uni_d": UniformDynamicController,
    "uni_s": UniformStaticController,
    "divfl": DivFLController,
}


@dataclasses.dataclass
class BenchConfig:
    num_devices: int = 20
    rounds: int = 30
    sample_count: int = 2
    local_epochs: int = 2
    batch_size: int = 16
    num_classes: int = 4
    image_shape: tuple = (8, 8, 1)
    examples: int = 2500
    lr: float = 0.1
    mu: float = 1.0
    nu: float = 1e5
    seed: int = 0
    use_cnn: bool = False

    @classmethod
    def paper_scale(cls) -> "BenchConfig":
        return cls(num_devices=120, rounds=2000, examples=50_000,
                   num_classes=10, image_shape=(32, 32, 3), use_cnn=True)


def build_testbed(cfg: BenchConfig, device="cuda"):
    """``(SystemParams on device, task, client_data, (x_test, y_test))``,
    as ``benchmarks.common.build_testbed`` returns them."""
    x, y = synthetic_image_classification(
        cfg.examples, cfg.image_shape, cfg.num_classes, noise=0.3,
        seed=cfg.seed)
    (xtr, ytr), (xte, yte) = train_test_split(x, y, 0.15, seed=cfg.seed + 1)
    parts = dirichlet_partition(ytr, cfg.num_devices, 0.5, seed=cfg.seed + 2)
    client_data = make_client_datasets(xtr, ytr, parts)
    sizes = np.asarray([len(p) for p in parts], np.float32)
    params = paper_default_params(
        num_devices=cfg.num_devices, sample_count=cfg.sample_count,
        local_epochs=cfg.local_epochs, data_sizes=sizes, device=device)
    if cfg.use_cnn:
        task = CNNTask(image_shape=cfg.image_shape,
                       num_classes=cfg.num_classes)
    else:
        task = MLPTask(input_dim=int(np.prod(cfg.image_shape)),
                       num_classes=cfg.num_classes, hidden=32)
    return params, task, client_data, (xte, yte)


def make_trainer(name: str, cfg: BenchConfig, *, mu=None, nu=None,
                 sample_count=None, device="cuda") -> FederatedTrainer:
    """Build the testbed and a trainer under controller ``name`` (a key of
    :data:`CONTROLLERS`) on ``device`` without running it."""
    if sample_count is not None:
        cfg = dataclasses.replace(cfg, sample_count=sample_count)
    params, task, client_data, test = build_testbed(cfg, device=device)
    hp = estimate_hyperparams(params, 0.1, loss_scale=1.5,
                              mu=mu if mu is not None else cfg.mu,
                              nu=nu if nu is not None else cfg.nu)
    controller = CONTROLLERS[name](params, hp)
    return FederatedTrainer(
        task, params, controller,
        ChannelProcess(cfg.num_devices, ChannelConfig(seed=cfg.seed)),
        client_data,
        ClientConfig(local_epochs=cfg.local_epochs,
                     batch_size=cfg.batch_size),
        paper_step_decay(cfg.lr, cfg.rounds),
        test_data=test, eval_every=max(cfg.rounds // 6, 1), seed=cfg.seed,
        device=device)


def run_controller(name: str, cfg: BenchConfig, *, mu=None, nu=None,
                   sample_count=None, verbose=False, device="cuda"):
    trainer = make_trainer(name, cfg, mu=mu, nu=nu,
                           sample_count=sample_count, device=device)
    return trainer.run(cfg.rounds, verbose=verbose)
