"""The bridge from the LM zoo to the LROA system model, ported from
``repro.core.arch_bridge``.

The paper's scheduler sees a model only through (a) the update size M in
bits and (b) the CPU cycles per sample c_n.  For each architecture both
come from its ``ModelConfig``: M from the (active) parameter count times
the wire precision, c_n from the training FLOPs per sample (6 N_active s
for an LM over s tokens) times a cycles-per-FLOP efficiency.  So LROA
schedules each family's workload through this one interface.  The numbers
are Python floats computed as the JAX package computes them, so bits and
cycles are equal; the per-device fields become float32 tensors on the
caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import system_model as sm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class EdgeProfile:
    """How the edge fleet trains the model (the paper's Sec. VII
    defaults)."""
    num_devices: int = 120
    sample_count: int = 2
    local_epochs: int = 2
    seq_len: int = 512              # tokens per training sample on-device
    wire_bits: int = 16             # bf16 updates (the paper used 32)
    cycles_per_flop: float = 0.5    # edge NPU efficiency (MACs/cycle ~ 1)
    energy_budget_j: float = 15.0
    upload_only_active: bool = True  # MoE: send only touched experts


def cycles_per_sample(cfg: ModelConfig, profile: EdgeProfile) -> float:
    """c_n = training FLOPs per sample (6 N_active s) x cycles per FLOP."""
    flops = 6.0 * cfg.active_param_count() * profile.seq_len
    return flops * profile.cycles_per_flop


def update_bits(cfg: ModelConfig, profile: EdgeProfile) -> float:
    """M: the bits a client uploads per round (eq. 6)."""
    n = cfg.active_param_count() if profile.upload_only_active \
        else cfg.param_count()
    return float(n) * profile.wire_bits


def system_params_for_arch(cfg: ModelConfig,
                           profile: EdgeProfile = EdgeProfile(),
                           data_sizes: Optional[np.ndarray] = None,
                           seed: int = 0,
                           device="cuda") -> sm.SystemParams:
    """``SystemParams`` on ``device`` whose compute and communication load
    matches ``cfg``; ``data_sizes`` default to the JAX package's draw
    (numpy, ``seed``)."""
    n = profile.num_devices
    if data_sizes is None:
        rng = np.random.default_rng(seed)
        data_sizes = rng.integers(64, 512, n).astype(np.float32)
    ones = np.ones((n,), np.float32)

    def arr(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float32), device=device)

    return sm.SystemParams(
        num_devices=n,
        sample_count=profile.sample_count,
        local_epochs=profile.local_epochs,
        bandwidth_hz=1.0e6,
        noise_power=0.01,
        model_bits=update_bits(cfg, profile),
        download_rate=1.0e7,
        cycles_per_sample=arr(float(cycles_per_sample(cfg, profile)) * ones),
        data_sizes=arr(data_sizes),
        capacitance=arr(2.0e-28 * ones),
        energy_budget=arr(profile.energy_budget_j * ones),
        f_min=arr(1.0e9 * ones),
        f_max=arr(2.0e9 * ones),
        p_min=arr(1.0e-3 * ones),
        p_max=arr(0.1 * ones),
    )
