"""Edge-device system model for FL over mobile edge networks.

The communication/computation time and energy model of the paper
(Sections III-C .. III-F, eqs. (5)-(17)) as vectorised torch functions over
the device dimension ``[N]`` — the port of ``repro.core.system_model``.

Conventions
-----------
* All per-device quantities are 1-D float32 tensors of shape ``[N]`` on the
  device the :class:`SystemParams` lives on.
* ``M`` is the model-update size in **bits** (the paper uses M = 32 d bits).
* Rates are bits/second; times are seconds; energies are Joules.
* Scalars (``V``, ``lam``, ``K``, bandwidth, noise) stay Python numbers, so
  every product with a tensor is computed in float32, as in the JAX
  package.
* ``k`` (optional, every K-parameterised function takes it) replaces the
  static ``params.sample_count`` with K as data: a scalar or an ``[N]``
  float32 tensor (``RoundEngine.run_scan`` passes ``kvec``, the rollout's
  true K broadcast to ``[N]``, as the JAX package's scan does).
  ``k=None`` reads ``params.sample_count``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: the per-device ``[N]`` tensor fields of :class:`SystemParams`
ARRAY_FIELDS = ("cycles_per_sample", "data_sizes", "capacitance",
                "energy_budget", "f_min", "f_max", "p_min", "p_max")


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """Static parameters of the FL edge system (paper Table I).

    Per-device fields are float32 tensors of shape ``[N]`` on one device;
    the rest are Python scalars.
    """

    num_devices: int                 # N
    sample_count: int                # K — sampling frequency (draws/round)
    local_epochs: int                # E
    bandwidth_hz: float              # B — total uplink bandwidth (Hz)
    noise_power: float               # N0 — background noise power (W)
    model_bits: float                # M — model update size in bits
    download_rate: float             # r_{n,d} — downlink rate (bits/s)
    cycles_per_sample: torch.Tensor  # c_n
    data_sizes: torch.Tensor         # D_n (samples)
    capacitance: torch.Tensor        # alpha_n
    energy_budget: torch.Tensor      # \bar{E}_n (J / round, time-averaged)
    f_min: torch.Tensor
    f_max: torch.Tensor
    p_min: torch.Tensor
    p_max: torch.Tensor

    def __post_init__(self):
        devices = set()
        for name in ARRAY_FIELDS:
            arr = getattr(self, name)
            if not isinstance(arr, torch.Tensor):
                raise TypeError(f"SystemParams.{name} must be a tensor, got "
                                f"{type(arr).__name__}")
            if tuple(arr.shape) != (self.num_devices,):
                raise ValueError(
                    f"SystemParams.{name} must have shape "
                    f"({self.num_devices},), got {tuple(arr.shape)}")
            devices.add(arr.device)
        if len(devices) != 1:
            raise ValueError(f"SystemParams arrays span devices {devices}")

    @property
    def device(self) -> torch.device:
        return self.data_sizes.device

    @property
    def data_weights(self) -> torch.Tensor:
        """w_n = D_n / D (paper Sec. III-A)."""
        d = self.data_sizes.to(torch.float32)
        return d / torch.sum(d)

    @property
    def per_device_bandwidth(self) -> float:
        """B_n = B / K under FDMA with even allocation (Sec. III-C)."""
        return self.bandwidth_hz / float(self.sample_count)


def paper_default_params(num_devices: int = 120,
                         sample_count: int = 2,
                         local_epochs: int = 2,
                         model_params: int = 11_172_342,
                         dataset: str = "cifar10",
                         data_sizes: Optional[np.ndarray] = None,
                         param_bits: int = 32,
                         device="cuda") -> SystemParams:
    """The paper's default experiment configuration (Sec. VII-A).

    p in [1e-3, 0.1] W, N0 = 0.01 W, f in [1.0, 2.0] GHz,
    alpha = 2e-28, B = 1 MHz, M = 32 * d bits,
    c = 3e9 (CIFAR-10) / 2e9 (FEMNIST) cycles/sample,
    E_bar = 15 J (CIFAR-10) / 5 J (FEMNIST).
    """
    n = num_devices
    if dataset == "cifar10":
        cycles, budget = 3.0e9, 15.0
    elif dataset == "femnist":
        cycles, budget = 2.0e9, 5.0
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    if data_sizes is None:
        data_sizes = np.full((n,), 50_000 // n, np.float32)

    def arr(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.float32), device=device)

    ones = np.ones((n,), np.float32)
    return SystemParams(
        num_devices=n,
        sample_count=sample_count,
        local_epochs=local_epochs,
        bandwidth_hz=1.0e6,
        noise_power=0.01,
        model_bits=float(param_bits) * float(model_params),
        download_rate=1.0e7,  # downloads ignored in paper experiments
        cycles_per_sample=arr(cycles * ones),
        data_sizes=arr(data_sizes),
        capacitance=arr(2.0e-28 * ones),
        energy_budget=arr(budget * ones),
        f_min=arr(1.0e9 * ones),
        f_max=arr(2.0e9 * ones),
        p_min=arr(1.0e-3 * ones),
        p_max=arr(0.1 * ones),
    )


# --------------------------------------------------------------------------
# Time model (eqs. (5)-(11))
# --------------------------------------------------------------------------

def effective_k(params: SystemParams, k):
    """The K a computation reads: ``k`` when given (K as data), else the
    static ``params.sample_count``."""
    return params.sample_count if k is None else k


def uplink_rate(params: SystemParams, h: torch.Tensor, p: torch.Tensor,
                k=None) -> torch.Tensor:
    """r_{n,u}^t = B_n log2(1 + h p / N0) — eq. (5), B_n = B / K."""
    bn = params.bandwidth_hz / effective_k(params, k)
    return bn * torch.log2(1.0 + h * p / params.noise_power)


def upload_time(params: SystemParams, h: torch.Tensor, p: torch.Tensor,
                k=None) -> torch.Tensor:
    """T_{n,u}^{t,com} = M / r_{n,u}^t — eq. (6)."""
    return params.model_bits / uplink_rate(params, h, p, k)


def download_time(params: SystemParams) -> torch.Tensor:
    """T_{n,d}^{t,com} = M / r_{n,d} — eq. (7)."""
    return torch.full((params.num_devices,),
                      params.model_bits / params.download_rate,
                      dtype=torch.float32, device=params.device)


def compute_time(params: SystemParams, f: torch.Tensor) -> torch.Tensor:
    """T_n^{t,cmp} = E c_n D_n / f — eq. (8)."""
    cycles = params.local_epochs * params.cycles_per_sample * params.data_sizes
    return cycles / f


def round_time(params: SystemParams, h: torch.Tensor, p: torch.Tensor,
               f: torch.Tensor, include_download: bool = False,
               k=None) -> torch.Tensor:
    """T_n^t — eq. (9). The paper's experiments ignore the download term."""
    t = compute_time(params, f) + upload_time(params, h, p, k)
    if include_download:
        t = t + download_time(params)
    return t


def expected_round_latency(q: torch.Tensor, t_round: torch.Tensor
                           ) -> torch.Tensor:
    """max_n T_n ~= sum_n q_n T_n — the paper's surrogate, eq. (11)."""
    return torch.sum(q * t_round)


# --------------------------------------------------------------------------
# Energy model (eqs. (12)-(17))
# --------------------------------------------------------------------------

def compute_energy(params: SystemParams, f: torch.Tensor) -> torch.Tensor:
    """E_n^{t,cmp} = E alpha_n c_n D_n f^2 / 2 — eq. (12)."""
    cycles = params.local_epochs * params.cycles_per_sample * params.data_sizes
    return 0.5 * params.capacitance * cycles * torch.square(f)


def comm_energy(params: SystemParams, h: torch.Tensor, p: torch.Tensor,
                k=None) -> torch.Tensor:
    """E_n^{t,com} = p * T_{n,u}^{t,com} — eq. (14)."""
    return p * upload_time(params, h, p, k)


def round_energy(params: SystemParams, h: torch.Tensor, p: torch.Tensor,
                 f: torch.Tensor, k=None) -> torch.Tensor:
    """E_n^t — eq. (15)."""
    return compute_energy(params, f) + comm_energy(params, h, p, k)


def selection_probability(q: torch.Tensor, sample_count) -> torch.Tensor:
    """1 - (1 - q)^K — probability device selected at least once
    (Sec. III-F); ``sample_count`` is an int or K as data."""
    return 1.0 - torch.pow(1.0 - q, sample_count)


def expected_energy(params: SystemParams, h: torch.Tensor, p: torch.Tensor,
                    f: torch.Tensor, q: torch.Tensor, k=None
                    ) -> torch.Tensor:
    """Per-round expected energy draw entering constraint (16)."""
    return (selection_probability(q, effective_k(params, k)) *
            round_energy(params, h, p, f, k))
