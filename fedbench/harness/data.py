"""Every input of a run, made from ``--seed``: the images, the client
split, the test set, the initial weights, the channels and the lanes'
seeds.  Both the program and the reference are handed these.

The labels, the train/test split and the Dirichlet client partition are
the paper-scale testbed's, drawn from fixed seeds as its recipe draws
them (so every seed trains the same client sizes, and the bank's layout
and a round's work do not change with the seed).  The images' class
templates and noise, the weights, the channels and the lanes' seeds come
from ``--seed`` and are drawn on the device in a few large calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from fedbench.reference import train as ref_train

#: salts that keep the streams of one ``--seed`` apart (the check's lanes
#: are drawn from a stream of the check's own seed)
_IMAGES, _WEIGHTS, _CHANNELS, _LANES, _CHECKS, CHECK_LANES = 1, 2, 3, 4, 5, 6


def stream(seed: int, salt: int) -> int:
    """A 63-bit seed of one stream of ``--seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, salt])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def labels(data: dict) -> np.ndarray:
    """The testbed's labels: its generator's draws after the templates'
    (the templates themselves are redrawn from ``--seed``)."""
    rng = np.random.default_rng(data["label_seed"])
    d = int(np.prod(data["image_shape"]))
    rng.normal(0, 1, (data["num_classes"], data["template_rank"], d))
    rng.normal(0, 1, (data["num_classes"], data["template_rank"]))
    return rng.integers(0, data["num_classes"],
                        data["examples"]).astype(np.int32)


def split(n: int, test_fraction: float, seed: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Train and test indices of a seeded permutation."""
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(n * (1.0 - test_fraction))
    return perm[:cut], perm[cut:]


def dirichlet_partition(y: np.ndarray, num_clients: int,
                        concentration: float, seed: int,
                        min_per_client: int = 8) -> List[np.ndarray]:
    """Per-client index arrays: each class split by a Dirichlet draw,
    redrawn until every client holds ``min_per_client`` examples."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    for _ in range(256):
        buckets: List[list] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.flatnonzero(y == c)
            rng.shuffle(idx)
            probs = rng.dirichlet(np.full(num_clients, concentration))
            cuts = (np.cumsum(probs) * len(idx)).astype(int)[:-1]
            for dev, part in enumerate(np.split(idx, cuts)):
                buckets[dev].extend(part.tolist())
        if min(len(b) for b in buckets) >= min_per_client:
            break
    out = []
    for b in buckets:
        arr = np.asarray(b, np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def partition(data: dict) -> Tuple[np.ndarray, List[np.ndarray], np.ndarray]:
    """``(labels, per-client indices into the full set, test indices)``."""
    y = labels(data)
    train, test = split(len(y), data["test_fraction"], data["split_seed"])
    parts = dirichlet_partition(y[train], data["num_clients"],
                                data["dirichlet"], data["partition_seed"])
    return y, [train[p] for p in parts], test


def images(data: dict, y: np.ndarray, seed: int, device) -> torch.Tensor:
    """``[n, H, W, C]`` float32 on ``device``: a unit-norm rank-r class
    template plus Gaussian noise per image, all from ``--seed``."""
    g = torch.Generator(device).manual_seed(stream(seed, _IMAGES))
    c, r = data["num_classes"], data["template_rank"]
    d = int(np.prod(data["image_shape"]))
    u = torch.randn((c, r, d), generator=g, device=device)
    coeff = torch.randn((c, r), generator=g, device=device)
    templ = torch.einsum("kr,krd->kd", coeff, u) / np.sqrt(r)
    templ = templ / torch.linalg.vector_norm(templ, dim=1, keepdim=True)
    yt = torch.as_tensor(y.astype(np.int64), device=device)
    x = torch.randn((len(y), d), generator=g, device=device)
    x.mul_(data["noise"]).add_(templ[yt])
    return x.reshape((len(y),) + tuple(data["image_shape"]))


def channels(traffic: dict, num_clients: int, rounds: int, seed: int,
             device) -> torch.Tensor:
    """``[seeds, T, N]`` gains: exponential with mean ``mean_gain``,
    redrawn until they lie in ``[min_gain, max_gain]`` (the paper's
    truncated exponential).  One sequence per seed of the grid: every
    controller runs over the same channels."""
    ch = traffic["channel"]
    g = torch.Generator(device).manual_seed(stream(seed, _CHANNELS))
    shape = (traffic["seeds_per_controller"], rounds, num_clients)
    h = torch.empty(shape, device=device).exponential_(generator=g)
    h.mul_(ch["mean_gain"])
    for _ in range(64):
        bad = (h < ch["min_gain"]) | (h > ch["max_gain"])
        if not bool(bad.any()):
            break
        redraw = torch.empty(shape, device=device).exponential_(
            generator=g).mul_(ch["mean_gain"])
        h = torch.where(bad, redraw, h)
    return h.clamp_(ch["min_gain"], ch["max_gain"])


def lane_seeds(traffic: dict, seed: int) -> np.ndarray:
    """The grid's seeds (one per channel sequence), below 2**32."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, _LANES])
    return state.generate_state(traffic["seeds_per_controller"],
                                np.uint32).astype(np.int64)


@dataclasses.dataclass
class Inputs:
    client_data: List[Tuple[np.ndarray, np.ndarray]]   # NHWC f32, int32
    sizes: np.ndarray                                   # [N]
    test: Tuple[np.ndarray, np.ndarray]
    params0: Dict[str, torch.Tensor]                    # on the device
    h_seeds: torch.Tensor                               # [seeds, T, N]
    lane_seeds: np.ndarray                              # [seeds]
    check_seed: int


def make(config: dict, traffic: dict, seed: int, device) -> Inputs:
    data = config["data"]
    y, parts, test = partition(data)
    x = images(data, y, seed, device).cpu().numpy()
    client_data = [(x[p], y[p]) for p in parts]
    g = torch.Generator(device).manual_seed(stream(seed, _WEIGHTS))
    params0 = ref_train.init_params(config["model"], g)
    return Inputs(
        client_data=client_data,
        sizes=np.asarray([len(p) for p in parts], np.int64),
        test=(x[test], y[test]), params0=params0,
        h_seeds=channels(traffic, data["num_clients"], config["rounds"],
                         seed, device),
        lane_seeds=lane_seeds(traffic, seed),
        check_seed=stream(seed, _CHECKS))
