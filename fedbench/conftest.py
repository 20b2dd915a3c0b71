"""Fixtures of the benchmark's CPU tests: each cell's own files, cut to a
toy size that a test run holds (8x8 images, 12 clients, K = 3, two seeds
a controller, width 4)."""

import copy
import time

import pytest

from fedbench.harness import main as hmain

CELLS = ("cnn-cifar10.paper4x28",)


def toy_cell(name: str) -> hmain.Cell:
    cell = hmain.find_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["data"].update(image_shape=[8, 8, 3], examples=1200, num_clients=12)
    cfg["model"].update(image_shape=[8, 8, 3], width=4)
    cfg["rounds"] = 40
    tr.update(seeds_per_controller=2, sample_count=3)
    cell.config, cell.traffic = cfg, tr
    return cell


def toy_run(name: str, seed: int = 2 ** 31 + 77, trace: bool = False,
            control: bool = False, seconds: float = 1.0, fault=None
            ) -> dict:
    return hmain.run(toy_cell(name), seed, seconds, trace,
                     time.perf_counter(), device="cpu", control=control,
                     fault=fault)


@pytest.fixture
def toy():
    """Toy runs on one thread (restored after), so that test workers
    running side by side do not oversubscribe the host's cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield toy_run
    torch.set_num_threads(threads)
