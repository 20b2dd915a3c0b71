"""The yardstick's formulas: the counted sizes pinned, and the shapes they
count held against the program's tasks."""

import json
from pathlib import Path

import pytest

from fedbench import flops

ROOT = Path(__file__).resolve().parent.parent


def _model(name):
    return json.loads((ROOT / "fedbench" / "configs"
                       / f"{name}.json").read_text())["model"]


def test_cnn_counts():
    m = _model("cnn-cifar10")
    assert flops.param_count(m) == 545_002
    # conv 32x32x32x27 + conv 16x16x64x288 + dense 4096x128 + 128x10
    assert flops.forward_flops(m) == 12_257_792
    assert round(flops.forward_flops(m) / 1e6, 1) == 12.3


def test_training_work_is_three_forwards_per_example():
    m = _model("cnn-cifar10")
    assert flops.train_flops(m, 10) == 30 * 12_257_792


def test_aggregate_bytes_read_once_written_once():
    # 7 lanes of the CNN, K = 8: the 0.0456 ms bound of the lane kernel
    b = flops.aggregate_lanes_bytes(7, 8, 545_002)
    assert b == 4 * (7 * 545_002 * 10 + 56)
    assert b / flops.HBM_BYTES_PER_S == pytest.approx(45.56e-6, rel=1e-3)


@pytest.mark.parametrize("name", ["cnn-cifar10"])
def test_counted_shapes_are_the_programs(name):
    from repro_torch.models import CNNTask

    m = _model(name)
    task = CNNTask(image_shape=tuple(m["image_shape"]),
                   num_classes=m["num_classes"], width=m["width"])
    assert {k: tuple(v) for k, v in task.shapes.items()} == \
        flops.param_shapes(m)


def test_peaks():
    assert flops.PEAK_FLOPS["tf32"] == 495e12
    assert flops.PEAK_FLOPS["float32"] == 67e12
