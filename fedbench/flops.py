"""The benchmark's own yardstick: the models' forward products and
parameter counts by formula, the eq.-(4) kernel's bytes, and the
H100's published peaks (SXM, dense, at its 700 W limit).

A forward's FLOPs count the products alone (2 per multiply-add of each
convolution and dense layer); activations, pooling and the loss are
left out.  A training example costs 3 forwards (forward, and the two
products of the backward).
"""

from __future__ import annotations

from typing import Dict

#: the H100 SXM's dense peaks, FLOP/s and bytes/s
PEAK_FLOPS = {"tf32": 495e12, "float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def _conv(out_hw: int, cout: int, cin: int, k: int) -> int:
    return 2 * out_hw * out_hw * cout * cin * k * k


def cnn_forward_flops(model: dict) -> int:
    h, _, c = model["image_shape"]
    w, classes = model["width"], model["num_classes"]
    flat = (h // 4) * (h // 4) * 2 * w
    return (_conv(h, w, c, 3) + _conv(h // 2, 2 * w, w, 3)
            + 2 * flat * 128 + 2 * 128 * classes)


def forward_flops(model: dict) -> int:
    """FLOPs of one image's forward products."""
    if model["task"] != "cnn":
        raise ValueError(f"no formula for task {model['task']!r}")
    return cnn_forward_flops(model)


def param_shapes(model: dict) -> Dict[str, tuple]:
    from fedbench.reference.train import shapes
    return shapes(model)


def param_count(model: dict) -> int:
    total = 0
    for shape in param_shapes(model).values():
        n = 1
        for d in shape:
            n *= d
        total += n
    return total


def train_flops(model: dict, examples: int) -> int:
    """Model work of training ``examples`` true examples: 3 forwards."""
    return 3 * forward_flops(model) * int(examples)


def aggregate_lanes_bytes(lanes: int, k: int, params: int,
                          itemsize: int = 4) -> int:
    """eq. (4) over every lane, each input byte read once and each output
    byte written once: theta [S, P] and deltas [S, K, P] read, the
    coefficients [S, K] read, theta' [S, P] written."""
    return itemsize * (lanes * params * (k + 2) + lanes * k)
