"""The data plane of one round, written anew in plain PyTorch: the two
Sec. VII CNN (on the parameter
layout the arena carries), one client's E epochs of momentum SGD, the
eq.-(4) aggregation and the test-set metrics.

Clients train one after another, one mini-batch at a time, with no
vmap, no bank, no padding buffers and no kernel of the program.  The
caller picks the device and the dtype (float32 with TF32 off for the
reference, a lower precision for the control).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fedbench.reference import draws

Params = Dict[str, torch.Tensor]


# -- the models ------------------------------------------------------------

def cnn_shapes(model: dict) -> Dict[str, tuple]:
    """conv 3x3 (w) -> pool -> conv 3x3 (2w) -> pool -> dense 128 ->
    dense classes; conv weights OIHW, dense weights [in, out], the first
    dense layer's rows in (channel, row, column) order."""
    h, w, c = model["image_shape"]
    wd, classes = model["width"], model["num_classes"]
    flat = (h // 4) * (w // 4) * 2 * wd
    return {"c1": (wd, c, 3, 3), "c2": (2 * wd, wd, 3, 3),
            "d1": (flat, 128), "b1": (128,), "d2": (128, classes),
            "b2": (classes,)}


def shapes(model: dict) -> Dict[str, tuple]:
    if model["task"] != "cnn":
        raise ValueError(f"no reference for task {model['task']!r}")
    return cnn_shapes(model)


def fan_in(name: str, shape: tuple) -> int:
    """The fan-in of a weight leaf (0 for a bias)."""
    if len(shape) == 4:
        return shape[1] * shape[2] * shape[3]
    if len(shape) == 2:
        return shape[0]
    return 0


def cnn_forward(p: Params, x):
    x = F.max_pool2d(F.silu(F.conv2d(x, p["c1"], padding=1)), 2)
    x = F.max_pool2d(F.silu(F.conv2d(x, p["c2"], padding=1)), 2)
    x = F.silu(x.flatten(1) @ p["d1"] + p["b1"])
    return x @ p["d2"] + p["b2"]


def forward(model: dict, p: Params, x_nhwc):
    """Logits of NHWC images."""
    return cnn_forward(p, x_nhwc.permute(0, 3, 1, 2))


# -- one client's local training ----------------------------------------------

def epoch_order(keys_row: np.ndarray, n: int, bs: int) -> np.ndarray:
    """One epoch's rows: the client's n examples in the stable order of
    their keys; a client of fewer than ``bs`` examples fills its one
    batch with the rows after them, each row j holding example j mod n."""
    order = np.argsort(keys_row[:n], kind="stable")
    if n < bs:
        order = np.concatenate([order, np.arange(n, bs)])
    return order % n


def local_sgd(model: dict, params: Params, x, y, order_keys: np.ndarray,
              lr: float, bs: int, momentum: float
              ) -> Tuple[Params, float]:
    """E epochs of heavy-ball SGD (m = mu m + g, p -= lr m, m from zero)
    over ``max(n // bs, 1)`` mini-batches an epoch, each the mean
    cross-entropy of ``bs`` rows in the epoch's order.  Returns the delta
    and the mean over epochs of the mean batch loss."""
    n = int(x.shape[0])
    steps = max(n // bs, 1)
    names = list(params)
    p = {k: params[k].detach().clone().requires_grad_(True) for k in names}
    leaves = [p[k] for k in names]
    m = [torch.zeros_like(v) for v in leaves]
    epoch_losses = []
    for keys_row in order_keys:
        order = torch.as_tensor(epoch_order(keys_row, n, bs),
                                device=x.device)
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for s in range(steps):
            rows = order[s * bs:(s + 1) * bs]
            loss = F.cross_entropy(forward(model, p, x[rows]), y[rows])
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                torch._foreach_mul_(m, momentum)
                torch._foreach_add_(m, grads)
                torch._foreach_add_(leaves, torch._foreach_mul(m, -lr))
            total = total + loss.detach().double()
        epoch_losses.append(total / steps)
    delta = {k: (p[k].detach() - params[k]) for k in names}
    return delta, float(torch.stack(epoch_losses).mean())


def aggregate(params: Params, deltas, coeffs) -> Params:
    """eq. (4): theta + sum_k c_k delta_k."""
    out = {}
    for k, v in params.items():
        acc = v.clone()
        for c, d in zip(coeffs, deltas):
            acc = acc + float(c) * d[k]
        out[k] = acc
    return out


@torch.no_grad()
def evaluate(model: dict, params: Params, x, y, block: int = 1500
             ) -> Dict[str, float]:
    """Accuracy and mean cross-entropy over the test set, in blocks."""
    correct, loss, n = 0.0, 0.0, int(x.shape[0])
    for i in range(0, n, block):
        lg = forward(model, params, x[i:i + block])
        correct += float((torch.argmax(lg, -1) == y[i:i + block]).sum())
        loss += float(F.cross_entropy(lg.float(), y[i:i + block],
                                      reduction="sum"))
    return {"accuracy": correct / n, "loss": loss / n}


def init_params(model: dict, generator: torch.Generator) -> Params:
    """Fan-in truncated-normal weights (cut at two deviations), zero
    biases, drawn on the generator's device in ONE call over every weight
    leaf."""
    shp = shapes(model)
    weights = [k for k, s in shp.items() if fan_in(k, s)]
    sizes = [math.prod(shp[k]) for k in weights]
    flat = torch.empty(sum(sizes), dtype=torch.float32,
                       device=generator.device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    out, off = {}, 0
    for k, size in zip(weights, sizes):
        out[k] = (flat[off:off + size].reshape(shp[k])
                  / math.sqrt(fan_in(k, shp[k])))
        off += size
    for k, s in shp.items():
        if k not in out:
            out[k] = torch.zeros(s, dtype=torch.float32,
                                 device=generator.device)
    return {k: out[k] for k in shp}


def client_round(model: dict, params: Params, x, y, key, t: int,
                 slot: int, epochs: int, lr: float, bs: int,
                 momentum: float):
    """One slot of round ``t``: its order keys from the lane's rollout
    key, then :func:`local_sgd`."""
    n = int(x.shape[0])
    keys = draws.epoch_order_keys(key, t, slot, epochs, max(n, bs))
    return local_sgd(model, params, x, y, keys, lr, bs, momentum)
