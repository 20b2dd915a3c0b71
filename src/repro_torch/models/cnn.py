"""Image-classification tasks for the FL experiments (paper Sec. VII-A) —
the port of ``CNNTask``, ``ResNetTask`` and ``MLPTask`` from
``repro.models.cnn``.

Each task is an ``nn.Module`` whose parameters are placeholders on the
``meta`` device: the trained values live outside it, as a plain
``dict[str, Tensor]`` under the JAX package's names, and every evaluation
goes through ``torch.func.functional_call`` — so one module serves K
clients' parameter stacks under ``torch.func.vmap``.

* ``init(generator)`` draws fresh parameters on the generator's device
  (truncated-normal fan-in init, as the JAX package; the numbers differ,
  the two RNGs being different — tests pass the JAX init in through
  ``repro_torch.convert.params_from_jax``).
* ``loss_fn(params, batch)`` / ``metrics(params, batch)`` take
  ``{"x": inputs, "y": int64 labels}``.
* ``device_layout(x)`` maps the JAX package's NHWC image stacks to the
  layout ``forward`` reads.  The client bank applies it once, at upload,
  so no step permutes its inputs.

Layouts (CNN): conv weights are OIHW, activations NCHW; ``d1``'s rows are
in (c, h, w) flatten order (``params_from_jax`` permutes the JAX (h, w, c)
rows once).  Dense weights keep the JAX ``[in, out]`` layout (``x @ W``).
The ResNet's convolutions are OIHW too; its head needs no permutation
(it follows a spatial mean).

"SAME" padding is XLA's: for a size ``n``, stride ``s`` and kernel ``k``
it pads ``total = max((ceil(n / s) - 1) s + k - n, 0)`` rows, ``total //
2`` before and the rest after — asymmetric where ``total`` is odd (a
3x3 stride-2 convolution on an even size pads (0, 1)), so it is computed
per call (:func:`_same_pads`), never fixed.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

Params = Dict[str, torch.Tensor]


def _trunc_normal(shape, std: float, generator: torch.Generator
                  ) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out * std


def _same_pads(n: int, stride: int, k: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (before, after) of one spatial axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int = 1
               ) -> torch.Tensor:
    """``conv_general_dilated(x, w, stride, "SAME")`` on NCHW / OIHW."""
    (top, bottom), (left, right) = (
        _same_pads(x.shape[-2], stride, w.shape[-2]),
        _same_pads(x.shape[-1], stride, w.shape[-1]))
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == labels).to(torch.float32).mean()


class _Task(nn.Module):
    """Shared functional surface: parameters are passed in, never held."""

    shapes: Dict[str, Tuple[int, ...]]

    def _register_meta(self) -> None:
        for name, shape in self.shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(shape, device="meta")))

    def logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self, params, (x,))

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        return _xent(self.logits(params, batch["x"]), batch["y"])

    def metrics(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        lg = self.logits(params, batch["x"])
        return {"accuracy": _accuracy(lg, batch["y"]),
                "loss": _xent(lg, batch["y"])}

    @staticmethod
    def device_layout(x: torch.Tensor) -> torch.Tensor:
        return x


class CNNTask(_Task):
    """conv(w) -> conv(2w) -> dense(128) -> dense(classes), silu + 2x2
    max pooling; ``image_shape`` is (H, W, C) as in the JAX package."""

    def __init__(self, image_shape: Tuple[int, int, int] = (28, 28, 1),
                 num_classes: int = 62, width: int = 32):
        super().__init__()
        h, w, c = image_shape
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.width = width
        flat = (h // 4) * (w // 4) * 2 * width
        self.shapes = {"c1": (width, c, 3, 3), "c2": (2 * width, width, 3, 3),
                       "d1": (flat, 128), "b1": (128,),
                       "d2": (128, num_classes), "b2": (num_classes,)}
        self._register_meta()

    def init(self, generator: torch.Generator) -> Params:
        dev = generator.device
        c = self.image_shape[2]
        wd = self.width
        return {
            "c1": _trunc_normal(self.shapes["c1"],
                                1.0 / math.sqrt(9 * c), generator),
            "c2": _trunc_normal(self.shapes["c2"],
                                1.0 / math.sqrt(9 * wd), generator),
            "d1": _trunc_normal(self.shapes["d1"],
                                1.0 / math.sqrt(self.shapes["d1"][0]),
                                generator),
            "b1": torch.zeros(128, device=dev),
            "d2": _trunc_normal(self.shapes["d2"], 1.0 / math.sqrt(128),
                                generator),
            "b2": torch.zeros(self.num_classes, device=dev),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] -> logits [B, classes]."""
        x = F.max_pool2d(F.silu(F.conv2d(x, self.c1, padding=1)), 2)
        x = F.max_pool2d(F.silu(F.conv2d(x, self.c2, padding=1)), 2)
        x = x.flatten(1)
        x = F.silu(x @ self.d1 + self.b1)
        return x @ self.d2 + self.b2

    @staticmethod
    def device_layout(x: torch.Tensor) -> torch.Tensor:
        """[..., H, W, C] -> contiguous [..., C, H, W]."""
        return x.movedim(-1, -3).contiguous()


class ResNetTask(_Task):
    """Pre-activation residual CNN (norm-free, FL-aggregation-safe): a
    3x3 stem, three stages of ``blocks_per_stage`` blocks at widths w, 2w
    and 4w (stride 2 into stages 1 and 2), ``x + 0.5 h`` shortcuts (a 1x1
    projection ``{pre}_proj`` where the width changes, else a strided
    slice where the stride does), and a ``silu`` + spatial-mean head."""

    def __init__(self, image_shape: Tuple[int, int, int] = (32, 32, 3),
                 num_classes: int = 10, width: int = 32,
                 blocks_per_stage: int = 2):
        super().__init__()
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.width = width
        self.blocks_per_stage = blocks_per_stage
        c = image_shape[2]
        shapes = {"stem": (width, c, 3, 3)}
        cin = width
        for stage in range(3):
            cout = width * (2 ** stage)
            for b in range(blocks_per_stage):
                pre = f"s{stage}b{b}"
                shapes[f"{pre}_c1"] = (cout, cin, 3, 3)
                shapes[f"{pre}_c2"] = (cout, cout, 3, 3)
                if cin != cout:
                    shapes[f"{pre}_proj"] = (cout, cin, 1, 1)
                cin = cout
        shapes["head"] = (cin, num_classes)
        shapes["head_b"] = (num_classes,)
        self.shapes = shapes
        self._register_meta()

    def init(self, generator: torch.Generator) -> Params:
        """Truncated-normal fan-in init, in the JAX package's key order
        (stem, each block's c1, c2 and proj, the head)."""
        out = {}
        for name, shape in self.shapes.items():
            if name == "head_b":
                out[name] = torch.zeros(shape, device=generator.device)
            else:
                fan_in = (shape[0] if name == "head"
                          else shape[1] * shape[2] * shape[3])
                out[name] = _trunc_normal(shape, 1.0 / math.sqrt(fan_in),
                                          generator)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] -> logits [B, classes]."""
        def w(name: str) -> torch.Tensor:
            return getattr(self, name)

        x = _conv_same(x, w("stem"))
        for stage in range(3):
            stride = 2 if stage > 0 else 1
            for b in range(self.blocks_per_stage):
                pre = f"s{stage}b{b}"
                st = stride if b == 0 else 1
                h = _conv_same(F.silu(x), w(f"{pre}_c1"), st)
                h = _conv_same(F.silu(h), w(f"{pre}_c2"))
                short = x
                if f"{pre}_proj" in self.shapes:
                    short = _conv_same(x, w(f"{pre}_proj"), st)
                elif st > 1:
                    short = x[:, :, ::st, ::st]
                x = short + 0.5 * h
        x = torch.mean(F.silu(x), dim=(2, 3))
        return x @ self.head + self.head_b

    @staticmethod
    def device_layout(x: torch.Tensor) -> torch.Tensor:
        """[..., H, W, C] -> contiguous [..., C, H, W]."""
        return x.movedim(-1, -3).contiguous()


class MLPTask(_Task):
    """Two dense layers over the flattened input (NHWC flatten order, as
    the JAX package: the bank keeps its rows as they come)."""

    def __init__(self, input_dim: int = 3072, num_classes: int = 10,
                 hidden: int = 128):
        super().__init__()
        self.input_dim = input_dim
        self.num_classes = num_classes
        self.hidden = hidden
        self.shapes = {"w1": (input_dim, hidden), "b1": (hidden,),
                       "w2": (hidden, num_classes), "b2": (num_classes,)}
        self._register_meta()

    def init(self, generator: torch.Generator) -> Params:
        dev = generator.device
        return {
            "w1": _trunc_normal(self.shapes["w1"],
                                1.0 / math.sqrt(self.input_dim), generator),
            "b1": torch.zeros(self.hidden, device=dev),
            "w2": _trunc_normal(self.shapes["w2"],
                                1.0 / math.sqrt(self.hidden), generator),
            "b2": torch.zeros(self.num_classes, device=dev),
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = F.silu(x @ self.w1 + self.b1)
        return x @ self.w2 + self.b2
