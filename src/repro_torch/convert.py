"""Converters from the JAX package's data to the port's.

The parity tests use them to feed one set of numbers to both packages.
They read numpy arrays (or anything ``np.asarray`` accepts) and never
import the JAX package.  Like the port's other entry points they place
the result on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core import system_model as sm
from repro_torch.models.cnn import CNNTask


def params_from_jax(np_params: Mapping[str, np.ndarray], task,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """A JAX params dict (numpy leaves, JAX layouts) -> the port's dict.

    Leaves may carry extra leading axes (stacked ``[K, ...]`` client
    deltas convert the same way).  For a :class:`CNNTask`:

    * conv weights HWIO -> OIHW;
    * ``d1``'s rows from the JAX (h, w, c) flatten order to the port's
      NCHW (c, h, w) order.

    Dense weights keep their ``[in, out]`` layout; MLP leaves are copied
    as they are.
    """
    out = {}
    for name, value in np_params.items():
        a = np.asarray(value, np.float32)
        if isinstance(task, CNNTask):
            if name in ("c1", "c2"):
                a = np.moveaxis(a, (-4, -3, -2, -1), (-2, -1, -3, -4))
            elif name == "d1":
                h, w, _ = task.image_shape
                lead, (rows, cols) = a.shape[:-2], a.shape[-2:]
                c = rows // ((h // 4) * (w // 4))
                a = a.reshape(lead + (h // 4, w // 4, c, cols))
                a = np.moveaxis(a, -2, -4).reshape(lead + (rows, cols))
        out[name] = torch.as_tensor(np.array(a, order="C"), device=device)
    return out


def system_params_from_numpy(src, device="cuda") -> sm.SystemParams:
    """Any object with the ``SystemParams`` fields (numpy or array-like
    per-device fields, e.g. the JAX package's ``SystemParams``) -> the
    port's :class:`~repro_torch.core.system_model.SystemParams` on
    ``device``."""
    scalars = ("num_devices", "sample_count", "local_epochs",
               "bandwidth_hz", "noise_power", "model_bits", "download_rate")
    kwargs = {name: getattr(src, name) for name in scalars}
    for name in sm.ARRAY_FIELDS:
        kwargs[name] = torch.as_tensor(
            np.asarray(getattr(src, name), np.float32), device=device)
    return sm.SystemParams(**kwargs)
