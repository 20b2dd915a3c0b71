"""Converters from the JAX package's data to the port's.

The parity tests use them to feed one set of numbers to both packages.
They read numpy arrays (or anything ``np.asarray`` accepts) and never
import the JAX package.  Like the port's other entry points they place
the result on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core import system_model as sm
from repro_torch.models.cnn import CNNTask, ResNetTask
from repro_torch.models.config import ModelConfig


_HWIO_TO_OIHW = ((-4, -3, -2, -1), (-2, -1, -3, -4))


def _conv_leaf(task, name: str) -> bool:
    """Whether leaf ``name`` of ``task`` is a convolution weight (HWIO in
    the JAX package, OIHW in the port)."""
    if isinstance(task, CNNTask):
        return name in ("c1", "c2")
    return isinstance(task, ResNetTask) and len(task.shapes[name]) == 4


def _d1_rows(a: np.ndarray, task, to_port: bool) -> np.ndarray:
    """The CNN's ``d1`` rows between the JAX (h, w, c) flatten order and
    the port's (c, h, w) order."""
    h, w, _ = task.image_shape
    lead, (rows, cols) = a.shape[:-2], a.shape[-2:]
    c = rows // ((h // 4) * (w // 4))
    if to_port:
        a = a.reshape(lead + (h // 4, w // 4, c, cols))
        return np.moveaxis(a, -2, -4).reshape(lead + (rows, cols))
    a = a.reshape(lead + (c, h // 4, w // 4, cols))
    return np.moveaxis(a, -4, -2).reshape(lead + (rows, cols))


def params_from_jax(np_params: Mapping[str, np.ndarray], task,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """A JAX params dict (numpy leaves, JAX layouts) -> the port's dict.

    Leaves may carry extra leading axes (stacked ``[K, ...]`` client
    deltas convert the same way).  For a :class:`CNNTask` or
    :class:`ResNetTask`:

    * conv weights HWIO -> OIHW;
    * the CNN's ``d1`` rows from the JAX (h, w, c) flatten order to the
      port's NCHW (c, h, w) order.

    Dense weights (the ResNet's ``head`` included) keep their ``[in,
    out]`` layout; MLP leaves are copied as they are.
    """
    out = {}
    for name, value in np_params.items():
        a = np.asarray(value, np.float32)
        if _conv_leaf(task, name):
            a = np.moveaxis(a, *_HWIO_TO_OIHW)
        elif isinstance(task, CNNTask) and name == "d1":
            a = _d1_rows(a, task, to_port=True)
        out[name] = torch.as_tensor(np.array(a, order="C"), device=device)
    return out


def params_to_jax_layout(params: Mapping[str, torch.Tensor], task
                         ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: the port's params (or
    stacked deltas) -> numpy leaves in the JAX package's layouts (OIHW ->
    HWIO, the CNN's ``d1`` rows back to (h, w, c)), exactly."""
    out = {}
    for name, value in params.items():
        a = value.detach().to(torch.float32).cpu().numpy()
        if _conv_leaf(task, name):
            a = np.moveaxis(a, *reversed(_HWIO_TO_OIHW))
        elif isinstance(task, CNNTask) and name == "d1":
            a = _d1_rows(a, task, to_port=False)
        out[name] = np.ascontiguousarray(a)
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


def _leaf(value, device, dtype) -> torch.Tensor:
    a = np.asarray(value)
    if dtype is None:
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else \
            torch.float32
    if a.dtype.name == "bfloat16":      # ml_dtypes: exact via f32
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order="C")).to(device=device,
                                                      dtype=dtype)


def lm_params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                       device="cuda", dtype=None) -> Dict[str, Any]:
    """A JAX LM parameter tree (nested dicts of numpy leaves) -> the
    port's tree, which has the same keys and layouts; dense weights stay
    ``[in, out]``, MoE experts ``[E, d, ff]`` / ``[E, ff, d]``.

    * ``TransformerLM`` (every family but the encoder-decoder):
      ``embed`` [V, d], ``blocks/b{j}`` with every leaf stacked over
      ``num_groups``, ``final_norm``, optional ``lm_head`` [d, V] and
      ``suffix_blocks/s{j}``;
    * ``EncoderDecoderLM``: ``embed``, ``dec_pos``, ``enc_layers`` and
      ``dec_layers`` (stacked over ``encoder_layers`` and
      ``num_layers``), ``enc_final_norm`` and ``final_norm``.

    Leaves keep their dtype (bf16 stays bf16) unless ``dtype`` is given.
    The tree's top level and the stacking are checked against ``cfg``."""
    if cfg.is_encoder_decoder:
        want = {"embed", "dec_pos", "enc_layers", "dec_layers",
                "enc_final_norm", "final_norm"}
        stacks = {"enc_layers": cfg.encoder_layers,
                  "dec_layers": cfg.num_layers}
    else:
        want = {"embed", "final_norm", "blocks"}
        if not cfg.tie_embeddings:
            want.add("lm_head")
        if cfg.block_pattern_suffix:
            want.add("suffix_blocks")
        stacks = {"blocks": cfg.num_groups}
    if set(np_params) != want:
        raise ValueError(f"{cfg.name}: expected top-level keys "
                         f"{sorted(want)}, got {sorted(np_params)}")
    if not cfg.is_encoder_decoder:
        blocks = np_params["blocks"]
        if set(blocks) != {f"b{j}" for j in range(len(cfg.block_pattern))}:
            raise ValueError(f"{cfg.name}: blocks {sorted(blocks)} do not "
                             f"match the pattern {cfg.block_pattern}")

    def convert(tree, stacked: int):
        if isinstance(tree, Mapping):
            return {k: convert(v, stacked) for k, v in tree.items()}
        t = _leaf(tree, device, dtype)
        if stacked and t.shape[0] != stacked:
            raise ValueError(f"{cfg.name}: a layer leaf of shape "
                             f"{tuple(t.shape)} is not stacked over "
                             f"{stacked} layers")
        return t

    out = {k: convert(v, stacks.get(k, 0)) for k, v in np_params.items()}
    if tuple(out["embed"].shape) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed {tuple(out['embed'].shape)}")
    return out
