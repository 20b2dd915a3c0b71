"""Step builders ported from ``repro.launch.steps``: ``build_model``,
``dryrun_config`` (without the mesh fields), the prefill / one-token
serve steps for every family, and the training steps:

* :func:`make_train_step` — one SGD-with-momentum step of an LM over a
  batch, every family's inputs (Whisper's ``frame_embeds``, qwen2-vl's
  ``vision_embeds`` with M-RoPE positions), ``remat`` (each block under
  ``torch.utils.checkpoint``) and ``microbatch`` accumulation in f32;
* :func:`make_fl_round_step` — the paper's Algorithm 1 inner loop on an
  LM: K clients' local SGD from the global parameters, then eq. (4) as
  one ``ops.fl_aggregate_leaves`` launch per table of leaves (the
  hand-written ``fl_aggregate`` kernel on the card).

and the dry run's stand-ins, :func:`param_specs`, :func:`input_specs`
and :func:`cache_specs`: ``meta`` tensors of the reference's shapes and
dtypes, built without drawing anything (the counterpart of
``jax.eval_shape`` and ``jax.ShapeDtypeStruct``).

Gradients come from ``torch.autograd`` through the model, whose two
kernels are ``autograd.Function``s on this path (flash attention with a
blockwise plain backward, the SSD chunk with the plain version's
backward).  The steps update in place where the JAX package returns new
arrays, which saves a copy of the parameters and of the f32 momentum
(15 GB at gemma-2b): see each step's docstring.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import get_spec
from repro_torch.configs.shapes import InputShape
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncoderDecoderLM
from repro_torch.models.layers import token_nll
from repro_torch.models.transformer import TransformerLM, torch_dtype
from repro_torch.models.vlm import mrope_decode_positions, mrope_positions
from repro_torch.optim import SGD
from repro_torch.tree import tree_flatten, tree_unflatten

PyTree = Any
LM = Union[TransformerLM, EncoderDecoderLM]


def build_model(cfg: ModelConfig, device="cuda", remat: bool = False) -> LM:
    """The LM for ``cfg`` on ``device``: an :class:`EncoderDecoderLM` for
    an encoder-decoder (whisper), a :class:`TransformerLM` otherwise
    (``remat`` as the JAX package: the decoder-only model's blocks)."""
    if cfg.is_encoder_decoder:
        return EncoderDecoderLM(cfg, device=device)
    return TransformerLM(cfg, device=device, remat=remat)


def dryrun_config(cfg: ModelConfig) -> ModelConfig:
    """Accelerator dtypes: bf16 parameters and activations and the flash
    attention path; the MoE family routes in 16 token groups, the JAX
    version's value for one pod's data axis (the groups set the capacity
    per group, and so which tokens drop).  The JAX version also binds
    activation sharding to a mesh and pads the vocabulary for it; one card
    has no mesh, so ``batch_axes`` stays empty and the vocabulary exact."""
    return dataclasses.replace(
        cfg, param_dtype="bfloat16", dtype="bfloat16", attn_impl="flash",
        batch_axes=(),
        moe_groups=16 if cfg.family == "moe" else cfg.moe_groups,
        vocab_pad_multiple=0)


# --------------------------------------------------------------------------
# the dry run's stand-ins (meta tensors)
# --------------------------------------------------------------------------

#: factories whose ``device=`` :class:`_FactoriesOnMeta` moves to meta
_FACTORIES = (torch.empty, torch.zeros, torch.ones, torch.full, torch.randn,
              torch.rand, torch.randint, torch.arange, torch.tensor,
              torch.as_tensor, torch.linspace, torch.eye)


class _FactoriesOnMeta(TorchFunctionMode):
    """Every factory call that names a device makes a ``meta`` tensor
    instead, so a model's ``init`` builds its tree of the right shapes
    and dtypes and draws nothing (random ops on meta tensors are
    no-ops)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FACTORIES and "device" in kwargs:
            kwargs = dict(kwargs, device="meta")
        return func(*args, **kwargs)


def param_specs(cfg: ModelConfig) -> PyTree:
    """The parameter tree of ``cfg``'s model as ``meta`` tensors (the
    reference's ``jax.eval_shape(model.init, key)``)."""
    with _FactoriesOnMeta():
        return build_model(cfg, "cpu").init(torch.Generator())


def input_specs(arch: str, shape: InputShape,
                cfg: Optional[ModelConfig] = None
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for the data inputs of one step of ``shape``,
    the reference's ``ShapeDtypeStruct`` s: ``tokens`` (and ``labels``
    for train) int32 ``[B, S]``, the audio family's ``frame_embeds`` and
    the VLM family's ``vision_embeds`` in ``cfg.dtype``; for decode
    ``tokens`` ``[B, 1]``, a 0-d int32 ``cache_index`` and the audio
    family's ``enc_states``."""
    cfg = cfg or get_spec(arch).config
    b, s = shape.global_batch, shape.seq_len
    act, i32 = torch_dtype(cfg.dtype), torch.int32

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        out = {"tokens": spec((b, s), i32)}
        if shape.kind == "train":
            out["labels"] = spec((b, s), i32)
        if cfg.family == "audio":
            out["frame_embeds"] = spec((b, cfg.encoder_seq_len,
                                        cfg.d_model), act)
        if cfg.family == "vlm":
            out["vision_embeds"] = spec((b, cfg.vision_patches,
                                         cfg.d_model), act)
        return out
    out = {"tokens": spec((b, 1), i32), "cache_index": spec((), i32)}
    if cfg.family == "audio":
        out["enc_states"] = spec((b, cfg.encoder_seq_len, cfg.d_model), act)
    return out


def cache_specs(arch: str, shape: InputShape,
                cfg: Optional[ModelConfig] = None) -> PyTree:
    """The decode cache of ``shape`` (batch, length) as ``meta``
    tensors, in ``cfg.dtype``."""
    cfg = cfg or get_spec(arch).config
    return build_model(cfg, "meta").init_cache(
        shape.global_batch, shape.seq_len, torch_dtype(cfg.dtype))


def make_prefill_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``(params, batch) -> (last-position logits [B, V], cache)``.

    ``batch`` holds ``tokens`` and, for the audio family, ``frame_embeds``
    (encoded here, as the JAX step does) or the already encoded
    ``enc_states``; for the VLM family ``vision_embeds``, with M-RoPE
    positions in the vision-prefix layout.  Only the last position's
    logits are returned (serving), so only its row goes through the
    vocabulary projection: the output equals the JAX step's
    ``logits[:, -1]``."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, PyTree]:
        tokens = batch["tokens"]
        if cfg.is_encoder_decoder:
            enc = batch.get("enc_states")
            if enc is None:
                enc = model.encode(params, batch["frame_embeds"])
            x, cache = model.decode_hidden(params, tokens, enc,
                                           mode="prefill")
        else:
            kw = {}
            if cfg.family == "vlm":
                b, s = tokens.shape
                kw = dict(positions_thw=mrope_positions(
                    b, s, cfg.vision_patches, device=tokens.device),
                    vision_embeds=batch["vision_embeds"])
            x, _, cache = model.hidden(params, tokens, mode="prefill", **kw)
        return model.logits(params, x[:, -1:])[:, -1, :], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, device="cuda") -> Callable:
    """``(params, cache, batch) -> (logits [B, V], cache)``: one-token
    decode against a prefilled cache (updated in place); ``batch`` holds
    ``tokens`` [B, 1], the int ``cache_index`` and, for the audio family,
    ``enc_states``."""
    model = build_model(cfg, device)

    @torch.no_grad()
    def serve_step(params, cache, batch):
        tokens, idx = batch["tokens"], batch["cache_index"]
        if cfg.is_encoder_decoder:
            logits, cache = model.decode_step(params, cache, tokens, idx,
                                              batch["enc_states"])
        else:
            kw = {}
            if cfg.family == "vlm":
                kw = dict(positions_thw=mrope_decode_positions(
                    tokens.shape[0], idx, cfg.vision_patches,
                    device=tokens.device))
            logits, cache = model.decode_step(params, cache, tokens, idx,
                                              **kw)
        return logits[:, -1, :], cache

    return serve_step


def value_and_grad(loss_fn: Callable, params: PyTree, *args
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(``loss_fn(params, *args)`` detached, the gradient of every leaf of
    ``params`` in ``repro_torch.tree`` order, each in its leaf's dtype).
    The leaves are differentiated through views that share their storage;
    a leaf the loss does not reach raises."""
    leaves, structure = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(structure, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def make_loss_fn(model: LM) -> Callable:
    """``(params, batch) -> loss``: ``mean(token_nll) +
    router_aux_loss_coef * aux`` of ``model`` on ``batch`` (``tokens``,
    ``labels`` and each family's inputs, as :func:`make_train_step`
    takes them), the JAX train step's ``loss_fn``."""
    cfg = model.cfg

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if cfg.is_encoder_decoder:
            logits, aux, _ = model.apply(params, tokens,
                                         frame_embeds=batch["frame_embeds"])
        elif cfg.family == "vlm":
            b, s = tokens.shape
            pthw = mrope_positions(b, s, cfg.vision_patches,
                                   device=tokens.device)
            logits, aux, _ = model.apply(params, tokens, positions_thw=pthw,
                                         vision_embeds=batch["vision_embeds"])
        else:
            logits, aux, _ = model.apply(params, tokens)
        nll = token_nll(logits, batch["labels"])
        return nll.mean() + cfg.router_aux_loss_coef * aux

    return loss_fn


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-3,
                    remat: bool = True, microbatch: int = 1,
                    device="cuda") -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``, the
    JAX package's train step: SGD with momentum 0.9 on
    ``mean(token_nll) + router_aux_loss_coef * aux``.

    ``batch`` holds ``tokens`` and ``labels`` [B, S] and, for the audio
    family, ``frame_embeds``; for the VLM family ``vision_embeds`` (the
    M-RoPE positions are built here).  ``microbatch`` > 1 splits the
    batch into that many consecutive chunks, sums their losses and
    gradients in f32 from zero and divides by ``microbatch``, as the
    reference's scan does.  ``opt_state`` is ``SGD(0.9).init(params)``.
    The parameters and the momentum are updated in place (the returned
    ``params`` and ``opt_state`` are the objects passed in); ``metrics``
    holds the f32 ``loss``."""
    model = build_model(cfg, device, remat=remat)
    opt = SGD(momentum=0.9)
    loss_fn = make_loss_fn(model)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if microbatch <= 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = batch["tokens"].shape[0]
            if n % microbatch:
                raise ValueError(f"batch {n} is not a multiple of "
                                 f"microbatch {microbatch}")
            size = n // microbatch
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = None
            for i in range(microbatch):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_loss, mb_grads = value_and_grad(loss_fn, params, mb)
                if grads is None:
                    grads = [torch.zeros(g.shape, dtype=torch.float32,
                                         device=g.device) for g in mb_grads]
                loss = loss + mb_loss
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g)
                del mb_grads
            loss = loss / microbatch
            for acc in grads:
                acc.div_(microbatch)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=loss.device)
        _, structure = tree_flatten(params)
        opt.step_(tree_unflatten(structure, grads), opt_state, params, lr_t)
        return params, opt_state, {"loss": loss}

    return train_step


def make_fl_round_step(cfg: ModelConfig, num_clients_per_round: int, *,
                       lr: float = 1e-2, local_steps: int = 4,
                       device="cuda") -> Callable:
    """``(params, batch) -> (new_params, metrics)``: the JAX package's
    client-parallel FL round (Algorithm 1's inner loop) on a
    decoder-only LM.

    ``batch`` holds ``tokens`` / ``labels`` ``[K, local_batch, S]`` and
    ``coeffs`` [K] f32 = ``w / (K q)``.  Each client runs ``local_steps``
    SGD steps (momentum 0.9, fresh per client) from the global
    parameters on its own batch; the reference vmaps the clients, here
    they run one after another, since each is independent.  Each
    client's delta ``p_new - p`` (in the parameter's dtype) is written
    into a preallocated ``[K, ...]`` buffer per leaf, and its parameters
    and momentum are freed before the next client starts.  Eq. (4),
    ``p + sum_k coeffs[k] delta_k`` accumulated in f32 and written in
    each parameter's dtype, is one ``ops.fl_aggregate_leaves`` call: one
    ``fl_aggregate`` launch per table of leaves on the card.  ``params``
    is left as it is; ``metrics["loss"]`` is the mean of the clients'
    mean losses."""
    opt = SGD(momentum=0.9)
    k = num_clients_per_round
    loss_fn = make_loss_fn(build_model(cfg, device))

    def fl_round_step(params, batch: Dict[str, torch.Tensor]):
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.shape[0] != k or labels.shape[0] != k:
            raise ValueError(f"tokens and labels must be [{k}, B, S], got "
                             f"{tuple(tokens.shape)}, {tuple(labels.shape)}")
        leaves, structure = tree_flatten(params)
        deltas = [torch.empty((k,) + tuple(p.shape), dtype=p.dtype,
                              device=p.device) for p in leaves]
        lr_t = torch.tensor(lr, dtype=torch.float32, device=tokens.device)
        losses = []
        for c in range(k):
            local = tree_unflatten(structure, [p.clone() for p in leaves])
            state = opt.init(local)
            client_losses = []
            for _ in range(local_steps):
                loss, grads = value_and_grad(
                    loss_fn, local, {"tokens": tokens[c],
                                     "labels": labels[c]})
                opt.step_(tree_unflatten(structure, grads), state, local,
                          lr_t)
                del grads
                client_losses.append(loss)
            for d, new, old in zip(deltas, tree_flatten(local)[0], leaves):
                torch.sub(new, old, out=d[c])
            del local, state
            losses.append(torch.stack(client_losses).mean())
        new_leaves = ops.fl_aggregate_leaves(
            leaves, deltas, batch["coeffs"].to(torch.float32).contiguous())
        return (tree_unflatten(structure, new_leaves),
                {"loss": torch.stack(losses).mean()})

    return fl_round_step
