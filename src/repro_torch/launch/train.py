"""Runnable LM training driver with checkpointing and resume, ported from
``repro.launch.train``: the same flags, defaults and prints, plus
``--device`` (the card by default; ``cpu`` for a run without one).

On the CPU this trains the smoke variant of any ``--arch`` for a few
hundred steps; ``--full-config`` takes the full architecture (on the
card):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 200 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt --device cpu

Resume goes through ``repro_torch.checkpoint`` and reads a checkpoint the
JAX driver wrote as well as the port's own.  As in the JAX driver, it
restores the parameters only: the momentum starts from zero again, and
the batch iterator starts again from its first batch (ROADMAP section C
records both as reference behaviour carried over).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import lm_batches, synthetic_lm_tokens
from repro_torch.launch.steps import build_model, make_train_step
from repro_torch.models.transformer import param_count
from repro_torch.optim import SGD


def main(argv=None) -> dict:
    """Run the driver; returns what a caller checks: ``start`` (the step
    it resumed from, 0 for a fresh run), the first and last losses, and
    the final ``params`` and ``opt_state``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mamba2-130m")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) architecture")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = get_config(args.arch) if args.full_config \
        else get_smoke_config(args.arch)
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        print(f"note: {args.arch} takes stub modality inputs; training the "
              "decoder on text-only batches here")
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    n_params = param_count(params)
    print(f"training {cfg.name}: {n_params/1e6:.2f}M params, "
          f"batch {args.batch} x seq {args.seq}, {args.steps} steps")

    opt_state = SGD(momentum=0.9).init(params)
    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            params, meta = restore_checkpoint(args.ckpt_dir,
                                              f"step_{last}", params)
            start = int(meta.get("step", last))
            print(f"resumed from step {start}")

    toks = synthetic_lm_tokens(max(args.batch * 16, 64), args.seq + 1,
                               cfg.vocab_size, seed=0)
    batches = lm_batches(toks, args.batch, seed=1)

    step_fn = make_train_step(cfg, lr=args.lr, remat=False, device=device)
    if cfg.is_encoder_decoder:
        frame = torch.zeros((args.batch, cfg.encoder_seq_len, cfg.d_model),
                            device=device)
    if cfg.family == "vlm":
        vis = torch.zeros((args.batch, cfg.vision_patches, cfg.d_model),
                          device=device)

    t0 = time.time()
    loss0 = loss = None
    for step in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(batches).items()}
        if cfg.is_encoder_decoder:
            batch["frame_embeds"] = frame
        if cfg.family == "vlm":
            batch["vision_embeds"] = vis
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        if loss0 is None:
            loss0 = loss
        if step % args.log_every == 0 or step == args.steps - 1:
            rate = (step - start + 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {loss:8.4f}  {rate:5.2f} it/s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, f"step_{step + 1}", params,
                            {"step": step + 1, "loss": loss})
    if loss0 is not None:
        print(f"done: loss {loss0:.4f} -> {loss:.4f} "
              f"({(1 - loss / max(loss0, 1e-9)) * 100:.1f}% reduction)")
    return dict(start=start, loss0=loss0, loss=loss, params=params,
                opt_state=opt_state)


if __name__ == "__main__":
    main()
