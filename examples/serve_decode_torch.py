"""Batched serving demo in the PyTorch port (``repro_torch``), the
counterpart of ``examples/serve_decode.py``: prefill a prompt batch, then
greedy-decode one token at a time (KV caches, ring-buffer window caches
on local layers, flash-decode on long global caches) through
``launch/serve.greedy_generate``.  The prefill's attention takes the
flash path, so on the card it runs the hand-written flash kernel
(``kernels/csrc/flash_attention.cu``), and a Mamba-2 arch's prefill the
SSD chunk kernel (``kernels/csrc/ssd_chunk.cu``).

    PYTHONPATH=src python examples/serve_decode_torch.py [--arch gemma2-27b]
        [--device cpu]    (the smoke variant of the arch is served)
"""

import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic_lm_tokens
from repro_torch.launch.serve import greedy_generate
from repro_torch.launch.steps import build_model
from repro_torch.tree import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = dataclasses.replace(get_smoke_config(args.arch), attn_impl="flash")
    model = build_model(cfg, device)
    # the weights are drawn on the CPU from the seed and copied over, so
    # every device serves the same model
    params = tree_map(lambda t: t.to(device), build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0)))

    prompts = torch.as_tensor(synthetic_lm_tokens(
        args.batch, args.prompt_len, cfg.vocab_size, seed=1), device=device)
    print(f"serving {cfg.name}: batch={args.batch} "
          f"prompt={args.prompt_len} +{args.new_tokens} tokens")

    # prefill -> per-layer caches padded to the full horizon, then the
    # one-token decode steps
    out, _ = greedy_generate(model, params, prompts, args.new_tokens)

    out = out.cpu().numpy()
    for b in range(args.batch):
        print(f"  prompt[{b}] {prompts[b].cpu().numpy()[:8]}... -> "
              f"generated {out[b]}")
    print("decode loop OK (ring-buffer local caches + full global caches).")
    return out


if __name__ == "__main__":
    main()
