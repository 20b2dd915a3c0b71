"""Federated training of a language model in the PyTorch port
(``repro_torch``), the counterpart of ``examples/lm_federated.py``: each
round the LROA controller (Algorithm 2) decides the sampling
probabilities q from the channel gains, K clients are drawn by q
(``sample_clients``), and ``make_fl_round_step`` runs their local SGD and
the unbiased eq.-(4) aggregation with the coefficients ``w / (K q)``
(``aggregation_weights``): one ``fl_aggregate`` kernel launch per round
on the card.

    PYTHONPATH=src python examples/lm_federated_torch.py [--rounds 15] \
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (LROAController, estimate_hyperparams,
                              paper_default_params)
from repro_torch.data import synthetic_lm_tokens
from repro_torch.fl import ChannelConfig, ChannelProcess, sample_clients
from repro_torch.fl.server import aggregation_weights
from repro_torch.launch.steps import build_model, make_fl_round_step
from repro_torch.models.transformer import param_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--arch", default="gemma-2b",
                    help="smoke variant of this arch is trained")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: the card)")
    args = ap.parse_args(argv)

    n, k = args.devices, 2
    device = torch.device(args.device)
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    d = param_count(params)
    print(f"model: {cfg.name} ({d/1e6:.2f}M params)")

    # per-client token shards (zipf-bigram synthetic corpus)
    rng = np.random.default_rng(0)
    shards = [synthetic_lm_tokens(8, 33, cfg.vocab_size, seed=i)
              for i in range(n)]
    sizes = np.asarray([s.size for s in shards], np.float32)

    sys_params = paper_default_params(num_devices=n, data_sizes=sizes,
                                      model_params=d, device=device)
    hp = estimate_hyperparams(sys_params, 0.1, loss_scale=5.0)
    controller = LROAController(sys_params, hp)
    channel = ChannelProcess(n, ChannelConfig(seed=0))
    w = sys_params.data_weights.cpu().numpy()

    round_step = make_fl_round_step(cfg, k, lr=0.3, local_steps=4,
                                    device=device)

    for t in range(args.rounds):
        h = torch.as_tensor(channel.sample(), dtype=torch.float32,
                            device=device)
        dec = controller.decide(h)
        q = dec.q.cpu().numpy()
        selected = sample_clients(rng, q, k)
        coeffs = aggregation_weights(selected, q, w, k)
        toks = np.stack([shards[i] for i in selected])    # [K, B, S+1]
        batch = {"tokens": torch.as_tensor(toks[:, :, :-1], device=device),
                 "labels": torch.as_tensor(toks[:, :, 1:], device=device),
                 "coeffs": torch.as_tensor(coeffs, device=device)}
        params, metrics = round_step(params, batch)
        controller.step_queues(h, dec)
        print(f"round {t:3d}  clients {selected.tolist()}  "
              f"loss {float(metrics['loss']):.4f}")

    print("\nfederated LM training ran end-to-end (K clients' local SGD + "
          "the eq.-(4) fl_aggregate step).")


if __name__ == "__main__":
    main()
