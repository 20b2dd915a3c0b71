"""How far the arena's S·K-client SGD drifts from the K-client SGD of a
``run_scan`` round, on a GPU machine at paper scale (``chip_smoke.py``'s
testbed): the K clients LROA picks in round 0, trained once as K clients
from one model and once repeated over 7 lanes (``batched_local_sgd(...,
per_client=True)`` over 7·K clients), for 1, 8, 32 and all of the bank's
steps per epoch, with cuDNN's deterministic algorithms and without, and
with the step masks (``num_steps`` / ``num_examples``, as every round
passes them) and without.  Prints one JSON line per case: the largest
difference of the deltas and of the losses, non-finite counts and the
largest loss.  ``cpu`` as the argument runs the small testbed on the
CPU instead, as a rehearsal.

    PYTHONPATH=src python tools/torch_sgd_lanes_probe.py [cpu]
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.fl import ChannelConfig, ChannelProcess  # noqa: E402
from repro_torch.fl import client as fc  # noqa: E402
from repro_torch.fl import round_engine as re_  # noqa: E402

LANES = 7


def main(device: str = "cuda") -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cs.SMALL if device == "cpu" else cs.PAPER_SCALE
    data = cs.make_data(cfg)
    tr = cs.build_trainer(device, cfg, data, bank_mode="single")
    eng, bank = tr.engine, tr.bank
    hp = tr.controller.hp
    init = tr.task.init(torch.Generator(device=device).manual_seed(
        cfg["seed"] + 1))
    h = ChannelProcess(cfg["num_devices"], ChannelConfig(
        seed=cfg["seed"])).sample_sequence(1)
    lr = tr.lr_schedule(0)
    _, _, met = eng.run_scan(init, tr.params, bank, h, [lr],
                             torch.Generator().manual_seed(cfg["seed"]),
                             policy="lroa", V=hp.V, lam=hp.lam)
    sel = torch.as_tensor(np.asarray(met["selected"][0], np.int64),
                          device=device)
    k = int(sel.numel())
    e, rows = eng.cfg.local_epochs, bank.bucket_examples
    keys = torch.rand((k, e, rows), device=device,
                      generator=torch.Generator(device=device).manual_seed(3))
    print(json.dumps(dict(clients=sel.tolist(), rows=rows,
                          steps_per_epoch=bank.steps_per_epoch,
                          num_steps=bank.num_steps[sel].tolist(),
                          lr=float(lr))), flush=True)

    def sgd(starts, idx, sort_keys, steps, per_client, masks):
        # the engine's gather: f32 features, int64 labels and masks
        xs, ys, ns, ne = re_._gather(bank, idx)
        return fc.batched_local_sgd(
            eng.task.loss_fn, starts, xs, ys, lr, eng.cfg, steps,
            num_steps=ns if masks else None,
            num_examples=ne if masks else None,
            sort_keys=sort_keys, per_client=per_client)

    def nonfinite(d):
        return sum(int((~torch.isfinite(v)).sum()) for v in d.values())

    starts = {n: v.unsqueeze(0).expand((LANES * k,) + tuple(v.shape))
              .contiguous() for n, v in init.items()}
    for steps in [s for s in (1, 8, 32) if s < bank.steps_per_epoch] + [
            bank.steps_per_epoch]:
        for det in (True, False):
            for masks in (True, False):
                with cs.cudnn_deterministic(det):
                    da, la = sgd(init, sel, keys, steps, False, masks)
                    db, lb = sgd(starts, sel.repeat(LANES),
                                 keys.repeat(LANES, 1, 1), steps, True,
                                 masks)
                    tr._sync()
                err = max(float((db[n].reshape((LANES,) + tuple(da[n].shape))
                                 - da[n]).abs().max()) for n in da)
                print(json.dumps(dict(
                    steps=steps, cudnn_deterministic=det, masks=masks,
                    delta_max_abs_diff=err,
                    loss_max_abs_diff=float((lb.reshape(LANES, k) - la)
                                            .abs().max()),
                    nonfinite=[nonfinite(da), nonfinite(db)],
                    loss_max=[float(la.abs().max()), float(lb.abs().max())]
                )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
