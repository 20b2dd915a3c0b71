"""How far two float32 runs of the quickstart (``examples/quickstart.py``:
LROA's Algorithm 2, 40 devices, 400 rounds) drift apart.

    PYTHONPATH=src python tests/quickstart_drift.py run --device cuda \
        --out card.json                      # quickstart_torch.run
    PYTHONPATH=src python tests/quickstart_drift.py jax --out jax.json
    PYTHONPATH=src python tests/quickstart_drift.py compare card.json \
        cpu.json
    PYTHONPATH=src python tests/quickstart_drift.py shared --rounds 100 \
        --sides cpu:float32,cuda:float32 --out shared.json

``run``: ``quickstart_torch.run(rounds, device)`` with its seconds and the
loop tests its solver made (each check of the SUM and outer loops'
conditions, counted by wrapping ``repro_torch.core.solver._above``).
``jax``: the JAX script in a subprocess on the CPU (it needs ``jax`` and
the ``repro`` package; this process imports neither), each printed
round's numbers unrounded.  ``compare``: each printed number's relative
error, ``a`` against ``b``.  ``shared``: ``decide`` on two sides from
one state each round (``--sides``, ``device:dtype`` pairs; both
controllers' queues are the first side's after its queue update), so
each round's error is that of one ``decide`` alone: the relative error
of the modelled latency and the largest errors of q, f and p, with each
side's loop tests.  ``float64`` (``--float64`` of ``run``): the same
solver in float64, its ``SystemParams`` fields cast to float64 so that
every operation on them is promoted (the float32 channel draws and data
weights are the same bits on every device), to tell rounding at the
float32 loop tolerances from a fault.  ``--perturb
REL`` (``run``): each round's channel gains times ``1 + REL * z``, ``z``
standard normal from seed 1, to measure how far an input error of that
size moves the rollout.  Each mode prints JSON lines and ``--out`` writes
its result."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

KEYS = ("latency", "q_min", "q_max", "queue_max", "avg_energy")


class LoopTests:
    """Counts the solver's loop-condition checks while entered."""

    def __enter__(self):
        import repro_torch.core.solver as slv

        self.n, self._slv, self._above = 0, slv, slv._above

        def counted(value, tol):
            self.n += 1
            return self._above(value, tol)

        slv._above = counted
        return self

    def __exit__(self, *exc):
        self._slv._above = self._above


def as_float64(params):
    """``params`` with its per-device fields in float64."""
    from repro_torch.core.system_model import ARRAY_FIELDS

    return dataclasses.replace(params, **{
        name: getattr(params, name).double() for name in ARRAY_FIELDS})


def run_port(rounds: int, device: str, float64: bool = False,
             perturb: float = 0.0) -> dict:
    import quickstart_torch

    make = quickstart_torch.paper_default_params
    channel = quickstart_torch.ChannelProcess
    if float64:
        quickstart_torch.paper_default_params = (
            lambda **kw: as_float64(make(**kw)))
    if perturb:
        rng = np.random.default_rng(1)

        class Perturbed(channel):
            def sample(self):
                h = super().sample()
                return h * (1 + perturb * rng.standard_normal(h.shape))

        quickstart_torch.ChannelProcess = Perturbed
    try:
        with LoopTests() as tests:
            t0 = time.perf_counter()
            out = quickstart_torch.run(rounds=rounds, device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
    finally:
        quickstart_torch.paper_default_params = make
        quickstart_torch.ChannelProcess = channel
    out.update(device=device, loop_tests=tests.n, float64=float64,
               perturb=perturb)
    return out


def run_jax(rounds: int) -> dict:
    """The JAX script's printed rounds, unrounded (its source patched to
    print them as JSON beside its own lines)."""
    code = r'''
import json, sys
src = open(sys.argv[1]).read()
old = "N_DEVICES, ROUNDS = 40, 400"
assert old in src
src = src.replace(old, "N_DEVICES, ROUNDS = 40, " + sys.argv[2])
line = 'print(f"round {t:4d}'
assert line in src
src = src.replace(line, 'print("ROW", json.dumps([t, lat, float(decision.q.min()), float(decision.q.max()), float(controller.queues.max()), float(energy.mean() / (t + 1))]))\n        ' + line)
src = src.replace('print(f"lambda', 'print("HP", json.dumps([float(hp.lam), float(hp.V)]))\nprint(f"lambda')
exec(compile(src, sys.argv[1], "exec"), {"__name__": "__main__", "json": json})
'''
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    t0 = time.perf_counter()
    text = subprocess.run(
        [sys.executable, "-c", code,
         os.path.join(ROOT, "examples", "quickstart.py"), str(rounds)],
        env=env, check=True, capture_output=True, text=True).stdout
    out = dict(device="jax-cpu", rounds=[], seconds=time.perf_counter() - t0)
    for line in text.splitlines():
        if line.startswith("HP "):
            out["lam"], out["V"] = json.loads(line[3:])
        elif line.startswith("ROW "):
            t, *vals = json.loads(line[4:])
            out["rounds"].append(dict(round=t, **dict(zip(KEYS, vals))))
    return out


def compare(a: dict, b: dict) -> list:
    """Each printed round's relative errors, ``a`` against ``b``."""
    rows = []
    for ra, rb in zip(a["rounds"], b["rounds"]):
        assert ra["round"] == rb["round"]
        rows.append(dict(round=ra["round"], **{
            k: abs(ra[k] - rb[k]) / abs(rb[k]) for k in KEYS}))
    return rows


def run_shared(rounds: int, sides: list) -> list:
    """``decide`` on each side, a ``(device, dtype)``, from the first
    side's state each round."""
    from repro_torch.core import (LROAController, estimate_hyperparams,
                                  paper_default_params)
    from repro_torch.core import system_model as sm
    from repro_torch.fl import ChannelConfig, ChannelProcess

    n = 40
    sizes = np.random.default_rng(0).integers(200, 600, n).astype(np.float32)
    params = [paper_default_params(num_devices=n, data_sizes=sizes,
                                   device=dev) for dev, _ in sides]
    params = [as_float64(p) if dtype == "float64" else p
              for p, (_, dtype) in zip(params, sides)]
    hp = estimate_hyperparams(params[0], mean_gain=0.1, loss_scale=1.5,
                              mu=1.0, nu=1e3)
    ctrl = [LROAController(p, hp) for p in params]
    channel = ChannelProcess(n, ChannelConfig(seed=0))
    rows = []
    for t in range(rounds):
        h = channel.sample()
        got = []
        for (dev, _), p, c in zip(sides, params, ctrl):
            hd = torch.as_tensor(h, dtype=torch.float32, device=dev)
            with LoopTests() as tests:
                dec = c.decide(hd)
            assert dec.q.dtype == p.f_max.dtype
            lat = float(sm.expected_round_latency(
                dec.q, sm.round_time(p, hd, dec.p, dec.f)))
            got.append((hd, dec, lat, tests.n))
        (h0, d0, l0, n0), (_, d1, l1, n1) = got[:2]
        rows.append(dict(
            t=t, latency=[l0, l1], rel=abs(l1 - l0) / abs(l0),
            loop_tests=[n0, n1],
            **{f"{k}_err": float(((b.cpu().double() - a.cpu().double())
                                  / a.cpu().double()).abs().max())
               for k, a, b in zip(("f", "p", "q"), d0, d1)},
            queue_max=float(ctrl[0].queues.max())))
        ctrl[0].step_queues(h0, d0)
        for (dev, _), p, c in zip(sides[1:], params[1:], ctrl[1:]):
            c.queues = ctrl[0].queues.to(dev, p.f_max.dtype)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("run", "jax", "compare", "shared"))
    ap.add_argument("files", nargs="*")
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sides", default="cpu:float32,cuda:float32")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--perturb", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.mode == "run":
        out = run_port(args.rounds, args.device, args.float64,
                       args.perturb)
    elif args.mode == "jax":
        out = run_jax(args.rounds)
    elif args.mode == "compare":
        a, b = (json.load(open(f)) for f in args.files)
        rows = compare(a, b)
        out = dict(a=a["device"], b=b["device"], rows=rows,
                   max={k: max(r[k] for r in rows) for k in KEYS},
                   loop_tests=[a.get("loop_tests"), b.get("loop_tests")])
    else:
        rows = run_shared(args.rounds, [tuple(side.split(":"))
                                        for side in args.sides.split(",")])
        over = [r["t"] for r in rows if r["rel"] > 1e-4]
        out = dict(sides=args.sides, rows=rows,
                   max_rel=max(r["rel"] for r in rows),
                   rounds_over_1e_4=over,
                   loop_tests=[sum(r["loop_tests"][i] for r in rows)
                               for i in (0, 1)],
                   rounds_with_other_loop_tests=sum(
                       r["loop_tests"][0] != r["loop_tests"][1]
                       for r in rows))
    for key, val in out.items():
        if key != "rows":
            print(json.dumps({key: val}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    main()
