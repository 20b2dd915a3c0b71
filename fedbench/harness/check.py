"""The check that decides ``correct``: a sample of lane-rounds of the run,
drawn from the seed, recomputed by the plain reference and compared.

For each sampled lane-round of the window the reference starts from the
carry the run held before the round (its params and queues) and
recomputes the round from the benchmark's inputs: the controller's
decision, the queues and modelled metrics of eq. (9)-(20), a judgement
of the run's selection against the reference's q (or, for DivFL, its
greedy gains), every selected client's E epochs of SGD and the eq.-(4)
step.  The start, round 0 of the same lanes, is checked from the
benchmark's own initial weights and zero queues alone, its control
plane only.  The in-rollout evaluation (the initial one and the
window's first) is recomputed on the params the run evaluated.

The numbers, each over the sampled lane-rounds by the statistic the
cell's limits file names for it (:func:`statistic`; the largest unless
it says otherwise):

* ``decide_gap``  the queues after the round, the slowest selected
  client's round time, the selected clients' mean energy and q's
  extremes, each against the reference's, relative;
* ``select_gap``  how far a slot's draw lies outside its client's
  cumulative-q interval (probability units), or a greedy pick's gain
  below the best (relative);
* ``update_gap``  |theta'_run - theta'_ref| / |theta'_ref - theta|: the
  eq.-(4) update's direction;
* ``update_norm_gap``  | |theta'_run - theta| - |theta'_ref - theta| | /
  |theta'_ref - theta|: its length;
* ``loss_gap``    the lane's mean client loss, relative;
* ``eval_gap``    the in-rollout test loss, relative (the accuracy's gap
  is kept beside it as ``eval_accuracy_gap``, not compared).

A limit of None in a cell's limits file leaves that number uncompared
(``PERF.md`` says for which cell and why); it is still reported.

``control=True`` puts the reference, computed in bfloat16, in the
program's place: its outputs are judged as the run's would be.
``fault=<name>`` puts the reference, in float32, in the program's place
with one of :data:`FAULTS` planted in it; ``calibrate.py`` reads both to
set the limits from.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fedbench.reference import control as rc
from fedbench.reference import draws
from fedbench.reference import train as rt

NUMBERS = ("decide_gap", "select_gap", "update_gap", "update_norm_gap",
           "loss_gap", "eval_gap")


@contextlib.contextmanager
def no_tf32():
    """float32 products and convolutions as float32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass
class Lane:
    name: str          # controller
    seed_index: int    # which channel sequence
    key: np.uint64     # rollout key


class Checker:
    """Holds the inputs both sides were handed and recomputes rounds."""

    def __init__(self, config: dict, traffic: dict, inputs, device):
        self.config, self.traffic = config, traffic
        self.model = config["model"]
        self.device = device
        self.k = int(traffic["sample_count"])
        self.epochs = int(config["client"]["local_epochs"])
        self.bs = int(config["client"]["batch_size"])
        self.momentum = float(config["client"]["momentum"])
        self.lr = _lr(config)
        self.V = float(np.float32(traffic["V"]))
        self.lam = float(np.float32(traffic["lam"]))
        self.sizes = inputs.sizes
        self.clients = inputs.client_data
        self.test = inputs.test
        self.params0 = {k: v.detach().to("cpu", copy=True).numpy()
                        for k, v in inputs.params0.items()}
        self.h = inputs.h_seeds.cpu().numpy().astype(np.float64)
        n = traffic["seeds_per_controller"]
        self.lanes = [Lane(name, j, draws.rollout_key(
            int(inputs.lane_seeds[j])))
            for name in traffic["controllers"] for j in range(n)]
        self._test_dev = {}

    def system(self, dtype) -> rc.System:
        return rc.System.from_config(self.config["system"], self.sizes,
                                     self.k, self.epochs, dtype=dtype)

    def _client(self, j: int, dtype):
        x, y = self.clients[j]
        return (torch.as_tensor(x, device=self.device).to(dtype),
                torch.as_tensor(y.astype(np.int64), device=self.device))

    def _dev(self, params: dict, dtype) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device).to(dtype)
                for k, v in params.items()}

    # -- one round, as the reference computes it -----------------------------

    def decide(self, lane: Lane, t: int, queues, dtype):
        sys = self.system(dtype)
        h = torch.as_tensor(self.h[lane.seed_index, t], dtype=dtype)
        q0 = torch.as_tensor(np.asarray(queues, np.float64), dtype=dtype)
        f, p, q = rc.decide(lane.name, sys, h, q0, self.V, self.lam)
        return sys, h, q0, f, p, q

    def train(self, lane: Lane, t: int, params: dict, q, selected,
              dtype, half: bool = False) -> tuple:
        """Every slot's SGD from ``params`` and the eq.-(4) step, with the
        coefficients w_n / (K q_n); returns ``(params', mean loss)``.
        ``half`` plants a fault: the step takes the first half of the
        slots alone, their coefficients scaled up by K over their
        number."""
        theta = self._dev(params, dtype)
        w = self.sizes / self.sizes.sum()
        qn = q.double().numpy()
        deltas, losses, coeffs = [], [], []
        for slot, j in enumerate(np.asarray(selected, np.int64)):
            x, y = self._client(int(j), dtype)
            d, loss = rt.client_round(self.model, theta, x, y, lane.key, t,
                                      slot, self.epochs, float(self.lr[t]),
                                      self.bs, self.momentum)
            deltas.append(d)
            losses.append(loss)
            coeffs.append(w[j] / (self.k * qn[j]))
        if half:
            keep = (self.k + 1) // 2
            deltas = deltas[:keep]
            coeffs = [c * self.k / keep for c in coeffs[:keep]]
        out = rt.aggregate(theta, deltas, coeffs)
        return ({k: v.float().cpu().numpy() for k, v in out.items()},
                float(np.mean(losses)))

    def evaluate(self, params: dict, dtype) -> Dict[str, float]:
        if dtype not in self._test_dev:
            x, y = self.test
            self._test_dev[dtype] = (
                torch.as_tensor(x, device=self.device).to(dtype),
                torch.as_tensor(y.astype(np.int64), device=self.device))
        return rt.evaluate(self.model, self._dev(params, dtype),
                           *self._test_dev[dtype])

    # -- what the control, or a fault, puts in the program's place ------------

    def control_outputs(self, item, pre_params, pre_queues,
                        data_plane: bool = True, fault: str = None) -> dict:
        """The round computed by the reference in bfloat16 (the control)
        or, with ``fault``, in float32 with that fault planted: the
        outputs the check then judges."""
        lane = self.lanes[item.lane]
        t = item.round
        dtype = torch.bfloat16 if fault is None else torch.float32
        sys, h, q0, f, p, q = self.decide(lane, t, pre_queues, dtype)
        u = draws.slot_uniforms(lane.key, t, self.k)
        selected = rc.select(lane.name, sys, q.double(), h.double(), u)
        if fault == "selection_altered":
            selected = np.asarray(selected, np.int64).copy()
            selected[0] = (selected[0] + 1) % len(self.sizes)
        nq, outs = rc.round_outputs(sys, h, f, p, q, q0, selected)
        params = loss = None
        if data_plane:
            with no_tf32():
                params, loss = self.train(
                    lane, t, pre_params, q, selected, dtype,
                    half=fault == "half_the_batch")
            if fault == "state_unchanged":
                params = {k: np.array(v, np.float32, copy=True)
                          for k, v in pre_params.items()}
        return {"params": params, "queues": nq.float().numpy(),
                "selected": selected, "loss": loss, **outs}

    # -- the judgement ----------------------------------------------------

    def judge_round(self, item, pre_params, pre_queues, out: dict,
                    data_plane: bool = True) -> Dict[str, float]:
        """The numbers of one lane-round whose outputs are ``out``; with
        ``data_plane`` False, the control plane's alone."""
        lane = self.lanes[item.lane]
        t = item.round
        sys, h, q0, f, p, q = self.decide(lane, t, pre_queues,
                                          torch.float64)
        selected = np.asarray(out["selected"], np.int64)[:self.k]
        u = draws.slot_uniforms(lane.key, t, self.k)
        select_gap = rc.selection_gap(lane.name, sys, q, h, u, selected)
        nq, ref = rc.round_outputs(sys, h, f, p, q, q0, selected)
        budget = float(self.config["system"]["energy_budget_j"])
        got_q = torch.as_tensor(np.asarray(out["queues"], np.float64))
        gaps = [float(torch.max(torch.abs(got_q - nq)))
                / (float(torch.max(nq)) + budget),
                abs(out["queue_mean"] - ref["queue_mean"])
                / (ref["queue_mean"] + budget)]
        for name in ("wall_time", "energy_mean"):
            gaps.append(abs(out[name] - ref[name]) / abs(ref[name]))
        for name in ("q_min", "q_max"):
            gaps.append(abs(out[name] - ref[name]) / ref["q_max"])
        plane = {"decide_gap": max(gaps), "select_gap": select_gap}
        if not data_plane:
            return plane
        with no_tf32():
            params, loss = self.train(lane, t, pre_params, q, selected,
                                      torch.float32)
        diff = run_len = ref_len = 0.0
        for k in params:
            pre = np.asarray(pre_params[k], np.float64)
            d_run = out["params"][k].astype(np.float64) - pre
            d_ref = params[k].astype(np.float64) - pre
            diff += float(np.sum((d_run - d_ref) ** 2))
            run_len += float(np.sum(d_run ** 2))
            ref_len += float(np.sum(d_ref ** 2))
        ref_len = max(np.sqrt(ref_len), 1e-300)
        return {**plane, "update_gap": float(np.sqrt(diff) / ref_len),
                "update_norm_gap": float(abs(np.sqrt(run_len) - ref_len)
                                         / ref_len),
                "loss_gap": abs(out["loss"] - loss) / abs(loss)}

    def judge_eval(self, params: dict, acc: float, loss: float
                   ) -> Dict[str, float]:
        with no_tf32():
            ref = self.evaluate(params, torch.float32)
        return {"eval_gap": abs(loss - ref["loss"]) / ref["loss"],
                "eval_accuracy_gap": abs(acc - ref["accuracy"])}


def _lr(config: dict) -> np.ndarray:
    from fedbench.harness.cell import lr_schedule
    return lr_schedule(config["lr"], int(config["rounds"]))


def run_outputs(item, columns: dict, k: int) -> dict:
    """The run's outputs of one lane-round: its carry after the round and
    its metric columns' row."""
    s, t = item.lane, item.round
    out = {"params": item.post["params"], "queues": item.post["queues"],
           "selected": columns["selected"][s, t, :k]}
    for name in ("loss", "wall_time", "energy_mean", "q_min", "q_max",
                 "queue_mean"):
        out[name] = float(columns[name][s, t])
    return out


#: the faults ``fault=`` plants in the reference put in the program's
#: place: the data plane's state returned unchanged, half of the K slots
#: left out of the step (the mean taken over the rest), a selected client
#: altered where it is drawn, the test loss altered where it is computed
FAULTS = ("state_unchanged", "half_the_batch", "selection_altered",
          "test_loss_altered")

#: how a number is taken over the sampled lane-rounds: the largest, or
#: the second largest (the largest once the single worst lane-round is
#: left out, so a fault has to show in two of them)
STATISTICS = {"max": lambda v: float(np.max(v)),
              "second": lambda v: float(np.sort(v)[-2] if v.size > 1
                                        else np.max(v))}


def statistic(limits: Optional[dict], name: str) -> str:
    """The statistic a cell's limits file names for ``name`` under
    ``"statistics"``; the largest by default."""
    return ((limits or {}).get("statistics") or {}).get(name, "max")


def check(checker: Checker, window, control: bool = False,
          details: Optional[list] = None, limits: Optional[dict] = None,
          fault: Optional[str] = None) -> Dict[str, float]:
    """Every number of the run (or of the control, or of a fault, in its
    place) over the sampled lane-rounds, each by :func:`statistic` of
    the cell's ``limits``; ``details`` (a list) gains each lane-round's
    own."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"no fault {fault!r} (have: {FAULTS})")
    ref_place = control or fault is not None
    store = window.store
    columns = store.columns
    got_all: Dict[str, list] = {}
    rounds = [it for it in store.start_items]
    for items in store.window_items:
        rounds += items
    for item in rounds:
        if item.pre is None:
            pre_params, pre_queues = checker.params0, np.zeros(
                checker.sizes.shape, np.float32)
        else:
            pre_params, pre_queues = item.pre["params"], item.pre["queues"]
        # the start round's data plane is not compared: the first local
        # epochs from random weights amplify rounding too much to judge
        # (PERF.md, the check); its control plane is
        data_plane = item.pre is not None
        if ref_place:
            out = checker.control_outputs(item, pre_params, pre_queues,
                                          data_plane, fault)
        else:
            out = run_outputs(item, columns, checker.k)
        got = checker.judge_round(item, pre_params, pre_queues, out,
                                  data_plane)
        if details is not None:
            details.append(dict(got, lane=item.lane, round=item.round))
        for name, v in got.items():
            got_all.setdefault(name, []).append(v)
    evals = [(it, checker.params0, 0) for it in store.start_items]
    evals += [(it, it.post["params"], it.round) for it in store.eval_items]
    for item, params, t in evals:
        if ref_place:
            with torch.no_grad(), no_tf32():
                ev = checker.evaluate(params, torch.bfloat16 if control
                                      else torch.float32)
            acc, loss = ev["accuracy"], ev["loss"]
            if fault == "test_loss_altered":
                loss *= 1.01
        else:
            acc = float(columns["test_accuracy"][item.lane, t])
            loss = float(columns["test_loss"][item.lane, t])
        got = checker.judge_eval(params, acc, loss)
        if details is not None:
            details.append(dict(got, lane=item.lane, round=t))
        for name, v in got.items():
            got_all.setdefault(name, []).append(v)
    numbers = {}
    for name in NUMBERS + ("eval_accuracy_gap",):
        vals = np.asarray(got_all.get(name, [0.0]), np.float64)
        if np.any(np.isnan(vals)):
            numbers[name] = float("nan")
        else:
            numbers[name] = STATISTICS[statistic(limits, name)](vals)
    return numbers


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number finite and within its limit."""
    return all(np.isfinite(numbers[n]) and numbers[n] <= limits[n]
               for n in NUMBERS if limits.get(n) is not None)
