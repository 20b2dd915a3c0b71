"""Each cell's code path at a toy size on the CPU: a run and a traced run
come out correct with their metrics; the control (the reference in
bfloat16 in the program's place), the reference with a fault planted in
the program's place, and a run with the timed path broken underneath
come out not correct.  (One chip: no exchange between chips to leave
out.)"""

import numpy as np
import pytest
import torch

from fedbench.conftest import CELLS
from fedbench.harness import check as hcheck


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_is_correct_and_reports_its_metrics(cell, trace, toy):
    res = toy(cell, trace=trace)
    line = res["line"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert list(line)[-1] == "checks"
    names = set(line["metrics"])
    if trace:
        # on the CPU the trace holds no device time: only the counters
        assert {"useful_row_share", "round_mfu",
                "decide_s_per_round"} <= names
        assert 0 < line["metrics"]["useful_row_share"]["value"] <= 100
        assert "breakdown" in line
        # the share of the peak counts the rounds before the profiler
        notes = res["notes"]
        assert 0 < notes["mfu_rounds"] < notes["window_rounds"]
        assert notes["traced_rounds"] > 0
        assert (notes["mfu_rounds"] + notes["traced_rounds"]
                <= notes["window_rounds"])
    else:
        assert names == {"lane_rounds_per_s", "setup_s"}
        assert line["metrics"]["lane_rounds_per_s"]["value"] > 0
    assert res["notes"]["signatures_traced_in_window"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell, toy):
    assert toy(cell, control=True)["line"]["correct"] is False


@pytest.mark.parametrize("fault", hcheck.FAULTS)
def test_a_fault_in_the_reference_in_its_place_comes_out_not_correct(
        fault, toy):
    assert toy(CELLS[0], fault=fault)["line"]["correct"] is False


def test_the_second_statistic_leaves_out_one_lane_round_alone():
    lim = {"statistics": {"update_gap": "second"}}
    assert hcheck.statistic(lim, "update_gap") == "second"
    assert hcheck.statistic(lim, "decide_gap") == "max"
    assert hcheck.statistic(None, "update_gap") == "max"
    second = hcheck.STATISTICS["second"]
    assert second(np.array([1e-3, 0.9, 2e-3])) == 2e-3
    assert second(np.array([1e-3, 0.9, 0.8])) == 0.8
    assert second(np.array([0.5])) == 0.5


def _unchanged(orig):
    def agg(params, deltas, coeffs, impl="auto"):
        return {k: v.clone() for k, v in params.items()}
    return agg


def _half_the_batch(orig):
    def agg(params, deltas, coeffs, impl="auto"):
        k = coeffs.shape[1]
        keep = (k + 1) // 2
        c = torch.zeros_like(coeffs)
        c[:, :keep] = coeffs[:, :keep] * (k / keep)
        return orig(params, deltas, c, impl=impl)
    return agg


def _altered_selection(orig):
    def select(cid, sp, t, h, queues, q, key, slots, kvec):
        out = orig(cid, sp, t, h, queues, q, key, slots, kvec).clone()
        out[0] = (out[0] + 1) % sp.num_devices
        return out
    return select


def _altered_test_loss(orig):
    def make_eval_fn(task):
        fn = orig(task)

        def eval_fn(params, data):
            out = dict(fn(params, data))
            out["loss"] = out["loss"] * 1.01
            return out
        return eval_fn
    return staticmethod(make_eval_fn)


FAULTS = {
    "state_unchanged": ("repro_torch.fl.server", "aggregate_fused_lanes",
                        _unchanged),
    "half_the_batch": ("repro_torch.fl.server", "aggregate_fused_lanes",
                       _half_the_batch),
    "selection_altered": ("repro_torch.core.policy", "select_by_id",
                          _altered_selection),
    "test_loss_altered": ("repro_torch.sim.eval", "EvalBank",
                          _altered_test_loss),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_comes_out_not_correct(fault, toy, monkeypatch):
    import importlib

    module, name, make = FAULTS[fault]
    mod = importlib.import_module(module)
    if name == "EvalBank":
        monkeypatch.setattr(mod.EvalBank, "make_eval_fn",
                            make(mod.EvalBank.make_eval_fn))
    else:
        monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    assert toy(CELLS[0])["line"]["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_command_runs_a_short_window_on_the_card(card):
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 9), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
