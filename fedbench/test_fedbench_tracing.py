"""The per-layer metrics read from the program's own tracer
(``select_s_per_round``, ``solver_syncs_per_round``,
``sgd_stall_s_per_round``): a toy traced run on the CPU reports the
first two; a program whose tracer keeps no totals gives none of them
and raises nothing; on the card the data plane's device time covers its
kernels."""

import time

import pytest
import torch

from fedbench.conftest import CELLS, toy_cell
from fedbench.harness import main as hmain

TRACER = ("select_s_per_round", "solver_syncs_per_round",
          "sgd_stall_s_per_round")


def test_a_traced_toy_run_reports_the_tracers_metrics(toy):
    res = toy(CELLS[0], trace=True)
    metrics = res["line"]["metrics"]
    assert res["line"]["correct"] is True
    assert metrics["select_s_per_round"]["value"] > 0
    assert metrics["select_s_per_round"]["unit"] == "s"
    # LROA's lanes test their loops every round
    assert metrics["solver_syncs_per_round"]["value"] > 0
    assert metrics["solver_syncs_per_round"]["unit"] == "syncs"
    # the CPU has no device time
    assert "sgd_stall_s_per_round" not in metrics
    # the seconds in the selections lie inside the rounds' dispatch
    assert (metrics["select_s_per_round"]["value"]
            < max(res["notes"]["round_s"]))


@pytest.mark.parametrize("name", TRACER)
def test_a_program_without_tracer_totals_gives_nothing(name, monkeypatch):
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "totals")
    ctx = hmain.Context(digest=None, rounds=3, lanes=2, k=3, params=10,
                        useful_rows=1, trained_rows=2, work_flops=1.0,
                        mfu_s=1.0, peak_flops=1.0)
    assert hmain.reader(name).read(ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_data_planes_device_time_covers_its_kernels(card):
    from repro_torch.obs import trace

    res = hmain.run(toy_cell(CELLS[0]), 2 ** 31 + 123, 3.0, True,
                    time.perf_counter(), device="cuda")
    metrics = res["line"]["metrics"]
    assert res["line"]["correct"] is True
    assert set(TRACER) <= set(metrics)
    assert metrics["sgd_stall_s_per_round"]["value"] >= 0
    rounds = res["notes"]["traced_rounds"]
    device_s = trace.totals()["engine.lanes_round"]["device_s"]
    union = metrics["sgd_device_s_per_round"]["value"] * rounds
    assert device_s >= union > 0
