"""BENCHMARK.json and the files each cell names, checked against the
benchmark's contract: names, units, keys, and every file found by name."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "fedbench/run.py"]
    assert MANIFEST["paths"] == ["fedbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"]
                         + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_units_and_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] == "lane_rounds_per_s"
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert {"setup_s", "lane_rounds_per_s"} <= names
    assert MANIFEST["per_layer"]


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_each_cells_files_are_found_by_name(cell):
    from fedbench.harness import main as hmain

    assert cell["chips"] == 1
    assert TEXT.match(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    found = hmain.find_cell(cell["name"])
    assert found.config["model"]["task"] == "cnn"
    assert found.traffic["controllers"]
    assert found.limits is not None
    for m in found.per_layer:
        assert callable(importlib.import_module(
            f"fedbench.metrics.{m['name']}").read)


@pytest.mark.parametrize("conf", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_configs_state_source_cuts_and_precision(conf):
    path = ROOT / conf["file"]
    assert path.is_file() and conf["file"].startswith("fedbench/")
    body = json.loads(path.read_text())
    assert body["source"] == conf["source"]
    assert body["reduced"] == conf["reduced"]
    assert all(NAME.match(k) for k in conf["reduced"])
    assert body["assumed"] and body["precision"]
    assert TEXT.match(conf["why"]) and TEXT.match(conf["source"])


def test_config_files_are_distinct_and_pairs_appear_once():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
