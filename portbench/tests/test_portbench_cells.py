"""BENCHMARK.json and the files it names: each configuration, mix and
metric is found by name, and a new cell is taken from added files."""
import json
import re
import shutil

import pytest

from portbench import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.endswith("_torch") for p in BENCH["paths"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_found_by_name(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = cells.load_json("configs", config)
    assert entry["file"] == f"portbench/configs/{config}.json"
    assert data["name"] == config and data["source"] == entry["source"]
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    for key in entry["reduced"]:
        assert data[key] != data["published"][key]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_plans(cell):
    plan = cells.plan(BENCH, cell)
    assert plan.mix["name"] == plan.cell["traffic"]
    names = {m["name"] for m, _ in plan.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert plan.per_layer
    for m, _ in plan.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_reader_agrees_with_benchmark(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = cells.load_reader("layer_metrics", metric)
    assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["unit"], entry["layer"], entry["moves"])
    assert entry["moves"] in E2E
    assert set(entry["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("metric", sorted(E2E))
def test_end_to_end_reader_is_found(metric):
    entry = next(m for m in BENCH["end_to_end"] if m["name"] == metric)
    assert cells.load_reader("end_to_end", metric).UNIT == entry["unit"]
    assert entry["source"] in ("host_clock", "device_trace")
    assert 0.01 <= entry["bound"] <= 0.25


def test_a_new_cell_from_added_files_only(tmp_path):
    """A configuration, a mix and a metric added as files, and a cell
    added to BENCHMARK.json, are found without editing a file."""
    base = tmp_path / "portbench"
    shutil.copytree(cells.HERE, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((base / "configs" / "bit1_q4.json").read_text())
    (base / "configs" / "bit1_q8.json").write_text(json.dumps(
        {**cfg, "name": "bit1_q8", "n_cells": 12500}))
    (base / "mixes" / "dense.json").write_text(json.dumps(
        {"name": "dense", "steps_per_diag": 10, "diags_per_period": 5,
         "checkpoint": False}))
    (base / "layer_metrics" / "steps_seen.py").write_text(
        'UNIT = "steps"\nLAYER = "device"\nMOVES = "step_ms"\n\n\n'
        'def read(run):\n    return run["steps"]\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "bit1_q8", "source": "x",
                             "file": "portbench/configs/bit1_q8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "bit1_q8.dense", "config": "bit1_q8",
                               "traffic": "dense", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "step_ms",
                               "workloads": ["bit1_q8.dense"]})
    plan = cells.plan(bench, "bit1_q8.dense", base)
    assert plan.config["n_cells"] == 12500
    assert plan.mix["steps_per_diag"] == 10
    got = {m["name"]: r for m, r in plan.per_layer}
    assert got["steps_seen"].read({"steps": 7}) == 7
    assert {m["name"] for m, _ in plan.end_to_end} == {"setup_s", "step_ms"}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        cells.plan(BENCH, "no_such.cell")
    with pytest.raises(FileNotFoundError):
        cells.load_json("configs", "no_such_config")
