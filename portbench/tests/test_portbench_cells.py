"""BENCHMARK.json and the files it names: each configuration, mix,
runner and metric is found by name, and a new cell, of a kind the
harness has not run before too, is taken from added files."""
import hashlib
import json
import pathlib
import re
import shutil
import types

import pytest

from portbench import cells, control, run
from portbench.runners import pic

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
        {"name": "dense", "runner": "pic", "steps_per_diag": 10,
         "diags_per_period": 5, "checkpoint": False}))
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
    assert pathlib.Path(plan.runner.__file__) == base / "runners" / "pic.py"
    assert callable(plan.runner.run)
    got = {m["name"]: r for m, r in plan.per_layer}
    assert got["steps_seen"].read({"steps": 7}) == 7
    assert {m["name"] for m, _ in plan.end_to_end} == {"setup_s", "step_ms"}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        cells.plan(BENCH, "no_such.cell")
    with pytest.raises(FileNotFoundError):
        cells.load_json("configs", "no_such_config")
    with pytest.raises(FileNotFoundError, match="no runner named"):
        cells.load_runner("no_such_runner")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_this_folders_runner_is_one_module(cell):
    """The plan's runner is the module `portbench.runners.<name>`, so a
    test that patches the module patches the run."""
    assert cells.plan(BENCH, cell).runner is pic
    assert control.sides(pic) == (pic.Program, pic.Control)


def _copy(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(cells.HERE, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return base


@pytest.mark.parametrize("mix,error,match", [
    ({"name": "bare", "steps_per_diag": 10, "diags_per_period": 5,
      "checkpoint": False}, ValueError, r"bare\.json names no \"runner\""),
    ({"name": "bare", "runner": "no_such_runner", "steps_per_diag": 10,
      "diags_per_period": 5, "checkpoint": False}, FileNotFoundError,
     "no runner named 'no_such_runner'"),
])
def test_a_mix_must_name_a_runner_that_exists(tmp_path, mix, error, match):
    """No silent default: a mix without `runner`, or naming none that is
    there, fails at the plan."""
    base = _copy(tmp_path)
    (base / "mixes" / "bare.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "bit1_q4.bare", "config": "bit1_q4",
                               "traffic": "bare", "chips": 1, "why": "x"})
    with pytest.raises(error, match=match):
        cells.plan(bench, "bit1_q4.bare", base)


def test_control_refuses_a_runner_without_a_control():
    with pytest.raises(ValueError, match="no Program and Control"):
        control.sides(types.SimpleNamespace(__name__="toy", run=print))


#: a runner of a new kind: a few seeded matmuls a step on the CPU,
#: checked against numpy by its own limit
TOY_RUNNER = '''"""A toy runner: each step multiplies seeded matrices; a sample of
the steps drawn from the seed is checked against numpy in float64."""
import pathlib
import tempfile
import time

import numpy as np
import torch

from portbench import check, trace

LIMITS = {"matmul_gap": 1e-5}


def product(a, b):
    return a @ b


def run(plan, seed, seconds, traced, *, device="cpu", process_start=None):
    t0 = time.perf_counter() if process_start is None else process_start
    n, k = plan.config["n"], plan.mix["matrices"]
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    mats = torch.randn((k, n, n), generator=g, device=device)
    product(mats[0], mats[0])                       # warm
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    spans = trace.Spans()
    held, steps, prof = [], 0, None
    work = pathlib.Path(tempfile.mkdtemp())
    while steps < plan.mix["min_steps"] or spans.now() < seconds:
        if traced and steps == 1:
            prof = trace.profile_start()
        i, j = (steps % k, (steps + 1) % k)
        with spans("toy.step"):
            out = product(mats[i], mats[j])
        if traced and steps == 1:
            trace.profile_stop(prof)
        if rng.random() < 0.5:
            held.append((i, j, out))
        steps += 1
    window_s = spans.now()
    rec = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "spans": spans.items}
    if prof is not None:
        rec["traced"] = trace.reduced(prof, work)
    work.rmdir()
    ref = mats.double().numpy()
    gap = max((float(np.abs(out.double().numpy() - ref[i] @ ref[j]).max()
                     / np.abs(ref[i] @ ref[j]).max()) for i, j, out in held),
              default=float("inf"))
    checks = {"matmul_gap": {"value": gap, "limit": LIMITS["matmul_gap"]}}
    return {"correct": check.correct(checks), "attempted": len(held),
            "failed": 0, "peak": 0, "record": rec, "checks": checks,
            "summary": [f"toy: {steps} steps in {window_s:.3f} s"]}
'''


def _digests(base) -> dict:
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file()}


def test_a_new_kind_of_cell_from_added_files_only(tmp_path, monkeypatch):
    """A runner, a mix naming it, a configuration and a layer metric,
    added as files to a copy of this folder, make a cell of a kind the
    harness has not run: it plans, runs on the CPU through `run.py`'s
    result line, is judged by its own limits, fails under a planted
    fault, and leaves every file that was there as it was."""
    base = _copy(tmp_path)
    before = _digests(base)
    (base / "runners" / "toy.py").write_text(TOY_RUNNER)
    (base / "mixes" / "matmul.json").write_text(json.dumps(
        {"name": "matmul", "runner": "toy", "matrices": 3, "min_steps": 8}))
    (base / "configs" / "toy_mm.json").write_text(json.dumps(
        {"name": "toy_mm", "n": 48}))
    (base / "layer_metrics" / "toy_step_share.py").write_text(
        'UNIT = "%"\nLAYER = "toy"\nMOVES = "step_ms"\n\n\n'
        'def read(run):\n'
        '    busy = sum(b - a for n, a, b in run["spans"] if n == "toy.step")\n'
        '    return 100.0 * busy / run["window_s"] if busy else None\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_mm", "source": "x",
                             "file": "portbench/configs/toy_mm.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy_mm.matmul", "config": "toy_mm",
                               "traffic": "matmul", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "toy_step_share", "unit": "%",
                               "better": "higher", "source": "program_span",
                               "layer": "toy", "moves": "step_ms",
                               "workloads": ["toy_mm.matmul"]})
    plan = cells.plan(bench, "toy_mm.matmul", base)
    assert plan.runner.__name__ == "portbench_runners_toy"
    assert [m["name"] for m, _ in plan.per_layer] == ["toy_step_share"]

    device = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}
    for traced in (False, True):
        res = plan.runner.run(plan, 2**31 + 5, 0.05, traced, device="cpu")
        line = run.result_line(plan, res, traced, device)
        assert line["correct"], line["checks"]
        assert set(line["checks"]) == {"matmul_gap"}
        assert list(line)[-1] == "checks"
        assert res["summary"][0].startswith("toy: ")
        got = {k: v["value"] for k, v in line["metrics"].items()}
        if traced:
            assert 0 < got["toy_step_share"] <= 100
            assert line["device"]["window_s"] > 0
            assert "breakdown" in line
        else:
            assert set(got) == {"setup_s", "step_ms"}
            assert got["setup_s"] > 0 and got["step_ms"] > 0

    monkeypatch.setattr(plan.runner, "product", lambda a, b: (a @ b) * 1.001)
    res = plan.runner.run(plan, 2**31 + 5, 0.0, False, device="cpu")
    line = run.result_line(plan, res, False, device)
    assert not line["correct"]
    assert line["checks"]["matmul_gap"]["value"] > 1e-4

    after = _digests(base)
    assert {k: after[k] for k in before} == before
