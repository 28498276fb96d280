"""The run loads neither JAX nor the JAX package (top-level names
compared whole: `repro_torch` is the port, `repro` the JAX package), and
refuses to print a result without a card or without the program."""
import json
import pathlib
import shutil
import subprocess
import sys

from portbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]

PROBE = """
import dataclasses, json, pathlib, sys, tempfile
sys.path[:0] = [{src!r}, {root!r}]
from portbench import cells, run
plan = cells.plan(cells.load_benchmark(), "bit1_q4.steps")
plan.runner.SHM = pathlib.Path(tempfile.mkdtemp())   # others' shm aside
plan = dataclasses.replace(plan, config={{**plan.config, "n_cells": 64,
    "capacity": 1024, "n_electrons": 200, "n_ions": 200, "n_neutrals": 200}},
    mix={{**plan.mix, "steps_per_diag": 2, "diags_per_period": 2}})
res = plan.runner.run(plan, 5, 0.0, True, device="cpu")
for m, r in plan.per_layer + plan.end_to_end:
    r.read(res["record"])
print(json.dumps({{"correct": res["correct"],
                  "loaded": sorted({{m.partition(".")[0] for m in sys.modules}})}}))
"""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(src=str(ROOT / "src"),
                                            root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "repro_torch" in got["loaded"]
    assert not set(got["loaded"]) & run.FORBIDDEN


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bit1_q4.steps",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
