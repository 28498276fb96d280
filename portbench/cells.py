"""Finds a cell's parts by name: `BENCHMARK.json` at the root of the
checkout names the cell, its configuration and its traffic mix; each is
a file of its own under this folder (`configs/<name>.json`,
`mixes/<name>.json`), the mix names the runner that executes the cell
(`runners/<name>.py`), and each metric has a reader of its own
(`end_to_end/<name>.py`, `layer_metrics/<name>.py`). Adding a cell,
a configuration, a mix, a runner or a metric adds files and edits
none."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one run of a cell needs: its entry in `BENCHMARK.json`, its
    configuration and mix, the metrics it reports, each (entry, reader),
    and the runner module its mix names."""
    cell: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    runner: object


def load_benchmark(root: pathlib.Path = HERE.parent) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def load_json(kind: str, name: str, base: pathlib.Path = HERE) -> dict:
    """`<base>/<kind>/<name>.json`."""
    path = base / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_reader(kind: str, name: str, base: pathlib.Path = HERE):
    """The module `<base>/<kind>/<name>.py`; its `read(run)` gives the
    metric's value from a run's record, or None where there is nothing
    to read."""
    path = base / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_runner(name: str, base: pathlib.Path = HERE):
    """The module `<base>/runners/<name>.py` (see `runners/__init__.py`
    for what it provides). This folder's runners are imported as
    `portbench.runners.<name>`, one module object a process, so that
    what patches it patches the run; another base's is loaded from its
    file."""
    path = base / "runners" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no runner named {name!r} ({path})")
    if path.resolve().parent == HERE / "runners":
        return importlib.import_module(f"portbench.runners.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_runners_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def plan(bench: dict, workload: str, base: pathlib.Path = HERE) -> Plan:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[workload]
    config = load_json("configs", cell["config"], base)
    mix = load_json("mixes", cell["traffic"], base)
    if "runner" not in mix:
        raise ValueError(f"{base / 'mixes' / cell['traffic']}.json names "
                         f"no \"runner\"")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, workload) and m["moves"] in moved]
    return Plan(cell, config, mix,
                [(m, load_reader("end_to_end", m["name"], base)) for m in e2e],
                [(m, load_reader("layer_metrics", m["name"], base))
                 for m in layer],
                load_runner(mix["runner"], base))
