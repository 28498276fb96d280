"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It needs a CUDA device and exits non-zero,
printing no result, without one. The last line of standard output is
the result: `correct`, `attempted`, `failed`, the cell's end-to-end
metrics (`--trace 0`) or per-layer metrics (`--trace 1`), the device,
with `--trace 1` the `breakdown` of the traced period, and `checks`:
each number the comparison with the plain reference gave, beside its
limit. The same numbers end standard error. The cell's traffic mix
names the runner that executes it (`runners/<name>.py`, whose
`__init__.py` gives the contract); the lines of the runner's `summary`
come before the result. Files go under `TMPDIR`; the kernels are built
into `build/kernels/` of the checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time


def _process_start() -> float:
    """This process's start on the `time.perf_counter` clock."""
    try:
        ticks = int(open("/proc/self/stat").read().rsplit(")", 1)[1].split()[19])
        up = float(open("/proc/uptime").read().split()[0])
        return time.perf_counter() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T0 = _process_start()
ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: top-level modules the run must not load: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & FORBIDDEN)


def result_line(plan, res: dict, traced: bool, device: dict) -> dict:
    rec = res["record"]
    metrics = {}
    for m, reader in (plan.per_layer if traced else plan.end_to_end):
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if traced and rec.get("traced"):
        from portbench import trace
        t = rec["traced"]
        out["device"] = {**device, "busy_s": trace.busy_us(t) / 1e6,
                         "window_s": t["window_us"] / 1e6}
        out["breakdown"] = {"device_ops": trace.top(trace.device_ops(t)),
                            "idle_gaps": trace.top(trace.idle_gaps(t))}
    out["checks"] = res["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cells
    plan = cells.plan(cells.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < plan.cell["chips"]):
        print(f"portbench: {args.workload} needs {plan.cell['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    res = plan.runner.run(plan, args.seed, args.seconds, bool(args.trace),
                          device="cuda", process_start=T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": plan.cell["chips"], "memory_peak_bytes": res["peak"]}
    line = result_line(plan, res, bool(args.trace), device)
    for text in res.get("summary", ()):
        print(text)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
