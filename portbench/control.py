"""Readings of the numbers `correct` compares, for setting their limits:
the program's on `--seeds` and the control's (the plain reference in
bfloat16 in the program's place) on `--control-seeds`, one process, at
the cell's own size, each a shortest run (two periods).

    python3 portbench/control.py --workload bit1_q4.ckpt \
        --seeds 11 12 13 --control-seeds 21 22 23

Prints one JSON line a run: who ran, the seed, and each number beside
its limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def readings(plan, seeds, program):
    from portbench import runner
    for seed in seeds:
        res = runner.run(plan, seed, 0.0, False, program=program)
        yield {"seed": seed, "correct": res["correct"],
               "checks": {k: c["value"] for k, c in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    from portbench import cells
    from portbench.program import Control, Program
    plan = cells.plan(cells.load_benchmark(ROOT), args.workload)
    for who, seeds, program in (("program", args.seeds, Program),
                                ("control", args.control_seeds, Control)):
        for r in readings(plan, seeds, program):
            print(json.dumps({"run": who, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
