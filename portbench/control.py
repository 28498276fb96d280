"""Readings of the numbers `correct` compares, for setting their limits:
the program's on `--seeds` and the control's (for PIC the plain
reference in bfloat16 in the program's place) on `--control-seeds`, one
process, at the cell's own size, each a shortest run (for PIC two
periods). Both come from the cell's runner, as its `Program` and
`Control`; a runner without them is refused.

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


def sides(runner):
    """The runner's program and its control; a runner without either has
    no control to read, and is refused."""
    program = getattr(runner, "Program", None)
    control = getattr(runner, "Control", None)
    if program is None or control is None:
        raise ValueError(f"the runner {runner.__name__} has no Program and "
                         f"Control")
    return program, control


def readings(plan, seeds, program):
    for seed in seeds:
        res = plan.runner.run(plan, seed, 0.0, False, device="cuda",
                              program=program)
        yield {"seed": seed, "correct": res["correct"],
               "checks": {k: c["value"] for k, c in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from portbench import cells
    plan = cells.plan(cells.load_benchmark(ROOT), args.workload)
    try:
        program, control = sides(plan.runner)
    except ValueError as e:
        print(f"control: {args.workload}: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for who, seeds, prog in (("program", args.seeds, program),
                             ("control", args.control_seeds, control)):
        for r in readings(plan, seeds, prog):
            print(json.dumps({"run": who, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
