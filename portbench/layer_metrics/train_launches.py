"""Kernels launched a train step: the traced step's kernels whose launch
lies inside the program's `train.step` range (copies and sets not
counted), matched to their launch by the profiler's correlation ids."""
from portbench import program_trace

UNIT = "launches"
LAYER = "train/step.py train step"
MOVES = "step_ms"


def read(run: dict):
    prog = program_trace.program(run)
    if prog is None:
        return None
    steps = [(s, s + d) for n, s, d in run["traced"]["spans"]
             if n == "train.step"]
    if not steps:
        return None
    n = sum(1 for _, cat, _, _, _, at in prog["device"]
            if cat == "kernel" and at is not None
            and any(a <= at < b for a, b in steps))
    return n / run["traced"]["steps"]
