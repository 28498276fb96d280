"""`particles.spawn`'s share of the step's device time: the device time
of the operations launched inside the program's `pic.spawn` ranges over
that of every operation launched inside the benchmark's `pic.steps`
spans of the traced period (launches matched to their device work by
the profiler's correlation ids, `portbench/program_trace.py`)."""
from portbench import program_trace

UNIT = "%"
LAYER = "PIC step"
MOVES = "step_ms"


def read(run: dict):
    by = program_trace.launched_in(run)
    if not by or "pic.spawn" not in by:
        return None
    return 100.0 * by["pic.spawn"] / sum(by.values())
