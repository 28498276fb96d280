"""How many threads the host codec ran on at once, on average, in the
traced checkpoint save: the summed seconds of the program's `bp.encode`
ranges inside the benchmark's `ckpt.save` span over their union. 1.0 is
one thread at a time."""
from portbench import program_trace

UNIT = "ratio"
LAYER = "checkpoint write path"
MOVES = "ckpt_GBps"


def read(run: dict):
    got = program_trace.within(run, "bp.encode")
    return None if got is None or not got[0] > 0 else got[1] / got[0]
