"""Share of the traced checkpoint save in which the host codec ran: the
union of the program's `bp.encode` ranges (each block's LZ, a host
leaf's whole encode) inside the benchmark's `ckpt.save` span over the
span's length. The ranges come from `traced["program"]`
(`portbench/program_trace.py`), from a profiler that follows the
engine's writer threads."""
from portbench import program_trace

UNIT = "%"
LAYER = "checkpoint write path"
MOVES = "ckpt_GBps"


def read(run: dict):
    got = program_trace.within(run, "bp.encode")
    return None if got is None else 100.0 * got[0] / got[2]
