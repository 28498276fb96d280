"""Share of the traced checkpoint save spent in fsync: the union of the
program's `bp.fsync` ranges (every `InstrumentedFile.fsync`: the seal's
md.0 and md.idx, each subfile's at close) inside the benchmark's
`ckpt.save` span over the span's length."""
from portbench import program_trace

UNIT = "%"
LAYER = "checkpoint write path"
MOVES = "ckpt_GBps"


def read(run: dict):
    got = program_trace.within(run, "bp.fsync")
    return None if got is None else 100.0 * got[0] / got[2]
