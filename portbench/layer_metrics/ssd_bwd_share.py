"""The SSD scan's backward's share of the train step's device time: the
device time of the operations launched inside the program's
`ssm.ssd_bwd` ranges (`SsdScan.backward`'s recompute of the plain scan
and its autograd) over that of every operation launched inside
`train.step` in the traced step."""
from portbench import program_trace

UNIT = "%"
LAYER = "kernels/ssd_scan SsdScan.backward"
MOVES = "step_ms"


def read(run: dict):
    by = program_trace.launched_in(run, "train.step")
    if not by or "ssm.ssd_bwd" not in by or not sum(by.values()) > 0:
        return None
    return 100.0 * by["ssm.ssd_bwd"] / sum(by.values())
