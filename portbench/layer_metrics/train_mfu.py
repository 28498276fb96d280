"""The train step's share of the chip's bf16 dense peak: its model FLOPs
(`portbench/counts/zamba2.py`: 6 a parameter and a token outside the
embedding table, the shared block at each invocation, attention's and
the SSD scan's products forward and backward, no remat recompute) over
989 TFLOP/s, against the device time of the operations launched inside
the program's `train.step` range in the traced step (launches matched by
the profiler's correlation ids, `portbench/program_trace.py`)."""
from portbench import program_trace
from portbench.counts import PEAK_FLOPS
from portbench.counts import zamba2

UNIT = "%"
LAYER = "train/step.py train step"
MOVES = "step_ms"


def read(run: dict):
    by = program_trace.launched_in(run, "train.step")
    if not by or not sum(by.values()) > 0:
        return None
    flops = zamba2.train_step_flops(run["model"], run["batch"],
                                    run["seq_len"], run["ssd_chunk"])
    device_s = sum(by.values()) / 1e6 / run["traced"]["steps"]
    return 100.0 * flops / PEAK_FLOPS["bf16"] / device_s
