"""The whole PIC step's share of the chip's peak: its least time (the
larger of its FLOPs over the fp32 peak and its bytes over HBM's, from
`portbench/counts`) over the device time a step took in the traced
window's steps (the union of device intervals inside the `pic.steps`
spans, which hold no write)."""
from portbench import counts, trace

UNIT = "%"
LAYER = "PIC step"
MOVES = "step_ms"


def read(run: dict):
    t = run.get("traced")
    if not t or not t.get("device") or "events_per_step" not in t:
        return None
    busy = sum(trace.busy_us(t, s, s + d) for n, s, d in t["spans"]
               if n == "pic.steps")
    if busy <= 0:
        return None
    c = counts.pic_step(t["live"], t["events_per_step"], run["n_cells"])
    least = counts.least_seconds(c["flops"], c["bytes"], "fp32")
    return 100.0 * least / (busy / 1e6 / t["steps"])
