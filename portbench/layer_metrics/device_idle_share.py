"""Share of the traced window (one whole period of the cycle) in which
no operation ran on the device: 1 - the union of the profiler's kernel,
copy and set intervals over the window's length."""
from portbench import trace

UNIT = "%"
LAYER = "device"
MOVES = "step_ms"


def read(run: dict):
    t = run.get("traced")
    if not t or not t.get("device") or not t["window_us"]:
        return None
    return 100.0 * (1.0 - trace.busy_us(t) / t["window_us"])
