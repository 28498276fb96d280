"""The deposit kernel's (`csrc/deposit.cu`) share of its byte bound: x,
w and alive of the deposited species' slots read once and the grid
written once at HBM's rate, over the kernel's mean device time a launch
in the traced window."""
from portbench import counts

UNIT = "%"
LAYER = "kernel csrc/deposit.cu"
MOVES = "step_ms"
KERNEL = "deposit_cic"


def read(run: dict):
    t = run.get("traced")
    durs = [d for n, c, _, d in (t or {}).get("device", [])
            if c == "kernel" and KERNEL in n]
    if not durs:
        return None
    c = counts.deposit(run["capacity"], run["n_cells"])
    least = counts.least_seconds(c["flops"], c["bytes"], "fp32")
    return 100.0 * least / (sum(durs) / len(durs) / 1e6)
