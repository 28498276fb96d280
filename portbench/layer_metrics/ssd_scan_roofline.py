"""The SSD scan kernel's (`csrc/ssd_scan.cu`) share of its roofline: the
least time of one forward call, the larger of its FLOPs over the bf16
peak and its bytes over HBM's rate (`portbench/counts/zamba2.py`: each
input read once, y and the final state written once), over the mean
device time of a call in the traced step (its two launches,
`ssd_cb_kernel` and `ssd_chunk_scan_kernel`)."""
from portbench.counts import least_seconds
from portbench.counts import zamba2

UNIT = "%"
LAYER = "kernel csrc/ssd_scan.cu"
MOVES = "step_ms"
KERNELS = ("ssd_cb_kernel", "ssd_chunk_scan_kernel")


def read(run: dict):
    dev = [(n, d) for n, c, _, d in (run.get("traced") or {}).get(
        "device", []) if c == "kernel" and any(k in n for k in KERNELS)]
    calls = sum(1 for n, _ in dev if KERNELS[1] in n)
    if not calls:
        return None
    c = zamba2.ssd_forward(run["model"], run["batch"], run["seq_len"],
                           run["ssd_chunk"])
    least = least_seconds(c["flops"], c["bytes"], "bf16")
    return 100.0 * least / (sum(d for _, d in dev) / calls / 1e6)
