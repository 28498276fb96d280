"""Share of the window's wall time the host spent in the spans around
diagnostics writes, checkpoint saves and waits for a checkpoint's
commit (host clock)."""
UNIT = "%"
LAYER = "pic/simulation.py cycle and its writes"
MOVES = "step_ms"
SPANS = ("diag.write", "ckpt.save", "ckpt.wait")


def read(run: dict):
    if not run["window_s"]:
        return None
    blocked = sum(t1 - t0 for n, t0, t1 in run["spans"] if n in SPANS)
    return 100.0 * blocked / run["window_s"]
