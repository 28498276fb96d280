"""The logical bytes of the checkpoints the window committed (the
state's tensor leaves) over the sum of each one's wall time from the call
that starts it (or, where that call first waits for the previous
checkpoint, from that one's commit) to its own commit: the end of the
commit, not the return of an asynchronous save."""
UNIT = "GB/s"


def read(run: dict):
    ck = run["checkpoints"]
    wall = sum(c["t_commit"] - c["t_start"] for c in ck)
    return sum(c["bytes"] for c in ck) / wall / 1e9 if ck and wall > 0 else None
