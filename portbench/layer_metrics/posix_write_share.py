"""Darshan's F_WRITE_TIME on the checkpoints' files, summed over the
writing threads or processes (the plane's writers' counters come home
with each commit), over the checkpoints' wall time times the writers.
Low: the codec and the host path set the pace; high: storage does."""
UNIT = "%"
LAYER = "checkpoint write path"
MOVES = "ckpt_GBps"


def read(run: dict):
    ck = run["checkpoints"]
    cap = sum((c["t_commit"] - c["t_start"]) * c["writers"] for c in ck)
    if not ck or not cap > 0:
        return None
    return 100.0 * sum(c["write_time"] for c in ck) / cap
