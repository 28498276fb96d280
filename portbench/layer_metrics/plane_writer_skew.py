"""The busiest writer's seconds over the mean writer's, a checkpoint,
from the parallel engine's step profile (a writer that got no chunk
reports nothing and counts as 0 s), averaged over the window's
checkpoints."""
UNIT = "ratio"
LAYER = "write plane"
MOVES = "ckpt_GBps"


def read(run: dict):
    skews = []
    for c in run["checkpoints"]:
        w = list(c["engine"].get("worker_s", {}).values())
        if w and sum(w) > 0:
            skews.append(max(w) / (sum(w) / c["writers"]))
    return sum(skews) / len(skews) if skews else None
