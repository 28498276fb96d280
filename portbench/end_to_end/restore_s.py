"""Wall time from the call that restores the newest committed checkpoint
until every leaf is on the device, synchronised."""
UNIT = "s"


def read(run: dict):
    return run["restore"]["s"] if "restore" in run else None
