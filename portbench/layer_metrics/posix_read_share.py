"""Darshan's F_READ_TIME during the restore over its wall time."""
UNIT = "%"
LAYER = "restore"
MOVES = "restore_s"


def read(run: dict):
    r = run.get("restore")
    if not r or not r["s"] > 0:
        return None
    return 100.0 * r["read_time"] / r["s"]
