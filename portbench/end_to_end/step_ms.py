"""The window's wall time over the PIC steps completed in it, every
diagnostics write and checkpoint the mix puts in it included."""
UNIT = "ms"


def read(run: dict):
    return 1e3 * run["window_s"] / run["steps"] if run["steps"] else None
