"""The window's wall time over the runner's steps completed in it (its
unit of work: a PIC step with every diagnostics write and checkpoint the
mix puts in the window, a train step), all of the window's work
included."""
UNIT = "ms"


def read(run: dict):
    return 1e3 * run["window_s"] / run["steps"] if run["steps"] else None
