"""Process start to the window's start: the runner's set-up. For PIC:
`import torch`, the kernels' build or load, the initial state on the
device from the seed, the write plane's spawn, and a warm step,
diagnostics write and small checkpoint."""
UNIT = "s"


def read(run: dict):
    return run["setup_s"]
