"""PyTorch/CUDA port of `repro`: the BIT1-style PIC-MC cycle, its openPMD /
BP4-style I/O engine and Darshan-style monitoring, with hand-written CUDA
kernels for charge deposition and the blosc byte shuffle.

The layout mirrors `repro` path for path. Entry points run on the CUDA
device unless the caller passes `device="cpu"` (see `_device.py`)."""
