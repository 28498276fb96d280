"""Public wrapper of the CIC deposit: a CUDA tensor goes to the kernel
(`csrc/deposit.cu`), a CPU tensor to the plain version (`ref.py`).

The kernel has two paths in one source: up to `cluster_cell_limit()`
cells the grid is privatised in a thread-block cluster's shared memory,
above it every weight is a global atomic. `deposit.last_path` records the
path of the last CUDA call ("cluster" or "global")."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.deposit.ref import deposit_ref

_SIGNATURES = {
    "jbp_deposit_cic": (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p),
    "jbp_deposit_cluster_cells": ()}
_PATHS = {1: "cluster", 2: "global"}


def cluster_cell_limit() -> int:
    """The most cells the kernel's cluster path takes (builds the kernel
    on first use; needs the CUDA toolkit)."""
    return _build.load("deposit", _SIGNATURES).jbp_deposit_cluster_cells()


def deposit(x, w, alive, *, n_cells: int, dx: float) -> torch.Tensor:
    """x, w, alive: float32 [N] -> charge density float32 [n_cells]."""
    if n_cells <= 0:
        raise ValueError(f"deposit needs n_cells > 0, got {n_cells}")
    if not x.is_cuda:
        return deposit_ref(x, w, alive, n_cells, dx)
    _build.require_cuda("deposit", x, w, alive, dtype=torch.float32)
    n = x.shape[0]
    if x.dim() != 1 or w.shape != (n,) or alive.shape != (n,):
        raise ValueError("deposit: x, w and alive must be 1-D of one length")
    rho = torch.zeros(n_cells, dtype=torch.float32, device=x.device)
    if n:
        lib = _build.load("deposit", _SIGNATURES)
        path = ctypes.c_int(0)
        with _build.on_device(x):
            rc = lib.jbp_deposit_cic(x.data_ptr(), w.data_ptr(),
                                     alive.data_ptr(), rho.data_ptr(), n,
                                     n_cells, float(dx), ctypes.byref(path),
                                     _build.stream_of(x))
        _build.check(rc, "jbp_deposit_cic")
        deposit.launches += 1
        deposit.last_path = _PATHS[path.value]
    return rho / dx


deposit.launches = 0
deposit.last_path = None
