"""Plain PyTorch CIC deposition — the same arithmetic as the JAX package's
`pic/grid.py::deposit_cic`, the oracle of the deposit kernel."""
from __future__ import annotations

import torch


def deposit_ref(x, w, alive, n_cells: int, dx: float):
    """x, w, alive: [N] -> density [n_cells]; i0 and i0+1 both clip to
    [0, n_cells-1], so particles at x >= L pile into the last cell.

    x / dx is an IEEE division, as in the kernel: dividing by a Python
    float lets CUDA multiply by the reciprocal instead, and near 100,000
    cells, where one ulp of x/dx is 1/128 of a cell, that moves up to
    ~3e-4 of a cell's charge to its neighbour."""
    xi = x / torch.tensor(dx, dtype=x.dtype, device=x.device)
    i0 = torch.floor(xi).to(torch.int64)
    frac = xi - i0
    wa = w * alive
    i0c = torch.clamp(i0, 0, n_cells - 1)
    i1c = torch.clamp(i0 + 1, 0, n_cells - 1)
    rho = torch.zeros(n_cells, dtype=torch.float32, device=x.device)
    rho.index_add_(0, i0c, wa * (1.0 - frac))
    rho.index_add_(0, i1c, wa * frac)
    return rho / dx
