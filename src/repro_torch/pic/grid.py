"""1D grid operations: charge deposition (CIC) and binomial smoothing.

Deposition is the classic PIC particle-to-grid scatter; on a CUDA tensor it
runs the hand-written deposit kernel (kernels/deposit), on a CPU tensor its
plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.deposit import ops as deposit_ops


def deposit_cic(x, weight, alive, n_cells: int, dx: float):
    """Cloud-in-cell deposition. x: [N] positions, weight: [N], alive: [N]
    -> density [n_cells] (guard cells folded)."""
    return deposit_ops.deposit(x, weight, alive, n_cells=n_cells, dx=dx)


def smooth_121(rho):
    """Binomial (1,2,1)/4 digital filter — BIT1's density smoothing phase."""
    left = torch.roll(rho, 1)
    left[0] = rho[0]
    right = torch.roll(rho, -1)
    right[-1] = rho[-1]
    return 0.25 * left + 0.5 * rho + 0.25 * right


def gather_field(E, x, dx: float):
    """Grid-to-particle linear interpolation of the field at positions x."""
    n = E.shape[0]
    xi = x / dx
    i0 = torch.floor(xi).to(torch.int64)
    frac = xi - i0
    i0c = torch.clamp(i0, 0, n - 1)
    i1c = torch.clamp(i0 + 1, 0, n - 1)
    return E[i0c] * (1.0 - frac) + E[i1c] * frac
