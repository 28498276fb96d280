"""1D electrostatic field solver: -phi'' = rho/eps0, E = -phi'.

Tridiagonal Thomas algorithm as two sequential loops in the order of the
JAX package's two lax.scans (O(n), stable for the diagonally-dominant
Poisson system), Dirichlet walls phi(0)=phi(L)=0 — BIT1's field-solver
phase. The paper's case runs without it (`field_solve=False`), and the
element-by-element loop is meant for small grids."""
from __future__ import annotations

import torch


def thomas_solve(a, b, c, d):
    """Solve tridiag(a,b,c) x = d. a[0] and c[-1] ignored. All [n]."""
    n = d.shape[0]
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    cps, dps = torch.empty_like(d), torch.empty_like(d)
    cp_prev, dp_prev = zero, zero
    for i in range(n):
        denom = b[i] - a[i] * cp_prev
        cp_prev = c[i] / denom
        dp_prev = (d[i] - a[i] * dp_prev) / denom
        cps[i], dps[i] = cp_prev, dp_prev
    xs = torch.empty_like(d)
    x_next = zero
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return xs


def solve_poisson(rho, dx: float, eps0: float = 1.0):
    """phi on cell centers with phi=0 walls; returns (phi, E) on the grid."""
    n = rho.shape[0]
    h2 = dx * dx
    a = torch.full((n,), -1.0, dtype=rho.dtype, device=rho.device)
    b = torch.full((n,), 2.0, dtype=rho.dtype, device=rho.device)
    c = torch.full((n,), -1.0, dtype=rho.dtype, device=rho.device)
    d = rho * h2 / eps0
    phi = thomas_solve(a, b, c, d)
    # E = -dphi/dx, central differences; one-sided at walls
    E = torch.zeros_like(phi)
    E[1:-1] = -(phi[2:] - phi[:-2]) / (2 * dx)
    E[0] = -(phi[1] - phi[0]) / dx
    E[-1] = -(phi[-1] - phi[-2]) / dx
    return phi, E
