"""The paper's own use case (§III-C): neutral ionization in an unbounded
unmagnetized plasma — electrons, D+ ions, D neutrals; 1D geometry; no field
solver or smoother.

Paper scale: 100K cells, 10M particles/cell/species (30M total), 200K steps
on up to 25600 ranks. `paper_config()` keeps the exact grid; `cpu_config()`
scales particle counts/steps to a CPU run while preserving the physics
(ionization decay rate constant n_e*R*dt per step).
"""
from __future__ import annotations

from repro_torch.pic.simulation import PicConfig

# BIT1's five I/O knobs (paper §II)
IO_KNOBS = dict(
    datfile="diagnostic snapshot series (openPMD meshes)",
    dmpstep=10_000,       # checkpoint every N steps
    mvflag=1,             # time-dependent diagnostics on
    mvstep=1_000,         # diagnostics every N steps
    last_step=200_000,
)


def paper_config() -> PicConfig:
    return PicConfig(
        n_cells=100_000,
        L=1.0,
        dt=1e-3,
        capacity=1 << 25,            # 33.5M slots: 30M particles + growth
        n_electrons=10_000_000,
        n_ions=10_000_000,
        n_neutrals=10_000_000,
        rate_R=0.05,
        boundary="periodic",
        field_solve=False,           # the use case skips solver + smoother
        smoothing=False,
    )


def cpu_config(scale: int = 64) -> PicConfig:
    return PicConfig(
        n_cells=100_000 // scale,
        L=1.0,
        dt=1e-3,
        capacity=(1 << 25) // scale,
        n_electrons=10_000_000 // scale,
        n_ions=10_000_000 // scale,
        n_neutrals=10_000_000 // scale,
        # per-cell electron count is scale-invariant (particles and cells
        # shrink together), so the MC rate stays the paper's R
        rate_R=0.05,
        boundary="periodic",
        field_solve=False,
        smoothing=False,
    )
