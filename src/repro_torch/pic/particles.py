"""Species containers (SoA, fixed capacity + alive mask) and the particle
mover — BIT1 is 1D3V: one spatial dim, three velocity dims."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.dxt import TRACER
from repro_torch.kernels.spawn import ops as spawn_ops


class Species(NamedTuple):
    x: torch.Tensor         # [C] position
    v: torch.Tensor         # [C, 3] velocity (vx drives motion)
    w: torch.Tensor         # [C] macro-particle weight
    alive: torch.Tensor     # [C] float mask (1.0 alive / 0.0 dead)
    charge: float
    mass: float

    @property
    def capacity(self):
        return self.x.shape[0]

    def count(self):
        return torch.sum(self.alive)

    def density_weight(self):
        return torch.sum(self.w * self.alive)


def init_species(generator: Optional[torch.Generator], capacity: int,
                 n_active: int, *, L: float, v_thermal: float, charge: float,
                 mass: float, weight: float = 1.0, device=None,
                 x: Optional[torch.Tensor] = None,
                 v: Optional[torch.Tensor] = None) -> Species:
    """Positions uniform on [0, L), velocities normal * v_thermal, drawn
    from `generator` on `device` unless `x` / `v` are given; the first
    `n_active` slots are alive."""
    if x is None:
        x = torch.rand(capacity, generator=generator, device=device) * L
    if v is None:
        v = torch.randn(capacity, 3, generator=generator,
                        device=device) * v_thermal
    dev = x.device
    alive = (torch.arange(capacity, device=dev) < n_active).to(torch.float32)
    w = torch.full((capacity,), weight, dtype=torch.float32, device=dev)
    return Species(x, v, w, alive, charge, mass)


def push(sp: Species, E_at_p, dt: float, L: float, *,
         boundary: str = "periodic"):
    """Leapfrog: v += (q/m) E dt; x += vx dt. Returns (species, wall_flux)."""
    accel = (sp.charge / sp.mass) * E_at_p * dt
    v = sp.v.clone()
    v[:, 0] += accel
    x = sp.x + v[:, 0] * dt
    wall = torch.zeros((), dtype=torch.float32, device=x.device)
    if boundary == "periodic":
        x = torch.remainder(x, L)
        alive = sp.alive
    else:  # absorbing walls (divertor plates) — BIT1 plasma-wall transition
        hit = ((x < 0.0) | (x >= L)) & (sp.alive > 0)
        wall = torch.sum(torch.where(hit, sp.w, 0.0))
        alive = torch.where(hit, 0.0, sp.alive)
        x = torch.clamp(x, 0.0, L * (1.0 - 1e-7))
    return sp._replace(x=x, v=v, alive=alive), wall


def spawn(sp: Species, new_x, new_v, new_w, n_new_mask):
    """Write new particles into dead slots (static shapes: the k-th new
    particle goes to the k-th dead slot; overflow is dropped & counted).
    Returns (species, dropped). On CUDA tensors one compaction kernel
    (`kernels/spawn`) does it without a host sync.

    new_x/new_v/new_w: candidate arrays [M]; n_new_mask: [M] bool."""
    with TRACER.span("spawn", layer="pic"):
        x, v, w, alive, dropped = spawn_ops.spawn(
            sp.x, sp.v, sp.w, sp.alive, new_x, new_v, new_w, n_new_mask)
        return sp._replace(x=x, v=v, w=w, alive=alive), dropped
