"""Monte-Carlo collisions — the paper's use case (§III-C): electron-impact
ionization e + D -> 2e + D+ in an unbounded unmagnetized plasma, where the
neutral density decays as  dn/dt = -n * n_e * R  (R: ionization rate
coefficient). Each MC event transfers weight from the neutral species to a
newly spawned electron/ion pair."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.pic.particles import Species, spawn


def ionize(generator: Optional[torch.Generator], electrons: Species,
           ions: Species, neutrals: Species, *, rate_R: float, dt: float,
           L: float, n_cells: int, electron_density_per_cell,
           u: Optional[torch.Tensor] = None,
           kick: Optional[torch.Tensor] = None):
    """One MC ionization substep.

    For every alive NEUTRAL macro-particle, the ionization probability over
    dt is  p = 1 - exp(-n_e(x) * R * dt)  with n_e interpolated at the
    neutral's position. On an event the neutral dies and an electron/ion
    pair inherits its position and weight.

    `u` [C] (uniform on [0, 1)) and `kick` [C, 3] (standard normal) are the
    step's random draws; each one not given is drawn from `generator`."""
    C = neutrals.capacity
    dev = neutrals.x.device
    dx = L / n_cells
    ci = torch.clamp((neutrals.x / dx).to(torch.int64), 0, n_cells - 1)
    ne_local = electron_density_per_cell[ci]                     # [C]
    p = 1.0 - torch.exp(-ne_local * rate_R * dt)
    if u is None:
        u = torch.rand(C, generator=generator, device=dev)
    event = (u < p) & (neutrals.alive > 0)

    # neutral dies
    new_neutrals = neutrals._replace(
        alive=torch.where(event, 0.0, neutrals.alive))

    # electron + ion inherit position/weight; thermal kick for the electron
    if kick is None:
        kick = torch.randn(C, 3, generator=generator, device=dev)
    v_e = neutrals.v + kick * 1e-2
    new_electrons, drop_e = spawn(electrons, neutrals.x, v_e, neutrals.w, event)
    new_ions, drop_i = spawn(ions, neutrals.x, neutrals.v, neutrals.w, event)
    n_events = torch.sum(event)
    return (new_electrons, new_ions, new_neutrals,
            {"ionizations": n_events, "dropped": drop_e + drop_i})
