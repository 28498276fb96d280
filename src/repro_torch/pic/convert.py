"""PicState <-> flat numpy dict, keyed by the checkpoint variable names
(`electrons/.x`, ..., `key`, `step`, ...) that the JAX package's
`ckpt/checkpoint.py::flatten_state` gives a `state._asdict()`. A state made
by either package carries across through these names."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.pic.particles import Species
from repro_torch.pic.simulation import PicState

SPECIES = ("electrons", "ions", "neutrals")
SCALARS = ("key", "step", "total_ionizations", "wall_flux_e", "wall_flux_i")


def state_from_numpy(flat: dict, device=None) -> PicState:
    dev = resolve_device(device)

    def t(a):      # a copy: the caller's arrays may be read-only
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    species = {}
    for sp in SPECIES:
        species[sp] = Species(
            t(flat[f"{sp}/.x"]), t(flat[f"{sp}/.v"]), t(flat[f"{sp}/.w"]),
            t(flat[f"{sp}/.alive"]),
            float(np.asarray(flat[f"{sp}/.charge"]).reshape(-1)[0]),
            float(np.asarray(flat[f"{sp}/.mass"]).reshape(-1)[0]))
    return PicState(**species, **{k: t(np.asarray(flat[k])) for k in SCALARS})


def state_to_numpy(state: PicState) -> dict:
    out = {}
    for sp in SPECIES:
        s = getattr(state, sp)
        for f in Species._fields:
            v = getattr(s, f)
            out[f"{sp}/.{f}"] = (v.detach().cpu().numpy()
                                 if isinstance(v, torch.Tensor)
                                 else np.asarray(v))
    for k in SCALARS:
        out[k] = getattr(state, k).detach().cpu().numpy()
    return out
