"""BIT1-like 1D3V electrostatic PIC-MC simulation driver.

Implements the five-phase PIC cycle of the paper (§II): deposition ->
smoothing -> field solve -> MC collisions/walls -> push. The paper's use
case (§III-C — neutral ionization in an unbounded unmagnetized plasma,
no field solver or smoother) is `PicConfig(field_solve=False,
boundary='periodic')` with three species (e, D+, D).

Diagnostics mirror BIT1's five I/O knobs: `mvstep`-periodic profile/
distribution diagnostics (.dat analogue -> openPMD meshes) and
`dmpstep`-periodic full particle state dumps (.dmp analogue -> openPMD
particle species through the JBP engine).

Randomness: `PicState.key` is a uint32[2] tensor, as in the JAX package.
Each step splits it on the host (splitmix64) into the next key and the
seed of that step's `torch.Generator`, so a run, and a restart from a
checkpoint, is deterministic within the port. The draws themselves are
not the JAX package's; `pic_step(..., draws=...)` takes them from the
caller instead, which is how a test replays that package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.dxt import TRACER
from repro_torch.pic import collisions, fields, grid
from repro_torch.pic.particles import Species, init_species, push


@dataclasses.dataclass(frozen=True)
class PicConfig:
    n_cells: int = 1024
    L: float = 1.0
    dt: float = 1e-3
    capacity: int = 1 << 15           # per species
    n_electrons: int = 8192
    n_ions: int = 8192
    n_neutrals: int = 8192
    v_thermal_e: float = 1.0
    v_thermal_i: float = 0.02
    rate_R: float = 0.05              # ionization rate coefficient
    boundary: str = "periodic"        # periodic | absorbing
    field_solve: bool = False         # paper's use case skips solver+smoother
    smoothing: bool = False
    eps0: float = 1.0

    @property
    def dx(self):
        return self.L / self.n_cells


class PicState(NamedTuple):
    electrons: Species
    ions: Species
    neutrals: Species
    key: torch.Tensor
    step: torch.Tensor
    wall_flux_e: torch.Tensor
    wall_flux_i: torch.Tensor
    total_ionizations: torch.Tensor


# ---------------------------------------------------------------- key schedule
_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _key_tensor(s: int, device) -> torch.Tensor:
    return torch.tensor([s >> 32, s & 0xFFFFFFFF], dtype=torch.uint32,
                        device=device)


def _key_int(key: torch.Tensor) -> int:
    hi, lo = (int(k) for k in key.cpu().numpy())
    return (hi << 32) | lo


def _split(s: int, num: int) -> list[int]:
    return [_splitmix64(s ^ ((0x632BE59BD9B4E019 * (j + 1)) & _MASK64))
            for j in range(num)]


def split_key(key: torch.Tensor, num: int = 2) -> list[int]:
    """`num` 64-bit seeds derived from a uint32[2] key (reads it to host,
    `pic.key`: a sync of the step)."""
    with TRACER.span("key", layer="pic"):
        return _split(_key_int(key), num)


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_sim(cfg: PicConfig, seed: int = 0, *, device=None) -> PicState:
    """Three species drawn from `seed`, on `device` (CUDA by default)."""
    dev = resolve_device(device)
    s1, s2, s3, s4 = _split(seed & _MASK64, 4)
    e = init_species(_generator(s1, dev), cfg.capacity, cfg.n_electrons,
                     L=cfg.L, v_thermal=cfg.v_thermal_e, charge=-1.0,
                     mass=1.0, device=dev)
    i = init_species(_generator(s2, dev), cfg.capacity, cfg.n_ions, L=cfg.L,
                     v_thermal=cfg.v_thermal_i, charge=+1.0, mass=1836.0,
                     device=dev)
    n = init_species(_generator(s3, dev), cfg.capacity, cfg.n_neutrals,
                     L=cfg.L, v_thermal=cfg.v_thermal_i, charge=0.0,
                     mass=1836.0, device=dev)
    z = torch.zeros((), dtype=torch.float32, device=dev)
    return PicState(e, i, n, _key_tensor(s4, dev),
                    torch.zeros((), dtype=torch.int32, device=dev), z, z, z)


def pic_step(state: PicState, cfg: PicConfig,
             draws: Optional[dict] = None) -> PicState:
    """One PIC-MC cycle. `draws` may hold the ionization draws "u" [C] and
    "kick" [C, 3]; what it lacks is drawn from the step's generator."""
    e, i, n = state.electrons, state.ions, state.neutrals
    dx = cfg.dx
    dev = e.x.device

    # 1-2. deposition + smoothing
    with TRACER.span("deposit", layer="pic"):
        rho_e = grid.deposit_cic(e.x, e.w, e.alive, cfg.n_cells, dx)
        rho_i = grid.deposit_cic(i.x, i.w, i.alive, cfg.n_cells, dx)
        rho = i.charge * rho_i + e.charge * rho_e
    if cfg.smoothing:
        rho = grid.smooth_121(rho)

    # 3. field solve
    if cfg.field_solve:
        _, E = fields.solve_poisson(rho, dx, cfg.eps0)
    else:
        E = torch.zeros((cfg.n_cells,), dtype=torch.float32, device=dev)

    # 4. MC collisions (ionization) — needs n_e per cell
    next_seed, sub = split_key(state.key)
    draws = draws or {}
    with TRACER.span("ionize", layer="pic"):
        e, i, n, info = collisions.ionize(
            _generator(sub, dev), e, i, n, rate_R=cfg.rate_R, dt=cfg.dt,
            L=cfg.L, n_cells=cfg.n_cells,
            electron_density_per_cell=rho_e * dx,
            u=draws.get("u"), kick=draws.get("kick"))

    # 5. push + walls
    with TRACER.span("push", layer="pic"):
        e, wf_e = push(e, grid.gather_field(E, e.x, dx), cfg.dt, cfg.L,
                       boundary=cfg.boundary)
        i, wf_i = push(i, grid.gather_field(E, i.x, dx), cfg.dt, cfg.L,
                       boundary=cfg.boundary)
        n, _ = push(n, torch.zeros_like(n.x), cfg.dt, cfg.L,
                    boundary=cfg.boundary)

    return PicState(e, i, n, _key_tensor(next_seed, state.key.device),
                    state.step + 1,
                    state.wall_flux_e + wf_e, state.wall_flux_i + wf_i,
                    state.total_ionizations + info["ionizations"])


def pic_run_chunk(state: PicState, cfg: PicConfig, n_steps: int) -> PicState:
    for _ in range(n_steps):
        state = pic_step(state, cfg)
    return state


# ---------------------------------------------------------------- diagnostics
def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().cpu().numpy()


def _histogram(values, weights, bins: int, lo: float, hi: float):
    """Weighted histogram with jnp.histogram's (and numpy's) rules: the
    last bin includes its right edge, values outside [lo, hi] (and NaN)
    are dropped."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=values.dtype,
                           device=values.device)
    idx = torch.searchsorted(edges, values.contiguous(), right=True)
    idx = torch.where(values == edges[-1], bins, idx)
    counts = torch.bincount(idx, weights=weights, minlength=bins + 2)
    return counts[1:bins + 1].to(weights.dtype)


def diagnostics(state: PicState, cfg: PicConfig, *, v_bins: int = 64) -> dict:
    """BIT1 'slow' diagnostics: plasma profiles + velocity/energy dists."""
    out = {}
    for name, sp in (("e", state.electrons), ("D_plus", state.ions),
                     ("D", state.neutrals)):
        dens = grid.deposit_cic(sp.x, sp.w, sp.alive, cfg.n_cells, cfg.dx)
        out[f"density/{name}"] = _host(dens)
        vmag = torch.linalg.vector_norm(sp.v, dim=-1)
        wa = sp.w * sp.alive
        out[f"vdist/{name}"] = _host(_histogram(vmag, wa, v_bins, 0.0, 5.0))
        energy = 0.5 * sp.mass * vmag**2
        out[f"edist/{name}"] = _host(_histogram(energy, wa, v_bins, 0.0,
                                                10.0))
        out[f"count/{name}"] = float(sp.count())
    out["wall_flux/e"] = float(state.wall_flux_e)
    out["wall_flux/i"] = float(state.wall_flux_i)
    out["ionizations"] = float(state.total_ionizations)
    return out


def write_diagnostics_openpmd(series, state: PicState, cfg: PicConfig,
                              *, n_io_ranks: int = 8, diag: Optional[dict] = None):
    """Stream one diagnostic snapshot through openPMD (datfile analogue).
    Pass a precomputed `diag` to share one snapshot between the openPMD
    write and in-situ consumers."""
    step = int(state.step)
    it = series.iterations[step]
    it.time = step * cfg.dt
    if diag is None:
        diag = diagnostics(state, cfg)
    for name, arr in diag.items():
        if not isinstance(arr, np.ndarray):
            continue
        rc = it.meshes[name.replace("/", "_")][""]
        rc.reset_dataset(arr.dtype, arr.shape)
        # profile diagnostics are rank-decomposed like BIT1's grid split
        n = arr.shape[0]
        per = max(n // n_io_ranks, 1)
        for r in range(min(n_io_ranks, n)):
            lo = r * per
            hi = n if r == min(n_io_ranks, n) - 1 else (r + 1) * per
            rc.store_chunk(arr[lo:hi], offset=(lo,), rank=r)
    return it


def open_diagnostic_series(path, *, n_io_ranks: int = 8, async_io: bool = True,
                           engine_config=None, queue_depth: int = 2,
                           parallel_io: int = 0,
                           device_compress: bool = False):
    """Series for BIT1-style diagnostic output, async by default so dumps
    never stall the push/deposit loop. `parallel_io=W` moves compression
    and the subfile appends into W writer processes, with the two-phase
    commit behind a bounded snapshot queue (`async_commit`) when
    `async_io`, so the push/deposit loop sees neither compression nor
    commit latency.

    `device_compress=True` turns on the on-device compression
    precondition: tensor chunks stored on the series are byte-shuffled on
    their device (the bitshuffle kernel on CUDA) before the host runs only
    the cheap LZ stage."""
    from repro_torch.core.bp_engine import EngineConfig
    from repro_torch.core.openpmd import Series
    if engine_config is None:
        engine_config = EngineConfig(aggregators=min(4, n_io_ranks),
                                     codec="blosc")
    dc = True if device_compress else None   # None: engine_config decides
    return Series(path, "w", n_ranks=n_io_ranks, engine_config=engine_config,
                  async_io=async_io and not parallel_io,
                  async_commit=async_io and bool(parallel_io),
                  parallel_io=parallel_io, queue_depth=queue_depth,
                  device_compress=dc)


def run_with_diagnostics(state: PicState, cfg: PicConfig, series=None, *,
                         n_chunks: int, steps_per_chunk: int,
                         dump_every: int = 0, n_io_ranks: int = 8,
                         reducers=None, stream=None) -> PicState:
    """BIT1 main loop: compute chunks interleaved with mvstep diagnostics
    (every chunk) and dmpstep particle dumps (every `dump_every` chunks).
    With an async series, `flush()` returns after the snapshot and the next
    chunk's compute overlaps the write pipeline; the final `drain()` is the
    durability barrier before returning.

    Each chunk's diagnostic snapshot is computed ONCE and fanned out to
      * `series`   — openPMD persistence (None: no filesystem in the loop),
      * `stream`   — any object with begin_step / put / end_step,
      * `reducers` — any object with update(step, arrays), updated inline.
    """
    for c in range(n_chunks):
        state = pic_run_chunk(state, cfg, steps_per_chunk)
        step = int(state.step)
        diag = diagnostics(state, cfg)
        arrays = {k: v for k, v in diag.items() if isinstance(v, np.ndarray)}
        if series is not None:
            write_diagnostics_openpmd(series, state, cfg,
                                      n_io_ranks=n_io_ranks, diag=diag)
            if dump_every and (c + 1) % dump_every == 0:
                write_particle_dump_openpmd(series, state, cfg,
                                            n_io_ranks=n_io_ranks)
            series.flush()
        if stream is not None:
            stream.begin_step(step)
            for name, arr in arrays.items():
                stream.put(name, arr, global_shape=arr.shape,
                           offset=(0,) * arr.ndim)
            stream.end_step()
        if reducers is not None:
            reducers.update(step, arrays)
    if series is not None:
        series.drain()
    return state


def write_particle_dump_openpmd(series, state: PicState, cfg: PicConfig,
                                *, n_io_ranks: int = 8):
    """Full particle state (dmp analogue): species records chunked by rank."""
    step = int(state.step)
    it = series.iterations[step]
    for name, sp in (("e", state.electrons), ("D_plus", state.ions),
                     ("D", state.neutrals)):
        species = it.particles[name]
        arrays = {"position/x": _host(sp.x),
                  "momentum/x": _host(sp.v[:, 0]),
                  "momentum/y": _host(sp.v[:, 1]),
                  "momentum/z": _host(sp.v[:, 2]),
                  "weighting": _host(sp.w * sp.alive)}
        C = sp.capacity
        per = max(C // n_io_ranks, 1)
        for rec_name, arr in arrays.items():
            rec, comp = (rec_name.split("/") + [""])[:2]
            rc = species[rec][comp]
            rc.reset_dataset(arr.dtype, arr.shape)
            for r in range(min(n_io_ranks, C)):
                lo = r * per
                hi = C if r == min(n_io_ranks, C) - 1 else (r + 1) * per
                rc.store_chunk(arr[lo:hi], offset=(lo,), rank=r)
    return it
