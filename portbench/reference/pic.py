"""Plain PyTorch reference of the PIC-MC step of the paper's §III-C case.

Electrons, D+ ions and D neutrals in a 1D periodic box; no field solve
and no smoothing, so the field is zero and only the ionization
e + D -> 2e + D+ and the free flight move particles. Each species is a
fixed number of slots with an alive mask; a new particle takes the
lowest free slot. Written from the case's equations, not from the code
under test, whose module it never imports: one function a stage, no
kernels, every array in `dtype` (float32 as the configuration states;
the benchmark's control runs it in bfloat16).

The random draws of a step come from a `torch.Generator` on the state's
device seeded from the state's uint32[2] key by splitmix64, so the same
key gives the same draws here and in the program.
"""
from __future__ import annotations

import torch

SPECIES = ("e", "D_plus", "D")
MASS = {"e": 1.0, "D_plus": 1836.0, "D": 1836.0}
FIELDS = ("x", "v", "w", "alive")

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def split_seed(s: int, num: int) -> list[int]:
    """`num` 64-bit seeds derived from one."""
    return [_splitmix64(s ^ ((0x632BE59BD9B4E019 * (j + 1)) & _MASK64))
            for j in range(num)]


def key_int(key: torch.Tensor) -> int:
    hi, lo = (int(k) for k in key.cpu())
    return (hi << 32) | lo


def key_tensor(s: int, device) -> torch.Tensor:
    return torch.tensor([s >> 32, s & 0xFFFFFFFF], dtype=torch.uint32,
                        device=device)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def init_state(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Positions uniform on [0, L), velocities normal times the species'
    thermal speed; the first n slots of each species alive, weight 1."""
    s = split_seed(seed & _MASK64, 4)
    C = cfg["capacity"]
    vth = {"e": cfg["v_thermal_e"], "D_plus": cfg["v_thermal_i"],
           "D": cfg["v_thermal_i"]}
    live = {"e": cfg["n_electrons"], "D_plus": cfg["n_ions"],
            "D": cfg["n_neutrals"]}
    out = {}
    for sp, seed_sp in zip(SPECIES, s[:3]):
        g = generator(seed_sp, device)
        x = torch.rand(C, generator=g, device=device) * cfg["L"]
        v = torch.randn(C, 3, generator=g, device=device) * vth[sp]
        alive = (torch.arange(C, device=device) < live[sp]).float()
        out[sp] = {"x": x.to(dtype), "v": v.to(dtype),
                   "w": torch.ones(C, dtype=dtype, device=device),
                   "alive": alive.to(dtype)}
    out["key"] = key_tensor(s[3], device)
    out["step"] = 0
    out["ionizations"] = 0.0
    return out


def deposit(x, w, alive, n_cells: int, dx: float):
    """Cloud-in-cell charge density [n_cells]: a particle's weight split
    between cell floor(x / dx) and the next, both clipped into the grid,
    over dx, accumulated in the inputs' type."""
    xi = x / torch.tensor(dx, dtype=x.dtype, device=x.device)
    i0 = torch.floor(xi).to(torch.int64)
    frac = xi - i0
    wa = w * alive
    rho = torch.zeros(n_cells, dtype=x.dtype, device=x.device)
    rho.index_add_(0, i0.clamp(0, n_cells - 1), wa * (1.0 - frac))
    rho.index_add_(0, (i0 + 1).clamp(0, n_cells - 1), wa * frac)
    return rho / dx


def ionization_probability(state: dict, cfg: dict):
    """Each neutral's chance of ionizing this step, 1 - exp(-n_e R dt),
    with n_e the electrons in the neutral's cell (deposited density
    times dx)."""
    n_cells, L = cfg["n_cells"], cfg["L"]
    dx = L / n_cells
    e, n = state["e"], state["D"]
    ne_cells = deposit(e["x"], e["w"], e["alive"], n_cells, dx) * dx
    cell = (n["x"] / dx).to(torch.int64).clamp(0, n_cells - 1)
    return 1.0 - torch.exp(-ne_cells[cell] * cfg["rate_R"] * cfg["dt"])


def draws(state: dict):
    """The step's uniforms [C] and normal kicks [C, 3], in float32, and
    the key of the next step."""
    nxt, sub = split_seed(key_int(state["key"]), 2)
    C = state["D"]["x"].shape[0]
    dev = state["D"]["x"].device
    g = generator(sub, dev)
    u = torch.rand(C, generator=g, device=dev)
    kick = torch.randn(C, 3, generator=g, device=dev)
    return u, kick, key_tensor(nxt, state["key"].device)


def _spawn(sp: dict, new: dict, event):
    """The k-th event, in slot order, takes the k-th free slot; events
    beyond the free slots are dropped."""
    free = torch.nonzero(sp["alive"] <= 0).flatten()
    src = torch.nonzero(event).flatten()
    m = min(free.numel(), src.numel())
    out = {k: v.clone() for k, v in sp.items()}
    for f in ("x", "v", "w"):
        out[f][free[:m]] = new[f][src[:m]]
    out["alive"][free[:m]] = 1.0
    return out


def fly(x, v, dt: float, L: float, steps: int = 1):
    """`steps` free flights in a periodic box (the field is zero): the
    positions after them."""
    for _ in range(steps):
        x = torch.remainder(x + v[:, 0] * dt, L)
    return x


def _fly(sp: dict, dt: float, L: float):
    return {**sp, "x": fly(sp["x"], sp["v"], dt, L)}


def step(state: dict, cfg: dict, *, dtype=torch.float32, events=None):
    """One step from `state` (cast to `dtype`). `events` [C] bool, if
    given, names the neutrals that ionize instead of the draws. Returns
    the next state (floats in float32) and the step's uniforms,
    probabilities and events."""
    if cfg["field_solve"] or cfg["smoothing"] or cfg["boundary"] != "periodic":
        raise ValueError("the reference covers the paper's case: periodic, "
                         "no field solve, no smoothing")
    s = {sp: {f: state[sp][f].to(dtype) for f in FIELDS} for sp in SPECIES}
    s["key"] = state["key"]
    u, kick, key = draws(state)
    p = ionization_probability(s, cfg)
    n = s["D"]
    if events is None:
        events = (u.to(dtype) < p) & (n["alive"] > 0)
    born = {"x": n["x"], "w": n["w"], "v": n["v"] + kick.to(dtype) * 1e-2}
    e = _spawn(s["e"], born, events)
    i = _spawn(s["D_plus"], {**born, "v": n["v"]}, events)
    n = {**n, "alive": torch.where(events, 0.0, n["alive"]).to(dtype)}
    out = {sp: {f: v.float() for f, v in _fly(part, cfg["dt"], cfg["L"]).items()}
           for sp, part in (("e", e), ("D_plus", i), ("D", n))}
    out["key"] = key
    out["step"] = state["step"] + 1
    out["ionizations"] = state["ionizations"] + float(events.sum())
    return out, {"u": u, "p": p.float(), "events": events}


def _histogram(values, weights, bins: int, lo: float, hi: float):
    """Weighted histogram: bins of equal width on [lo, hi], the last one
    closed on the right; values outside are dropped."""
    edges = torch.linspace(lo, hi, bins + 1, dtype=values.dtype,
                           device=values.device)
    idx = torch.searchsorted(edges, values.contiguous(), right=True)
    idx = torch.where(values == edges[-1], bins, idx)
    counts = torch.bincount(idx, weights=weights.float(), minlength=bins + 2)
    return counts[1:bins + 1].to(weights.dtype)


def diagnostics(state: dict, cfg: dict, *, v_bins: int = 64,
                dtype=torch.float32) -> dict:
    """BIT1's profile diagnostics: each species' density on the grid and
    its distributions of speed and kinetic energy, weighted by the live
    particles' weights, as float32 host arrays."""
    dx = cfg["L"] / cfg["n_cells"]
    out = {}
    for sp in SPECIES:
        p = {f: state[sp][f].to(dtype) for f in FIELDS}
        out[f"density/{sp}"] = deposit(p["x"], p["w"], p["alive"],
                                       cfg["n_cells"], dx)
        speed = torch.linalg.vector_norm(p["v"], dim=-1)
        wa = p["w"] * p["alive"]
        out[f"vdist/{sp}"] = _histogram(speed, wa, v_bins, 0.0, 5.0)
        out[f"edist/{sp}"] = _histogram(0.5 * MASS[sp] * speed ** 2, wa,
                                        v_bins, 0.0, 10.0)
    return {k: v.float().cpu().numpy() for k, v in out.items()}
