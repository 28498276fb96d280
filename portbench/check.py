"""The comparison that decides `correct`, each number beside its limit.

The plain reference (`portbench/reference`) follows the program step by
step from the program's own states, which the run holds at steps drawn
from the seed: a step of the paper's case is chaotic in the order of its
float sums (a neutral whose uniform draw lies within rounding of its
ionization probability may go either way, and every later slot moves),
so a reference run from the seed alone would part from any correct
program within steps. The start is checked on its own (`init_gap`), and
so is what links the sampled steps (`conservation`, every diagnostics
step).

- `init_gap`: the run's initial state against the reference's from the
  seed, largest difference (exact: 0).
- `step_gap`: each sampled step against the reference's step from the
  same state, the largest difference of a field over its largest value;
  where a neutral's draw lies within `MARGIN` of the reference's
  probability, the reference takes the program's decision.
- `bad_events`: neutrals the program ionized, or did not, against the
  reference's decision and outside that margin.
- `flight_gap`: in each sampled chunk, over its steps before and after
  the held one (each run as one call of the program), the particles
  alive from start to end against the reference's free flights from the
  start: the largest position difference over L; a velocity or weight
  that changed, a neutral slot that came alive or an electron or ion
  slot that died reads infinitely far. Distances are the periodic
  box's.
- `schedule_bad`: chunks whose last state's key and step counter are
  not the chunk's first advanced a step at a time by the reference's
  key schedule.
- `diag_gap`: the diagnostics the series holds at the sampled steps
  against the reference's from the same state, largest difference over
  the largest value.
- `conservation`: at every diagnostics step, neutrals plus ions and
  electrons minus ions against their initial values (no slot overflows
  at these sizes), the largest drift beyond what float32 counts can
  carry: the program counts a species as a float32 sum of its alive
  flags, exact below 2**24 and, above, allowed two units in the last
  place of the count (the last additions of the reduction round).
- `diag_readback`: diagnostics arrays that read back from disk other
  than as handed to the writer, or not at all.
- `ckpt_bad`: leaves of the committed checkpoints that the reference's
  reader finds other than the state saved (every leaf's metadata; the
  small leaves whole; of each large leaf its first, last and `BLOCKS`
  more of its codec blocks, drawn from the seed), and checkpoints missing.
- `restore_bad`: leaves the restore returns other than the newest
  checkpoint's state, bit for bit, on its device.
- `shm_left`: files the run left in /dev/shm.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import bp4, pic

#: each number's limit; PERF.md gives the readings they were set from
LIMITS = {"init_gap": 0.0, "step_gap": 1e-4, "bad_events": 2,
          "flight_gap": 1e-4, "schedule_bad": 0, "diag_gap": 3e-3, "conservation": 0.0, "diag_readback": 0,
          "ckpt_bad": 0, "restore_bad": 0, "shm_left": 0}
#: the band of a draw around its probability inside which either
#: decision is sound
MARGIN = 1e-5
#: codec blocks checked a large leaf, besides its first and last
BLOCKS = 4

_SPECIES = (("electrons", "e"), ("ions", "D_plus"), ("neutrals", "D"))


def to_ref(state) -> dict:
    """The program's state as the reference's plain dict."""
    out = {ref: {f: getattr(getattr(state, attr), f) for f in pic.FIELDS}
           for attr, ref in _SPECIES}
    out["key"] = state.key
    out["step"] = int(state.step)
    out["ionizations"] = float(state.total_ionizations)
    return out


def _finite(x: float) -> float:
    """A NaN difference reads as infinitely far."""
    return float("inf") if x != x else x


def _rel_gap(ref: dict, got: dict) -> float:
    gap = 0.0
    for sp in pic.SPECIES:
        for f in pic.FIELDS:
            r, g = ref[sp][f].float(), got[sp][f].float()
            scale = max(float(r.abs().max()), 1e-30)
            gap = max(gap, _finite(float((r - g).abs().max()) / scale))
    if not torch.equal(ref["key"].cpu(), got["key"].cpu()):
        gap = float("inf")
    return gap


def _array_gap(ref: dict, got: dict) -> float:
    gap = 0.0
    for name, r in ref.items():
        g = got.get(name)
        if g is None or g.shape != r.shape:
            return float("inf")
        scale = max(float(np.abs(r).max()), 1e-30)
        gap = max(gap, _finite(
            float(np.abs(r.astype(np.float64) - g).max()) / scale))
    return gap


def init_gap(cfg: dict, seed: int, state) -> float:
    ref = pic.init_state(cfg, seed, state.key.device)
    got = to_ref(state)
    gap = max(_finite(float((ref[sp][f] - got[sp][f]).abs().max()))
              for sp in pic.SPECIES for f in pic.FIELDS)
    return gap if torch.equal(ref["key"], got["key"]) else float("inf")


def step_numbers(cfg: dict, pairs) -> tuple[float, int]:
    """(step_gap, bad_events) over the sampled (before, after) pairs."""
    gap, bad = 0.0, 0
    for before, after in pairs:
        a, b = to_ref(before), to_ref(after)
        _, info = pic.step(a, cfg)
        took = (a["D"]["alive"] > 0) & (b["D"]["alive"] <= 0)
        close = (info["u"] - info["p"]).abs() <= MARGIN
        bad += int(((took != info["events"]) & ~close).sum())
        ref, _ = pic.step(a, cfg, events=torch.where(close, took,
                                                     info["events"]))
        gap = max(gap, _rel_gap(ref, b))
    return gap, bad


def _flight(a: dict, b: dict, steps: int, cfg: dict) -> float:
    gap = 0.0
    for sp in pic.SPECIES:
        live_a, live_b = a[sp]["alive"] > 0, b[sp]["alive"] > 0
        # a neutral only dies (ionized); in the periodic box an electron
        # or ion never does
        if bool((live_b & ~live_a).any() if sp == "D"
                else (live_a & ~live_b).any()):
            return float("inf")
        keep = live_a & live_b
        if not bool(keep.any()):
            continue
        if not (torch.equal(a[sp]["v"][keep], b[sp]["v"][keep])
                and torch.equal(a[sp]["w"][keep], b[sp]["w"][keep])):
            return float("inf")
        x = pic.fly(a[sp]["x"][keep], a[sp]["v"][keep], cfg["dt"], cfg["L"],
                    steps)
        d = (x - b[sp]["x"][keep]).abs()
        # positions 0 and L are one point of the periodic box
        d = torch.minimum(d, cfg["L"] - d)
        gap = max(gap, _finite(float(d.max()) / cfg["L"]))
    return gap


def flight_gap(cfg: dict, samples) -> float:
    """Over the sampled (start, before, after, end) states."""
    gap = 0.0
    for start, before, after, end in samples:
        for a, b in ((start, before), (after, end)):
            steps = int(b.step) - int(a.step)
            if steps:
                gap = max(gap, _flight(to_ref(a), to_ref(b), steps, cfg))
    return gap


def schedule_bad(init, ends, steps: int) -> int:
    """`ends`: (key, step counter) of each chunk's last state, in order;
    each chunk `steps` long."""
    key, at = pic.key_int(init.key), int(init.step)
    bad = 0
    for k_end, s_end in ends:
        for _ in range(steps):
            key = pic.split_seed(key, 2)[0]
        got_key, got_at = pic.key_int(k_end), int(s_end)
        bad += got_key != key or got_at != at + steps
        # the next chunk is judged from where this one ended
        key, at = got_key, got_at
    return bad


def mesh_var(step: int, name: str) -> str:
    return f"/data/{step}/meshes/{name.replace('/', '_')}"


def read_diagnostics(series: bp4.Series, step: int, names) -> dict:
    out = {}
    for name in names:
        try:
            out[name] = series.read(step, mesh_var(step, name))
        except (KeyError, OSError, ValueError):
            pass
    return out


def _rounding(count: float) -> float:
    """What a float32 sum of alive flags totalling `count` may be off by."""
    if count < 2 ** 24:
        return 0.0
    return 2.0 * float(np.spacing(np.float32(count)))


def diag_numbers(cfg: dict, series_path, written: dict, sampled: dict,
                 init_counts: dict) -> dict:
    """diag_gap at the sampled steps ({step: state}), diag_readback and
    conservation over every written step ({step: diag})."""
    try:
        series = bp4.Series(series_path)
    except OSError:
        series = None
    readback, drift, gap = 0, 0.0, 0.0
    for step, diag in written.items():
        arrays = {k: v for k, v in diag.items() if isinstance(v, np.ndarray)}
        got = (read_diagnostics(series, step, arrays)
               if series is not None and step in series.meta else {})
        readback += sum(1 for k, v in arrays.items()
                        if k not in got or not np.array_equal(got[k], v))
        c = {k: diag[f"count/{k}"] for k in ("e", "D_plus", "D")}
        drift = max(drift,
                    abs(c["D"] + c["D_plus"] - init_counts["heavy"])
                    - _rounding(c["D"]) - _rounding(c["D_plus"]),
                    abs(c["e"] - c["D_plus"] - init_counts["charge"])
                    - _rounding(c["e"]) - _rounding(c["D_plus"]))
        if step in sampled:
            ref = pic.diagnostics(to_ref(sampled[step]), cfg,
                                  v_bins=cfg["io"]["diagnostics"]["v_bins"])
            gap = max(gap, _array_gap(ref, got))
    return {"diag_gap": gap, "diag_readback": readback,
            "conservation": drift}


def leaves(state: dict) -> dict:
    """The checkpoint's variables and the values they must hold, named
    as the series names them."""
    out = {}
    for attr, _ in _SPECIES:
        sp = state[attr]
        for f in ("x", "v", "w", "alive", "charge", "mass"):
            out[f"state/{attr}/.{f}"] = getattr(sp, f)
    for f in ("key", "step", "total_ionizations", "wall_flux_e",
              "wall_flux_i"):
        out[f"state/{f}"] = state[f]
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def _leaf_bad(series: bp4.Series, step: int, name: str, want: np.ndarray,
              rng) -> bool:
    var = series.var(step, name)
    # a 0-d leaf is stored as shape (1,)
    if (np.dtype(var["dtype"]) != want.dtype
            or tuple(var["shape"]) != (want.shape or (1,))):
        return True
    if want.nbytes <= bp4.BLOCK.size * 4096:
        got = series.read(step, name)
        return not np.array_equal(got.reshape(want.shape), want)
    for ch in var["chunks"]:
        box = tuple(slice(o, o + e) for o, e in zip(ch["offset"], ch["extent"]))
        raw = np.ascontiguousarray(want[box]).view(np.uint8).reshape(-1)
        blocks = series.blocks(ch)
        if sum(h[4] for _, _, h in blocks) != raw.size:
            return True
        pick = {0, len(blocks) - 1} | set(
            rng.choice(len(blocks), size=min(BLOCKS, len(blocks)),
                       replace=False).tolist())
        for j in sorted(pick):
            off, pos, head = blocks[j]
            got = series.read_block(ch, pos, head)
            if got != raw[off:off + head[4]].tobytes():
                return True
    return False


def ckpt_bad(ckpt_dir, saved: dict, seed: int) -> int:
    """Over the committed checkpoints ({step: state})."""
    rng = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF)
    bad = 0
    for step, state in saved.items():
        want = leaves(state._asdict())
        try:
            series = bp4.Series(ckpt_dir / f"step_{step:08d}.bp4")
            names = set(series.meta[step]["vars"])
        except (OSError, KeyError, ValueError):
            bad += len(want)
            continue
        bad += len(names ^ set(want))
        for name in names & set(want):
            try:
                bad += _leaf_bad(series, step, name, want[name], rng)
            except (OSError, ValueError):
                bad += 1
    return bad


def restore_bad(restored, step: int, state) -> int:
    """`restored`: what the restore returned, (state dict, step)."""
    if restored is None:
        return len(leaves(state._asdict()))
    got, at = restored
    bad = int(at != step)
    want = state._asdict()
    for attr, _ in _SPECIES:
        for f in ("x", "v", "w", "alive", "charge", "mass"):
            a, b = getattr(got[attr], f), getattr(want[attr], f)
            bad += not _same(a, b)
    for f in ("key", "step", "total_ionizations", "wall_flux_e",
              "wall_flux_i"):
        bad += not _same(got[f], want[f])
    return bad


def _same(a, b) -> bool:
    if isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    return a == b


def judged(numbers: dict) -> dict:
    """{name: {"value", "limit"}}; an infinite value (no reading, or a
    mismatch that has no size) is written as 1e300, which JSON holds."""
    return {k: {"value": min(v, 1e300), "limit": LIMITS[k]}
            for k, v in numbers.items()}


def correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
