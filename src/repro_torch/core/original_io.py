"""BIT1 'Original I/O' baseline (paper §IV, Figs 2-5, Table II).

The pre-openPMD BIT1 writes, per diagnostic dump, one small text .dat file
per rank (fprintf-style: many tiny formatted writes, open/close per dump)
and per checkpoint one binary .dmp file per rank. File count grows O(ranks),
file size shrinks O(1/ranks), and metadata ops dominate — the pathology the
paper measures with Darshan and then eliminates. We reproduce it faithfully
so the benchmarks have the paper's own baseline to beat.
"""
from __future__ import annotations

import pathlib

import numpy as np

from repro_torch.core.darshan import open_file


def write_dat(dirpath, rank: int, step: int, arrays: dict[str, np.ndarray],
              values_per_line: int = 8) -> pathlib.Path:
    """One diagnostic snapshot, one rank: formatted text, many small writes."""
    d = pathlib.Path(str(dirpath))
    d.mkdir(parents=True, exist_ok=True)
    p = d / f"diag_{step:07d}_r{rank:05d}.dat"
    with open_file(p, "w", rank=rank) as f:
        for name, arr in arrays.items():
            flat = np.asarray(arr).ravel()
            f.write(f"# {name} n={flat.size}\n")
            for i in range(0, flat.size, values_per_line):
                line = " ".join(f"{float(v):.6e}" for v in
                                flat[i:i + values_per_line])
                f.write(line + "\n")          # fprintf-per-line pathology
    return p


def write_dmp(dirpath, rank: int, step: int,
              arrays: dict[str, np.ndarray]) -> pathlib.Path:
    """One checkpoint, one rank: raw binary, one file per rank."""
    d = pathlib.Path(str(dirpath))
    d.mkdir(parents=True, exist_ok=True)
    p = d / f"state_{step:07d}_r{rank:05d}.dmp"
    with open_file(p, "wb", rank=rank) as f:
        for name, arr in arrays.items():
            a = np.ascontiguousarray(arr)
            hdr = f"{name}|{a.dtype.str}|{','.join(map(str, a.shape))}\n"
            f.write(hdr.encode())
            f.write(a.tobytes())
        f.fsync()
    return p


def read_dmp(path, rank: int = 0) -> dict[str, np.ndarray]:
    out = {}
    with open_file(path, "rb", rank=rank) as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        nl = data.index(b"\n", pos)
        name, dt, shp = data[pos:nl].decode().split("|")
        shape = tuple(int(x) for x in shp.split(",")) if shp else ()
        n = int(np.prod(shape)) if shape else 1
        dtype = np.dtype(dt)
        start = nl + 1
        end = start + n * dtype.itemsize
        out[name] = np.frombuffer(data[start:end], dtype=dtype).reshape(shape)
        pos = end
    return out
