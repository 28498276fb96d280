#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from `src/repro_torch/csrc/` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times kernel, plain version and the
   one-call PyTorch yardstick with CUDA events, and kernel and yardstick
   on the device alone with torch.profiler;
4. drives the PIC main path at the paper's full width (`paper_config`:
   100,000 cells, 2^25 slots for each of 3 species): compute chunks,
   diagnostics, openPMD writes, a particle dump, a device-compressed
   checkpoint, restore and restart, and checks the results and the kernels'
   launch counts (the checkpoint's shuffle: one launch a shuffled leaf);
   on the same state the multi-process write plane: the dump again through
   4 writer processes (byte-identical to the serial series), a writer
   plane's spawn, and a device-compressed `CheckpointManager` save through
   that plane behind the next 10-step chunk, with its write, blocked and
   overlap times, the bytes each writer received, shm against pickle
   transport bytes, and a bit-exact restore;
   the same diagnostics and dump also go out the paper's Original-I/O way
   (one text .dat and one binary .dmp file a rank, 16 ranks), read back
   bit for bit, with seconds, files, bytes and Darshan counters beside
   the openPMD series'; then, from the main path's final state, in-situ
   streaming: 3 chunks of `run_with_diagnostics` into an `SstStream`
   teed to an `AsyncBpWriter`, with the SST example's four reducers live
   and inline, equal to the post-hoc replay of the teed series exactly;
5. holds the flash attention and SSD scan kernels against their plain
   versions at the serving paths' shapes (and a few others), and times
   flash at each serving shape beside SDPA; holds the flash kernel's lse
   output (training) against the plain version's at every head_dim and
   times it beside the serving call at the train shape;
5b. trains zamba2-2.7b at full width and depth (2,422,670,240 params,
   batch 8 x seq 256, remat, AdamW) for 3 steps through
   `make_train_step`: 18 flash and 162 SSD launches a step, the losses,
   grad norms and updated params within 2 noise floors of the same steps
   through the plain versions (the floor: the plain versions chunked
   otherwise), a 4th step profiled, peak memory;
6. drives the serving paths through `ServeEngine.generate`, random params
   from a seed, each with its own peak memory. Three at batch 4, prompt
   512, 32 new tokens: zamba2-2.7b at full width and depth (2,422,670,240
   params; 9 flash and 54 SSD launches per prefill), deepseek-moe-16b at
   full width and depth (16,375,728,128 params, initialised in bf16; 28
   flash launches per prefill) and llama-3.2-vision-90b at full width and
   10 of its 100 layers (10,657,898,500 params in bf16, seeded vision
   embeddings, cross gates at 1.0; 10 flash launches per prefill, 2 of
   them over 1600 image tokens), none in decode. Then a short serve
   (batch 2, prompt 128, 8 new tokens) of every other registered config
   that fits one card, at full width and depth: phi3-mini-3.8b (flash at
   head_dim 96), qwen1.5-0.5b, qwen3-4b, smollm-360m, mamba2-2.7b (the SSD
   kernel alone) and musicgen-large; arctic-480b does not fit and is
   named as not run. On every path each kernel against its
   plain version on the prefill's activations, and, in units of a noise
   floor, the forward through the kernels against the one through the
   plain versions and decode against a teacher-forced forward (for the
   moe, at no-drop capacity, with the share of routing decisions that
   agree);
6b. trains smollm-360m at full width and 4 of its 32 layers through
   `Trainer` with device-compressed checkpoints every 2 steps and
   deterministic algorithms: an uninterrupted run, a run that crashes
   after step 3 and one that resumes from step 2, equal to the
   uninterrupted run bit for bit, then a serve from the newest
   checkpoint, whose variables carry the JAX package's names;
7. prints one JSON line of per-kernel numbers, then, as the last line,
   `{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero too when no CUDA device is visible, and when run
outside a checkout of the repository (it imports `repro_torch` from
`src/` beside it). It never imports JAX or the JAX package.
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
#: NVIDIA H100 SXM data sheet: HBM3 rate, fp32 (non-tensor-core) and dense
#: bf16 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
#: ops per particle of the deposit: x/dx, floor, frac, w*alive, 1-frac,
#: two products, two atomic adds
DEPOSIT_OPS = 9
#: name fragments of the port's CUDA kernels, as the profiler shows them
PORT_KERNELS = ("deposit_cic", "shuffle_kernel", "flash_fwd_mma",
                "ssd_cb_kernel", "ssd_chunk_scan_kernel")


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Median over `reps` of the mean CUDA-event time of `iters` calls;
    `fn(i)` gets the call's index."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for i in range(iters):
            fn(i)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / iters)
    return statistics.median(times)


def _device_us(ev, self_only=False) -> float:
    pre = "self_" if self_only else ""
    for unit in ("device", "cuda"):
        v = getattr(ev, f"{pre}{unit}_time_total", None)
        if v:
            return float(v)
    return 0.0


def _profiled(torch, fn, iters: int):
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    return prof.key_averages()


def _per_call_us(events, iters: int, kernel: str | None = None) -> float:
    """Device us of one call from the profiler's rows: for each kernel, copy
    or fill (those whose name holds `kernel`, if given), its mean time a
    launch times its launches a call, ceil(count / iters). The mean is
    taken per launch because a profile taken late in a long process may
    miss some of the launches it ran (a row's count below `iters`), while
    the launches it keeps time alike."""
    total = 0.0
    for ev in events:
        us = _device_us(ev, self_only=True)
        if us and ev.count and (kernel is None or kernel in ev.key):
            total += us / ev.count * max(1, math.ceil(ev.count / iters - 1e-9))
    return total


def device_ms(torch, fn, iters: int, kernel: str) -> float:
    """Device time of one call of `fn`, a wrapper, in its own kernels: the
    kernels whose name holds `kernel`, each its mean launch times its
    launches a call (torch.profiler; no host time in it). With one launch
    a call this is the mean launch; the SSD scan's two kernels add.
    Raises when the profiler records no device time for such a kernel."""
    events = _profiled(torch, fn, iters)
    total = _per_call_us(events, iters, kernel)
    if not total:
        raise RuntimeError(f"the profiler recorded no device time for "
                           f"kernels named {kernel!r}; it recorded "
                           f"{[(ev.key[:60], _device_us(ev)) for ev in events]}")
    return total / 1e3


def library_device_ms(torch, fn, iters: int) -> float:
    """Device time of one call of `fn` in everything it launches: kernels,
    copies and fills (torch.profiler), counted as `device_ms` counts. For a
    PyTorch yardstick this is its device time; for a wrapper, its whole
    call (its output allocation's fill, its own kernels, `rho / dx`).
    Raises when the profiler records no device time."""
    total = _per_call_us(_profiled(torch, fn, iters), iters)
    if not total:
        raise RuntimeError("the profiler recorded no device time")
    return total / 1e3


def profile_steps(torch, dev, n_steps: int = 3) -> dict:
    """Where one PIC step's device time goes at paper width: device time
    by kernel over `n_steps` steps (device activity only, so no time is
    counted twice under its host op), and the device time of a step
    against its profiled wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.bit1 import paper_config
    from repro_torch.pic import simulation as sim
    cfg = paper_config()
    state = sim.pic_step(sim.init_sim(cfg, 1, device=dev), cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = sim.pic_step(state, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"steps": n_steps, **_profile_rows(prof, wall, n_steps)}


def _profile_rows(prof, wall_s, n):
    """Per-call device ms of the profiled work, its wall ms, the device's
    idle share of that wall, and the largest kernels by device time."""
    rows = sorted(((ev.key, _device_us(ev, self_only=True), ev.count)
                   for ev in prof.key_averages()), key=lambda r: -r[1])
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e3 / n
    if not busy:
        print("profile: the profiler recorded no device time; device ms and "
              "idle share not measured")
        return {"device_ms": None, "profiled_wall_ms": 1e3 * wall_s / n,
                "idle_share": None, "launches": None, "port_kernels": {},
                "top": []}
    # the port's own kernels: device ms and recorded launches per step, and
    # the mean ms a launch (a long process's profile may miss launches)
    ours = {}
    for name in PORT_KERNELS:
        us = sum(u for k, u, _ in rows if name in k)
        count = sum(c for k, _, c in rows if name in k)
        ours[name] = [us / 1e3 / n, count / n, us / 1e3 / max(count, 1)]
    return {"device_ms": busy, "profiled_wall_ms": 1e3 * wall_s / n,
            "idle_share": 1 - busy / (1e3 * wall_s / n),
            "launches": sum(r[2] for r in rows) / n,
            "port_kernels": {k: v for k, v in ours.items() if v[1]},
            "top": [[k[:80], us / 1e3 / n, c / n] for k, us, c in rows[:12]]}


def _deposit_inputs(torch, dev, n: int, L: float, seed: int):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.rand(n, generator=g, device=dev) * L
    # a few positions at and just below L pile into the last cell
    x[:1024] = L
    x[1024:2048] = torch.nextafter(torch.tensor(L), torch.tensor(0.0))
    w = 0.5 + 1.5 * torch.rand(n, generator=g, device=dev)
    alive = (torch.rand(n, generator=g, device=dev) > 0.25).float()
    return x, w, alive


def _deposit_errors(got, ref, w, alive, dx) -> tuple[float, float, float]:
    max_abs = float((got - ref).abs().max())
    rel = max_abs / max(float(ref.abs().max()), 1e-9)
    total = float((w * alive).double().sum())
    charge = abs(float(got.double().sum()) * dx - total) / total
    return max_abs, rel, charge


def check_deposit(torch, dev, n: int, n_cells: int) -> dict:
    """The kernel against its plain version at the main path's shape (the
    cluster path) and on a grid past the cluster's shared memory (the
    global-atomic path, at 2^22 particles); times at the main path's
    shape."""
    from repro_torch.kernels.deposit import ops as dops
    from repro_torch.kernels.deposit.ref import deposit_ref
    L = 1.0
    paths = {}
    for nc, nn, expect in ((n_cells, n, "cluster"),
                           (dops.cluster_cell_limit() + 1, 1 << 22,
                            "global")):
        dx = L / nc
        x, w, alive = _deposit_inputs(torch, dev, nn, L, 1234)
        got = dops.deposit(x, w, alive, n_cells=nc, dx=dx)
        ref = deposit_ref(x, w, alive, nc, dx)
        torch.cuda.synchronize()
        max_abs, rel, charge = _deposit_errors(got, ref, w, alive, dx)
        paths[dops.deposit.last_path] = max_abs
        print(f"deposit n={nn} n_cells={nc} ({dops.deposit.last_path} path):"
              f" max_abs_err={max_abs:.6g} rel={rel:.3g} "
              f"charge_err={charge:.3g}")
        if dops.deposit.last_path != expect:
            raise AssertionError(f"deposit at {nc} cells took the "
                                 f"{dops.deposit.last_path} path")
        if not rel < 1e-4:
            raise AssertionError(f"deposit disagrees with plain: rel {rel}")
        if not charge < 1e-5:
            raise AssertionError(f"deposit does not conserve charge: "
                                 f"{charge}")

    dx = L / n_cells
    x, w, alive = _deposit_inputs(torch, dev, n, L, 1234)
    xi = x / dx
    i0 = torch.floor(xi).long()
    frac = xi - i0
    wa = w * alive
    i0c = i0.clamp(0, n_cells - 1)
    i1c = (i0 + 1).clamp(0, n_cells - 1)
    w0, w1 = wa * (1 - frac), wa * frac

    def kernel(i):
        return dops.deposit(x, w, alive, n_cells=n_cells, dx=dx)
    ms = time_ms(torch, kernel, 20)
    plain = time_ms(torch, lambda i: deposit_ref(x, w, alive, n_cells, dx), 5)

    def bincounts(i):
        return (torch.bincount(i0c, weights=w0, minlength=n_cells),
                torch.bincount(i1c, weights=w1, minlength=n_cells))
    lib = time_ms(torch, bincounts, 5)
    lib_dev = library_device_ms(torch, bincounts, 5)
    b, by = bound_ms(12 * n + 4 * n_cells, DEPOSIT_OPS * n)
    return {"name": "deposit_cic", "route": "cuda",
            "device_ms": device_ms(torch, kernel, 10, "deposit_cic"),
            "call_device_ms": library_device_ms(torch, kernel, 10),
            "source": "src/repro_torch/csrc/deposit.cu",
            "replaces": "src/repro/kernels/deposit/kernel.py:48",
            "max_abs_err": paths["cluster"],
            "global_path_max_abs_err": paths["global"],
            "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "library_device_ms": lib_dev,
            "shape": f"N={n}, n_cells={n_cells}"}


def check_bitshuffle(torch, dev, block: int, itemsize: int,
                     leaf_blocks: int = 128) -> list[dict]:
    from repro_torch.core.compression import byte_shuffle
    from repro_torch.kernels.bitshuffle import ops as bops
    from repro_torch.kernels.bitshuffle.ref import (byte_shuffle_ref,
                                                    byte_unshuffle_ref,
                                                    shuffle_blocks_ref)
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    for isz in (2, 4, 8):
        for n_items in (1, 7, 65521, 262144):
            raw = torch.randint(0, 256, (n_items * isz,), generator=g,
                                device=dev, dtype=torch.uint8)
            got = bops.shuffle_block(raw, itemsize=isz)
            host = raw.cpu().numpy()
            oracle = byte_shuffle(host.tobytes(), isz)
            if got.cpu().numpy().tobytes() != oracle:
                raise AssertionError(f"shuffle_block {isz} {n_items}")
            if not torch.equal(got, byte_shuffle_ref(raw, itemsize=isz)):
                raise AssertionError(f"shuffle_block vs plain {isz} {n_items}")
            out, n = bops.shuffle(raw, itemsize=isz)
            padded = torch.nn.functional.pad(raw, (0, out.numel() - n))
            if not torch.equal(out, byte_shuffle_ref(padded, itemsize=isz)):
                raise AssertionError(f"shuffle {isz} {n_items}")
            back = bops.unshuffle(out, n, itemsize=isz)
            if not torch.equal(back, raw):
                raise AssertionError(f"unshuffle {isz} {n_items}")
            # the leaf form: blocks of 4096 items (all whole, or a ragged
            # last one) and of 1 MiB (a leaf shorter than one block), and
            # a start that is not 16-byte aligned (the scalar path)
            for blk, data in ((4096 * isz, raw), (block, raw),
                              (4096 * isz, raw[1:])):
                got = bops.shuffle_blocks(data, block=blk, itemsize=isz)
                host = data.cpu().numpy().tobytes()
                oracle = b"".join(byte_shuffle(host[i:i + blk], isz)
                                  for i in range(0, len(host), blk))
                if got.cpu().numpy().tobytes() != oracle or not torch.equal(
                        got, shuffle_blocks_ref(data, block=blk,
                                                itemsize=isz)):
                    raise AssertionError(f"shuffle_blocks {isz} {n_items} "
                                         f"block {blk} len {data.numel()}")
    torch.cuda.synchronize()
    print("bitshuffle: shuffle_block, shuffle, unshuffle, shuffle_blocks "
          "bit-exact for itemsize 2/4/8, n_items 1/7/65521/262144")

    # timing of one 1 MiB codec block of float32 a call, each call on a
    # different block of a 256 MiB buffer (cold in L2)
    n_blocks = 256
    big = torch.randint(0, 256, (n_blocks * block,), generator=g,
                        device=dev, dtype=torch.uint8)
    blocks = big.view(n_blocks, block)
    shuffled = torch.stack([byte_shuffle_ref(b, itemsize=itemsize)
                            for b in blocks])
    b, by = bound_ms(2 * block, 0)
    common = {"route": "cuda", "source": "src/repro_torch/csrc/bitshuffle.cu",
              "max_abs_err": 0.0, "bound_ms": b, "bound_by": by,
              "shape": f"{block} B, itemsize {itemsize}"}

    def lib(i):
        return blocks[i % n_blocks].view(-1, itemsize).t().contiguous()

    def lib_un(i):
        return shuffled[i % n_blocks].view(itemsize, -1).t().contiguous()

    def dev_ms(fn):
        return device_ms(torch, fn, n_blocks, "shuffle_kernel")

    def timed(fn, plain, yardstick):
        return {"ms": time_ms(torch, fn, n_blocks), "device_ms": dev_ms(fn),
                "call_device_ms": library_device_ms(torch, fn, n_blocks),
                "plain_ms": time_ms(torch, plain, n_blocks),
                "library_ms": time_ms(torch, yardstick, n_blocks),
                "library_device_ms": library_device_ms(torch, yardstick,
                                                       n_blocks)}

    rows = [
        {**common, "name": "byte_shuffle_block",
         "replaces": "src/repro/kernels/bitshuffle/kernel.py:55",
         **timed(lambda i: bops.shuffle_block(blocks[i % n_blocks],
                                              itemsize=itemsize),
                 lambda i: byte_shuffle_ref(blocks[i % n_blocks],
                                            itemsize=itemsize), lib)},
        {**common, "name": "byte_shuffle",
         "replaces": "src/repro/kernels/bitshuffle/kernel.py:36",
         **timed(lambda i: bops.shuffle(blocks[i % n_blocks],
                                        itemsize=itemsize),
                 lambda i: byte_shuffle_ref(blocks[i % n_blocks],
                                            itemsize=itemsize), lib)},
        {**common, "name": "byte_unshuffle",
         "replaces": "src/repro/kernels/bitshuffle/kernel.py:74",
         **timed(lambda i: bops.unshuffle(shuffled[i % n_blocks], block,
                                          itemsize=itemsize),
                 lambda i: byte_unshuffle_ref(shuffled[i % n_blocks],
                                              itemsize=itemsize), lib_un)},
    ]
    del big, blocks, shuffled

    # the write path's shape now: one launch for a whole leaf of
    # `leaf_blocks` codec blocks (128 MiB, a paper-width species' x leaf)
    leaf = torch.randint(0, 256, (leaf_blocks * block,), generator=g,
                         device=dev, dtype=torch.uint8)
    got = bops.shuffle_blocks(leaf, block=block, itemsize=itemsize)
    if not torch.equal(got, shuffle_blocks_ref(leaf, block=block,
                                               itemsize=itemsize)):
        raise AssertionError("shuffle_blocks vs plain on the leaf")
    del got

    def blocks_kernel(i):
        return bops.shuffle_blocks(leaf, block=block, itemsize=itemsize)

    def leaf_lib(i):
        return leaf.view(leaf_blocks, -1, itemsize).transpose(1, 2) \
            .contiguous()

    b, by = bound_ms(2 * leaf.numel(), 0)
    rows.append({
        **common, "name": "byte_shuffle_blocks",
        "replaces": "src/repro/kernels/bitshuffle/kernel.py:55",
        "bound_ms": b, "bound_by": by,
        "shape": f"{leaf_blocks} x {block} B leaf, itemsize {itemsize}",
        "ms": time_ms(torch, blocks_kernel, 20),
        "device_ms": device_ms(torch, blocks_kernel, 20, "shuffle_kernel"),
        "call_device_ms": library_device_ms(torch, blocks_kernel, 20),
        "plain_ms": time_ms(torch, lambda i: shuffle_blocks_ref(
            leaf, block=block, itemsize=itemsize), 20),
        "library_ms": time_ms(torch, leaf_lib, 20),
        "library_device_ms": library_device_ms(torch, leaf_lib, 20)})
    return rows


def run_main_path(torch, dev, workdir: pathlib.Path, cfg=None) -> dict:
    """`cfg` (default: paper_config, full width) through compute,
    diagnostics, openPMD writes, a dump, a device-compressed checkpoint,
    restore and restart. Returns the phase timings and the counts the
    checks used."""
    import numpy as np
    from repro_torch.ckpt.checkpoint import (flatten_state,
                                             restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.bit1 import paper_config
    from repro_torch.core import BpReader, EngineConfig, Series
    from repro_torch.core.darshan import CTR, MONITOR
    from repro_torch.pic import simulation as sim

    cfg = cfg or paper_config()
    C = cfg.capacity
    n_io_ranks = 16
    t = {}
    steps = 0
    diag_calls = 0

    def diagnostics(state):
        nonlocal diag_calls
        diag_calls += 1
        return sim.diagnostics(state, cfg)

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[name] = t.get(name, 0.0) + time.perf_counter() - t0
        return out

    MONITOR.reset()
    state = timed("init_s", lambda: sim.init_sim(cfg, 0, device=dev))
    d0 = timed("diagnostics_s", lambda: diagnostics(state))
    series_path = workdir / "diag.bp4"
    io0 = _darshan_totals(MONITOR)
    series = Series(series_path, "w", n_ranks=n_io_ranks,
                    engine_config=EngineConfig(aggregators=4, codec="blosc",
                                               workers=4))
    written = {}
    for chunk in range(2):
        state = timed("compute_s", lambda: sim.pic_run_chunk(state, cfg, 10))
        steps += 10
        diag = timed("diagnostics_s", lambda: diagnostics(state))
        written[int(state.step)] = diag

        def write():
            sim.write_diagnostics_openpmd(series, state, cfg,
                                          n_io_ranks=n_io_ranks, diag=diag)
            if chunk == 0:    # the last chunk's step flushes with the dump
                series.flush()
        timed("diag_write_s", write)

    def dump():
        sim.write_particle_dump_openpmd(series, state, cfg,
                                        n_io_ranks=n_io_ranks)
        series.flush()
        series.close()
    timed("dump_s", dump)
    dump_step = int(state.step)
    dump_x = state.electrons.x.cpu().numpy()
    # the paper's Original-I/O baseline on the same diagnostics and dump,
    # beside the openPMD series that holds them
    series_files = [f for f in series_path.iterdir() if f.is_file()]
    openpmd = {"s": t["diag_write_s"] + t["dump_s"],
               "files": len(series_files),
               "bytes": sum(f.stat().st_size for f in series_files),
               "darshan": _darshan_delta(io0, _darshan_totals(MONITOR))}
    original_io = run_original_io(torch, workdir, cfg, state, written,
                                  n_io_ranks, openpmd)

    ckpt_dir = workdir / "ckpt"
    saved = state._asdict()
    # the leaves the checkpoint shuffles on the device, one launch each:
    # tensors of rank >= 1, not bfloat16 (`save_checkpoint`), with items
    # of more than one byte and at least one block (`compression`); at
    # paper_config 13: x, v, w, alive of the 3 species and the RNG key
    shuffled_leaves = sum(
        1 for a in flatten_state(saved).values()
        if isinstance(a, torch.Tensor) and a.ndim > 0
        and a.dtype != torch.bfloat16 and a.element_size() > 1
        and a.numel() > 0)
    before = MONITOR.report()["total"].get(CTR.COMPRESS_DEVICE_BYTES, 0.0)
    timed("checkpoint_s", lambda: save_checkpoint(
        ckpt_dir, saved, int(state.step), n_io_ranks=n_io_ranks,
        engine_config=EngineConfig(aggregators=4, codec="blosc", workers=4),
        device_compress=True))
    dev_bytes = (MONITOR.report()["total"].get(CTR.COMPRESS_DEVICE_BYTES, 0.0)
                 - before)
    back, at = timed("restore_s", lambda: restore_checkpoint(ckpt_dir, saved))
    flat_saved, flat_back = flatten_state(saved), flatten_state(back)
    if list(flat_saved) != list(flat_back):
        raise AssertionError("restored leaves differ in name")
    for name, a in flat_saved.items():
        b = flat_back[name]
        same = (torch.equal(a, b) and a.dtype == b.dtype
                and a.device == b.device
                if isinstance(a, torch.Tensor) else a == b)
        if not same:
            raise AssertionError(f"restored leaf {name} differs")
    # the parallel write plane on the same state: the dump through 4
    # writer processes, then a manager checkpoint behind the next chunk
    par = run_parallel_io(torch, workdir, cfg, state, written, series_path,
                          back, n_io_ranks, timed)
    steps += par["steps"]
    restored = sim.PicState(**back)
    restored = timed("restart_compute_s",
                     lambda: sim.pic_run_chunk(restored, cfg, 10))
    steps += 10
    d1 = timed("diagnostics_s", lambda: diagnostics(restored))

    # the series reads back equal to what was stored
    with BpReader(series_path) as reader:
        for step, diag in written.items():
            for name, arr in diag.items():
                if isinstance(arr, np.ndarray):
                    var = f"/data/{step}/meshes/{name.replace('/', '_')}"
                    if not (reader.read_var(step, var) == arr).all():
                        raise AssertionError(f"{var} reads back different")
        x_back = reader.read_var(dump_step,
                                 f"/data/{dump_step}/particles/e/position/x")
        if not (x_back == dump_x).all():
            raise AssertionError("dumped electron positions differ")

    # physics invariants (tests/test_pic.py): each event turns a neutral
    # into an ion and adds an electron/ion pair
    for a, b in ((d0["count/D"] + d0["count/D_plus"],
                  d1["count/D"] + d1["count/D_plus"]),
                 (d0["count/e"] - d0["count/D_plus"],
                  d1["count/e"] - d1["count/D_plus"])):
        if abs(a - b) >= 1e-3:
            raise AssertionError(f"particle invariant broken: {a} -> {b}")
    if not d1["ionizations"] > 0:
        raise AssertionError("no ionization events in the run")
    for name, v in d1.items():
        ok = (bool(((v == v) & (abs(v) < 1e30)).all())
              if isinstance(v, np.ndarray) else v == v)
        if not ok:
            raise AssertionError(f"diagnostic {name} is not finite")

    expect_bytes = 72 * C + 8
    if dev_bytes != expect_bytes:
        raise AssertionError(f"COMPRESS_DEVICE_BYTES {dev_bytes} != "
                             f"{expect_bytes}")
    return {"timings_s": t, "steps": steps, "timed_steps": steps -
            par["steps"], "diag_calls": diag_calls, "parallel_io": par,
            "device_bytes": dev_bytes, "restored_from": at,
            "original_io": original_io, "state": restored,
            "shuffled_leaves": shuffled_leaves,
            "counts_start": {k: d0[k] for k in d0 if k.startswith("count/")},
            "counts_end": {k: d1[k] for k in d1 if k.startswith("count/")},
            "ionizations": d1["ionizations"]}


def _subfile_bytes(path: pathlib.Path) -> dict:
    return {f.name: f.stat().st_size for f in sorted(path.glob("data.*"))}


def _transport_bytes(MONITOR, CTR) -> tuple[float, float]:
    tot = MONITOR.report()["total"]
    return (tot.get(CTR.TRANSPORT_SHM_BYTES, 0.0),
            tot.get(CTR.TRANSPORT_PICKLE_FALLBACK_BYTES, 0.0))


def _engine_step(prof: dict) -> dict:
    """The parallel engine's account of one committed step: seconds to
    the workers' prepared votes and to the commit, host compression
    seconds summed over the workers, each worker's seconds, bytes."""
    keys = ("write_s", "prepare_s", "commit_s", "compress_s", "worker_s",
            "bytes_raw", "bytes_stored", "transport_shm_bytes",
            "transport_pickle_bytes")
    return {k: prof[k] for k in keys if k in prof}


def _metric_sums(METRICS) -> dict:
    """The metrics plane's seconds, counts and bytes by operation, summed
    over keys: the coordinator's (`device_shuffle`, `transport`,
    `prepare`, `commit`) and those the workers shipped home (`compress`,
    `seal`)."""
    out = {}
    for k, cell in METRICS.merged().items():
        op = k.partition("|")[0]
        d = out.setdefault(op, {"count": 0, "sum_s": 0.0, "sum_b": 0})
        d["count"] += cell["count"]
        d["sum_s"] += cell["sum_s"]
        d["sum_b"] += cell["sum_b"]
    return out


def run_parallel_io(torch, workdir: pathlib.Path, cfg, state, written: dict,
                    series_path: pathlib.Path, serial_back: dict,
                    n_io_ranks: int, timed) -> dict:
    """The multi-process write plane on the main path's state, after the
    serial dump and checkpoint:
    - the diagnostics and the particle dump again, the same puts in the
      same order, through `open_diagnostic_series(parallel_io=4)` with the
      serial series' engine config; its data.* and md.0 must equal the
      serial series' byte for byte, and every variable must read back as
      stored;
    - a `WriterPlane(4)` spawned on its own (the manager's lazy plane),
      then a device-compressed `CheckpointManager(parallel_io=4,
      async_write=True)` save behind the next 10-step chunk, `wait()`,
      and `restore_latest`, which must equal the serial restore bit for
      bit; its device-shuffled bytes must be 72 C + 8, and its shuffle
      launches are returned for the caller's check.
    The shm transport needs 4 rings of 64 MiB in /dev/shm; where there is
    less room the phase runs with `transport="pickle"` and says so."""
    import types
    import numpy as np
    from repro_torch.ckpt.checkpoint import flatten_state
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import BpReader, EngineConfig, Series
    from repro_torch.core.darshan import CTR, MONITOR
    from repro_torch.core.metrics import METRICS
    from repro_torch.core.shm_transport import DEFAULT_RING_BYTES
    from repro_torch.kernels.bitshuffle import ops as bops
    from repro_torch.pic import simulation as sim

    W = 4
    try:
        shm_free = shutil.disk_usage("/dev/shm").free
    except OSError:
        shm_free = 0
    # one plane's rings at a time (the dump's writers close before the
    # manager's spawn), with as much again to spare
    transport = "shm" if shm_free >= 2 * W * DEFAULT_RING_BYTES else "pickle"
    print(f"parallel I/O: /dev/shm free {shm_free} bytes; {W} writers, "
          f"transport {transport}"
          + ("" if transport == "shm" else
             f" (the shm rings need {W} x {DEFAULT_RING_BYTES} bytes)"))
    out = {"dev_shm_free_bytes": shm_free, "transport": transport,
           "writers": W, "t": {}}
    engine = EngineConfig(aggregators=4, codec="blosc", workers=4)
    dump_step = int(state.step)

    # ---- the dump through W writer processes
    shm0 = _transport_bytes(MONITOR, CTR)
    ppath = workdir / "diag_par.bp4"

    def pdump():
        if transport == "shm":
            series = sim.open_diagnostic_series(
                ppath, n_io_ranks=n_io_ranks, engine_config=engine,
                async_io=False, parallel_io=W)
        else:
            series = Series(ppath, "w", n_ranks=n_io_ranks,
                            engine_config=engine, parallel_io=W,
                            transport=transport)
        for step, diag in written.items():
            sim.write_diagnostics_openpmd(
                series, types.SimpleNamespace(step=step), cfg,
                n_io_ranks=n_io_ranks, diag=diag)
            if step != dump_step:
                series.flush()
        sim.write_particle_dump_openpmd(series, state, cfg,
                                        n_io_ranks=n_io_ranks)
        out["dump_step_profile"] = _engine_step(series.flush())
        series.close()
    # the metrics plane's breakdown of each parallel write (the workers
    # ship their cells home on their acks)
    METRICS.reset()
    METRICS.enable()
    try:
        timed("parallel_dump_s", pdump)
    finally:
        METRICS.disable()
    out["dump_metrics"] = _metric_sums(METRICS)
    shm1 = _transport_bytes(MONITOR, CTR)
    out["dump_transport_bytes"] = {"shm": shm1[0] - shm0[0],
                                   "pickle": shm1[1] - shm0[1]}
    out["dump_subfile_bytes"] = _subfile_bytes(ppath)
    names = ["md.0"] + sorted(f.name for f in series_path.glob("data.*"))
    for name in names:
        if (ppath / name).read_bytes() != (series_path / name).read_bytes():
            raise AssertionError(f"parallel dump: {name} differs from the "
                                 f"serial series'")
    dumped = {}
    for name, sp in (("e", state.electrons), ("D_plus", state.ions),
                     ("D", state.neutrals)):
        base = f"/data/{dump_step}/particles/{name}"
        dumped.update({f"{base}/position/x": sp.x,
                       f"{base}/momentum/x": sp.v[:, 0],
                       f"{base}/momentum/y": sp.v[:, 1],
                       f"{base}/momentum/z": sp.v[:, 2],
                       f"{base}/weighting": sp.w * sp.alive})
    n_vars = 0
    with BpReader(ppath, parallel=W) as reader:
        for step, diag in written.items():
            for name, arr in diag.items():
                if isinstance(arr, np.ndarray):
                    var = f"/data/{step}/meshes/{name.replace('/', '_')}"
                    if not (reader.read_var(step, var) == arr).all():
                        raise AssertionError(f"parallel {var} reads back "
                                             f"different")
                    n_vars += 1
        for var, t in dumped.items():
            got = torch.from_numpy(reader.read_var(dump_step, var))
            if not torch.equal(got, t.detach().cpu()):
                raise AssertionError(f"parallel {var} reads back different")
            n_vars += 1
    out["dump_vars_read_back"] = n_vars
    out["dump_identical_files"] = names

    # ---- the manager: a persistent plane, a device-compressed checkpoint
    # behind the next chunk
    ckpt_dir = workdir / "ckpt_par"
    mgr = CheckpointManager(ckpt_dir, every=10, n_io_ranks=n_io_ranks,
                            engine_config=engine, async_write=True,
                            parallel_io=W, transport=transport,
                            device_compress=True)
    try:
        t0 = time.perf_counter()
        mgr._writer_plane()          # the lazy spawn, on its own
        out["t"]["plane_spawn_s"] = time.perf_counter() - t0
        dev0 = MONITOR.report()["total"].get(CTR.COMPRESS_DEVICE_BYTES, 0.0)
        shuf0 = bops.shuffle_blocks.launches
        shm0 = _transport_bytes(MONITOR, CTR)
        saved = state._asdict()
        torch.cuda.synchronize()
        METRICS.reset()
        METRICS.enable()
        try:
            t0 = time.perf_counter()
            mgr.save(saved, dump_step, force=True)
            out["t"]["save_return_s"] = time.perf_counter() - t0
            timed("overlap_compute_s",
                  lambda: sim.pic_run_chunk(state, cfg, 10))
            out["t"]["save_to_chunk_end_s"] = time.perf_counter() - t0
            mgr.wait()
            out["t"]["save_to_durable_s"] = time.perf_counter() - t0
        finally:
            METRICS.disable()
        out["ckpt_metrics"] = _metric_sums(METRICS)
        METRICS.reset()
        shm1 = _transport_bytes(MONITOR, CTR)
        out["device_bytes"] = (MONITOR.report()["total"].get(
            CTR.COMPRESS_DEVICE_BYTES, 0.0) - dev0)
        out["shuffle_launches"] = bops.shuffle_blocks.launches - shuf0
        out["ckpt_transport_bytes"] = {"shm": shm1[0] - shm0[0],
                                       "pickle": shm1[1] - shm0[1]}
        out["manager"] = {**mgr.stats,
                          "overlap_fraction": mgr.overlap_fraction()}
        (ck,) = ckpt_dir.glob("step_*.bp4")
        out["ckpt_subfile_bytes"] = _subfile_bytes(ck)
        out["ckpt_step_profile"] = _engine_step(json.loads(
            (ck / "profiling.json").read_text())["steps"][-1])
        t0 = time.perf_counter()
        back, at = mgr.restore_latest(saved)
        out["t"]["restore_s"] = time.perf_counter() - t0
    finally:
        mgr.close()
    if at != dump_step:
        raise AssertionError(f"restore_latest gave step {at}")
    if out["device_bytes"] != 72 * cfg.capacity + 8:
        raise AssertionError(f"parallel checkpoint: COMPRESS_DEVICE_BYTES "
                             f"{out['device_bytes']} != "
                             f"{72 * cfg.capacity + 8}")
    a, b = flatten_state(serial_back), flatten_state(back)
    if list(a) != list(b):
        raise AssertionError("parallel restore: leaves differ in name")
    for name, x in a.items():
        y = b[name]
        same = (torch.equal(x, y) and x.dtype == y.dtype
                and x.device == y.device
                if isinstance(x, torch.Tensor) else x == y)
        if not same:
            raise AssertionError(f"parallel restore: leaf {name} differs")
    out["steps"] = 10
    print(f"parallel I/O: {json.dumps(out)}")
    return out


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def flash_limit(top: float) -> float:
    """The flash kernel's limit against its plain version for outputs of
    largest magnitude `top`: two bf16 ulps of `top` (both round an fp32
    result that differs only in the order of its sums; one ulp is what was
    measured), and never more than the earlier 3e-2, set for values up to
    ~4, grown as a bf16 ulp does above that."""
    ulp = 2.0 ** (math.floor(math.log2(max(top, 2.0 ** -126))) - 7)
    return min(3e-2 * max(1.0, top / 4), 2 * ulp)


#: the flash kernel's shapes on the serving paths (B, Sq, Skv, H, D, causal;
#: H is the query heads: the wrapper's callers expand GQA's kv heads)
FLASH_SERVE_SHAPES = {
    "zamba2-2.7b": (4, 512, 512, 32, 80, True),
    "deepseek-moe-16b": (4, 512, 512, 16, 128, True),
    "llama-3.2-vision-90b self": (4, 512, 512, 64, 128, True),
    "llama-3.2-vision-90b cross": (4, 512, 1600, 64, 128, False),
    "phi3-mini-3.8b": (2, 128, 128, 32, 96, True),
}


def flash_bound(B, Sq, Skv, H, D, causal) -> tuple[float, str]:
    """q, k, v read once and the output written once (bf16); 4·D
    operations a (query, key) pair the mask keeps, on bf16 tensor cores."""
    if causal and Sq != Skv:
        raise ValueError("causal bound for Sq == Skv only")
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
    return bound_ms(2 * B * H * D * (2 * Sq + 2 * Skv),
                    4 * D * pairs * B * H, BF16_OPS_PER_S)


def check_flash_attention(torch, dev) -> tuple[dict, list[dict]]:
    """The kernel against its plain version at the serving shapes
    (`FLASH_SERVE_SHAPES`), and at D 64/128, non-causal and ragged S;
    times at each serving shape, beside SDPA's. Returns the kernels-line
    row (zamba2's shape) and the rows of every serving shape."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    g = torch.Generator(device=dev)
    g.manual_seed(80)

    def qkv(B, Sq, Skv, H, D):
        return [torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
                for S in (Sq, Skv, Skv)]

    errs = {}
    cases = [(2, 512, 512, 8, 64, True), (2, 512, 512, 8, 128, True),
             (2, 512, 512, 8, 80, False), (2, 320, 320, 8, 80, True),
             (2, 320, 320, 8, 128, False), *FLASH_SERVE_SHAPES.values()]
    for B, Sq, Skv, H, D, causal in cases:
        q, k, v = qkv(B, Sq, Skv, H, D)
        got = fops.flash_attention(q, k, v, causal=causal)
        ref = flash_attention_plain(q, k, v, causal=causal, q_chunk=256,
                                    kv_chunk=256)
        torch.cuda.synchronize()
        err, top = _max_err(got, ref), float(ref.float().abs().max())
        errs[(B, Sq, Skv, H, D, causal)] = err
        if not err <= flash_limit(top):
            raise AssertionError(f"flash B={B} Sq={Sq} Skv={Skv} H={H} D={D}"
                                 f" causal={causal}: max_abs_err {err} "
                                 f"(max |ref| {top}, limit "
                                 f"{flash_limit(top)})")
        print(f"flash_attention vs plain {(B, Sq, Skv, H, D, causal)}: "
              f"max_abs_err {err:.4g}, max |ref| {top:.4g}, limit "
              f"{flash_limit(top):.4g}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, (B, Sq, Skv, H, D, causal) in FLASH_SERVE_SHAPES.items():
        q, k, v = qkv(B, Sq, Skv, H, D)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B,H,S,D]

        def kernel(i):
            return fops.flash_attention(q, k, v, causal=causal)

        def yardstick(i):
            return sdpa(qt, kt, vt, is_causal=causal)
        b, by = flash_bound(B, Sq, Skv, H, D, causal)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
            "path": name,
            "max_abs_err": errs[(B, Sq, Skv, H, D, causal)],
            "ms": time_ms(torch, kernel, 50),
            "device_ms": device_ms(torch, kernel, 20, "flash_fwd_mma"),
            "call_device_ms": library_device_ms(torch, kernel, 20),
            "plain_ms": time_ms(torch, lambda i: flash_attention_plain(
                q, k, v, causal=causal, q_chunk=256, kv_chunk=256), 5),
            "library_ms": time_ms(torch, yardstick, 50),
            "library_device_ms": library_device_ms(torch, yardstick, 20),
            "bound_ms": b, "bound_by": by,
            "shape": f"B={B} Sq={Sq} Skv={Skv} H={H} D={D} bf16 "
                     f"{'causal' if causal else 'non-causal'}"})
    return rows[0], rows


def ssd_inputs(torch, dev, b, s, h, p, n, seed):
    """Inputs shaped and typed as zamba2's prefill gives them to the scan:
    x, B, C bf16, dt = softplus(.) fp32, A = -exp(linspace(log 1, log 16))
    (cs reaches about -200 within a chunk), D = 1."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device=dev).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=dev) - 1.0)
    A = -torch.exp(torch.linspace(0.0, 2.772588722, h, device=dev))
    B = (torch.randn((b, s, n), generator=g, device=dev) * 0.3).bfloat16()
    C = (torch.randn((b, s, n), generator=g, device=dev) * 0.3).bfloat16()
    return x, dt, A, B, C, torch.ones((h,), device=dev)


def check_ssd_scan(torch, dev) -> dict:
    """The kernel against the plain `ssd_chunked` (y and final state) at
    zamba2-2.7b's prefill shape (b=4, s=512, h=80, p=64, n=64, chunk 128),
    at n=128 and at a padded s, and against `ssd_chunked_split` (the plain
    version with the kernel's bf16 hi/lo operands) at the prefill shape;
    times at the prefill shape."""
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import (ssd_chunked,
                                                  ssd_chunked_split)
    errs = {}
    for b, s, h, p, n in ((4, 512, 80, 64, 64), (2, 512, 16, 64, 128),
                          (2, 200, 16, 64, 64)):
        args = ssd_inputs(torch, dev, b, s, h, p, n, s + n)
        y, final = sops.ssd_scan(*args, chunk=128)
        refs = {"plain": plain_scan(*args, chunk=128)}
        if s % 128 == 0 and n == 64:
            refs["split"] = ssd_chunked_split(*args, chunk=128)
        torch.cuda.synchronize()
        for which, (yr, fr) in refs.items():
            ey = _max_err(y, yr)
            ef = _max_err(final, fr) / max(1.0, float(fr.abs().max()))
            errs[(b, s, h, p, n, which)] = (ey, ef)
            # y: bf16 of fp32 sums in another order; state: fp32, relative
            if not (ey < 5e-2 and ef < 1e-4):
                raise AssertionError(f"ssd b={b} s={s} h={h} p={p} n={n} vs "
                                     f"{which}: y err {ey}, state rel err "
                                     f"{ef}")
    print("ssd_scan vs plain and vs split (y tol 5e-2, state rel tol 1e-4): "
          + ", ".join(f"{k}: y {v[0]:.4g} state {v[1]:.3g}"
                      for k, v in errs.items()))

    b, s, h, p, n, Q = 4, 512, 80, 64, 64, 128
    args = ssd_inputs(torch, dev, b, s, h, p, n, 1)
    nc = s // Q
    tri = Q * (Q + 1) // 2
    # C.B once per (batch, chunk), shared by the heads; per head the
    # decay-masked product and the two state terms
    head_ops = b * h * nc * (tri * p * 2 + 2 * Q * n * p * 2)
    cb_ops = b * nc * tri * n * 2
    nbytes = 2 * (2 * b * s * h * p) + 4 * b * s * h + 2 * 4 * h \
        + 2 * (2 * b * s * n) + 4 * b * h * p * n
    # the kernel runs every product on bf16 tensor cores, the three with an
    # fp32 operand twice (hi and lo); `fp32_ops_bound_ms` counts the
    # function's operations once, at the fp32 FMA rate
    bb, by = bound_ms(nbytes, cb_ops + 2 * head_ops, BF16_OPS_PER_S)
    fp32_bound, _ = bound_ms(nbytes, cb_ops + head_ops)

    def kernel(i):
        return sops.ssd_scan(*args)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
            "max_abs_err": errs[(b, s, h, p, n, "plain")][0],
            "ms": time_ms(torch, kernel, 20),
            "device_ms": device_ms(torch, kernel, 10, "ssd_"),
            "call_device_ms": library_device_ms(torch, kernel, 10),
            "plain_ms": time_ms(torch, lambda i: ssd_chunked(*args), 5),
            "library_ms": None, "library_device_ms": None,
            "bound_ms": bb, "bound_by": by,
            "fp32_ops_bound_ms": fp32_bound,
            "shape": f"b={b} s={s} h={h} p={p} n={n} chunk {Q}"}


def plain_flash(q, k, v, *, causal=True, qc=512, kc=512):
    """The flash wrapper's contract through its plain version."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal, q_chunk=qc,
                                 kv_chunk=kc)


def plain_scan(x, dt, A, B, C, D, *, chunk=128, initial_state=None):
    """The SSD wrapper's contract (s padded with zeros to whole chunks)
    through the plain `ssd_chunked`."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    s = x.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    y, final = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                           F.pad(dt, (0, 0, 0, pad)), A,
                           F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
                           D, chunk=chunk, initial_state=initial_state)
    return y[:, :s], final


@contextlib.contextmanager
def routed(flash, scan):
    """Send the model's calls of the flash and SSD wrappers to `flash` and
    `scan` (same signatures) for the duration. Only the model modules'
    references to the two ops modules are swapped: the wrappers, their
    kernels and their launch counts stay as they are."""
    from repro_torch.models import attention, ssm
    saved = attention.flash_ops, ssm.ssd_ops
    attention.flash_ops = types.SimpleNamespace(flash_attention=flash)
    ssm.ssd_ops = types.SimpleNamespace(ssd_scan=scan)
    try:
        yield
    finally:
        attention.flash_ops, ssm.ssd_ops = saved


class FirstAndLast:
    """Calls `fn` and keeps the arguments and result of its first and its
    last call."""

    def __init__(self, fn):
        self.fn, self.calls = fn, {}

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.setdefault("first", (args, kw, out))
        self.calls["last"] = (args, kw, out)
        return out


def check_on_activations(torch, flash_calls, scan_calls) -> dict:
    """What each kernel gave the prefill against its plain version on the
    same inputs, the activations of the model: the first and the last call
    of each. The limits are those of the kernel checks: flash
    `flash_limit` of the reference's largest value; SSD y 5e-2, set for
    values up to ~4 and grown above that as a bf16 ulp does, and the SSD
    state relative 1e-4."""
    out = {}
    for which, (args, kw, got) in flash_calls.items():
        ref = plain_flash(*args, **kw)
        top = float(ref.float().abs().max())
        err = _max_err(got, ref)
        out[f"flash_attention/{which}"] = {"max_abs_err": err,
                                           "max_abs": top,
                                           "limit": flash_limit(top)}
        if not err <= flash_limit(top):
            raise AssertionError(f"flash on the prefill's {which} call: "
                                 f"max_abs_err {err} (max |out| {top})")
    for which, (args, kw, (y, final)) in scan_calls.items():
        yr, fr = plain_scan(*args, **kw)
        top = float(yr.float().abs().max())
        ey = _max_err(y, yr)
        ef = _max_err(final, fr) / max(1.0, float(fr.abs().max()))
        out[f"ssd_scan/{which}"] = {"y_max_abs_err": ey, "max_abs_y": top,
                                    "state_rel_err": ef}
        if not (ey < 5e-2 * max(1.0, top / 4) and ef < 1e-4):
            raise AssertionError(f"ssd on the prefill's {which} call: y err "
                                 f"{ey} (max |y| {top}), state rel err {ef}")
    torch.cuda.synchronize()
    return out


def serve_launches(cfg) -> dict:
    """The kernels' launches a prefill of `cfg`: hybrid, flash in the
    shared block after every `shared_attn_interval` Mamba2 layers and SSD
    in every Mamba2 layer; ssm, SSD in every layer; dense, audio, moe and
    vlm, flash in every layer (vlm: self and cross layers)."""
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.shared_attn_interval,
                "ssd_scan": cfg.n_layers}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "ssd_scan": cfg.n_layers}
    return {"flash_attention": cfg.n_layers, "ssd_scan": 0}


#: the serving paths: (arch, batch, prompt, new tokens, max_seq). The
#: three long ones first; then a short serve of every other registered
#: config that fits one card
SERVE_PATHS = (("zamba2-2.7b", 4, 512, 32, 1024),
               ("deepseek-moe-16b", 4, 512, 32, 1024),
               ("llama-3.2-vision-90b", 4, 512, 32, 1024),
               ("phi3-mini-3.8b", 2, 128, 8, 256),
               ("qwen1.5-0.5b", 2, 128, 8, 256),
               ("qwen3-4b", 2, 128, 8, 256),
               ("smollm-360m", 2, 128, 8, 256),
               ("mamba2-2.7b", 2, 128, 8, 256),
               ("musicgen-large", 2, 128, 8, 256))
#: registered configs that do not fit one card, and why
NOT_SERVED = {"arctic-480b": "480B params, 960 GB in bf16, on an 80 GB card"}


def serve_config(arch: str):
    """The config `chip_smoke.py` serves for `arch`, with its cuts:
    deepseek-moe-16b at full width and depth and llama-3.2-vision-90b at
    full width and 10 of its 100 layers, both initialised in bf16 (fp32
    masters beside the engine's bf16 copy need 98 GB for deepseek: bf16
    draws are the same draws rounded once, so the engine holds the same
    values); zamba2-2.7b, phi3-mini-3.8b, qwen1.5-0.5b, qwen3-4b,
    smollm-360m, mamba2-2.7b and musicgen-large as published, nothing
    cut."""
    from repro_torch.configs.base import get_config
    cuts = {"deepseek-moe-16b": dict(param_dtype="bfloat16"),
            "llama-3.2-vision-90b": dict(n_layers=10,
                                         param_dtype="bfloat16")}
    return dataclasses.replace(get_config(arch), **cuts.get(arch, {}))


@contextlib.contextmanager
def recording_routes():
    """Record each MoE FFN call's routing while the block runs it, as two
    [B,S,E] masks: the experts each token chose (its top-k) and those of
    them whose assignment kept a slot under the call's group-local capacity
    (one extra router product a call, off the timed runs)."""
    from repro_torch.models import moe, transformer
    calls, saved = [], transformer.moe_ffn

    def rec(p, x, cfg, **kw):
        _, _, top_e = moe.route(p, x, cfg)
        order, _, valid = moe.dispatch(top_e, cfg.n_experts,
                                       moe._capacity(x.shape[1], cfg))
        B, S, k = top_e.shape
        kept = valid.new_zeros(valid.shape).scatter_(1, order, valid)
        none = valid.new_zeros((B, S, cfg.n_experts))
        calls.append((none.scatter(2, top_e, True),
                      none.scatter(2, top_e, kept.reshape(B, S, k))))
        return saved(p, x, cfg, **kw)
    transformer.moe_ffn = rec
    try:
        yield calls
    finally:
        transformer.moe_ffn = saved


def routing_agreement(a, b) -> dict:
    """The shares of (token, layer) routing decisions of two forwards that
    agree: the same top-k experts chosen, and the same of them kept."""
    if len(a) != len(b) or not a:
        raise AssertionError("the forwards ran different MoE layers")
    return {name: sum(float((ra[i] == rb[i]).all(-1).float().mean())
                      for ra, rb in zip(a, b)) / len(a)
            for i, name in enumerate(("chosen", "kept"))}


def expert_load(torch, routes, capacity: int) -> dict:
    """The assignments an expert gets in a group (one sequence), over every
    MoE layer and group, against the capacity C of its slots; and the share
    of all assignments dropped."""
    n = torch.cat([chosen.sum(1).flatten() for chosen, _ in routes]).float()
    total = sum(float(chosen.sum()) for chosen, _ in routes)
    kept = sum(float(k.sum()) for _, k in routes)
    return {"mean": float(n.mean()), "median": float(n.median()),
            "p90": float(n.quantile(0.9)), "max": float(n.max()),
            "capacity": capacity,
            "over_capacity_share": float((n > capacity).float().mean()),
            "unused_share": float((n == 0).float().mean()),
            "drop_share": 1 - kept / total}


def logit_gaps(full, plain, plain_b, dec=None) -> dict:
    """The forward through the kernels (`full`) against the one through the
    plain versions (`plain`), and the decode logits `dec` against `full`,
    in units of the noise floor: `plain` against `plain_b`, the plain
    versions chunked otherwise. Raises where a gap is over its limit, or a
    token differs where its margin is clear of the gap."""
    if not (bool(full.isfinite().all())
            and (dec is None or bool(dec.isfinite().all()))):
        raise AssertionError("non-finite logits")
    top = float(full.abs().max())
    # the noise floor: the plain versions' own summation order, carried
    # through every layer
    floor = float((plain - plain_b).abs().max())
    # the kernels' rounding, carried through every layer
    kdiff = float((full - plain).abs().max())
    # the limits in units of the floor (or of a hundredth of the largest
    # logit, where a small model rounds alike both ways): the kernels may
    # move the logits half as much again as the plain versions' own order
    # does, decode twice as much, for its bf16 state
    unit = max(floor, 0.01 * top)

    def margin(logits, gap):
        top2 = logits.topk(2, dim=-1).values
        return ((top2[..., 0] - top2[..., 1]) > 2 * gap).cpu().numpy()

    def same(a, b):
        return (a.argmax(-1) == b.argmax(-1)).cpu().numpy()
    kclear, ksame = margin(plain, kdiff), same(full, plain)
    out = {"max_abs_logit": top, "kernels_vs_plain_max_abs_diff": kdiff,
           "noise_floor_max_abs_diff": floor,
           "kernels_clear_share": float(kclear.mean()),
           "kernels_equal_share": float(ksame.mean()),
           "floor_equal_share": float(same(plain, plain_b).mean())}
    if not kdiff <= 1.5 * unit:
        raise AssertionError(f"logits differ: kernels vs plain {kdiff}, "
                             f"noise floor {floor} (max |logit| {top})")
    if not ksame[kclear].all():
        raise AssertionError("a token of the forward through the kernels "
                             "differs from the plain one where the margin "
                             "is clear")
    if dec is not None:
        # decode (recurrent Mamba2 step with a bf16 state, softmax over the
        # cache) and the forward (chunked scan, flash) round at other points
        diff = float((dec - full).abs().max())
        clear, dsame = margin(full, diff), same(full, dec)
        out.update(max_abs_diff=diff, clear_share=float(clear.mean()),
                   equal_share=float(dsame.mean()))
        if not diff <= 2 * unit:
            raise AssertionError(f"logits differ: decode vs forward {diff},"
                                 f" noise floor {floor} (max |logit| {top})")
        if not dsame[clear].all():
            raise AssertionError("a decoded token differs from the "
                                 "forward's where the margin is clear")
    return out


def run_serve_path(torch, dev, cfg=None, *, batch=4, prompt=512, new=32,
                   max_seq=1024, seed=0) -> dict:
    """`cfg` (default: zamba2-2.7b at full width) served through
    `ServeEngine.generate`: the launch counts of the kernels are zeroed just
    before it and read just after. Then prefill and each decode step are
    timed apart, with the counts read between them; each kernel's outputs
    in that prefill are held against its plain version; and the decode
    logits are held against one teacher-forced forward through the
    kernels, that forward against one through the plain versions, and both
    gaps against the noise floor: two forwards through the plain versions
    that differ only in their chunking. A vlm gets seeded vision
    embeddings and its cross blocks' gates at 1.0 (at their init, 0, a
    cross block is a no-op). An moe config's forwards through the kernels
    and the plain versions run at its own capacity, where the routing
    decisions (experts chosen, and kept under capacity) that agree are
    counted too; its decode check runs on a copy at no-drop capacity
    (capacity dispatch is not causal: a forward over S tokens drops a hot
    expert's latest positions, a one-token decode step never drops), with
    forwards of its own. Returns timings, counts and the checks' numbers."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import _capacity as moe_capacity
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = cfg or get_config("zamba2-2.7b")
    kernels = {"flash_attention": fops.flash_attention,
               "ssd_scan": sops.ssd_scan}
    expect = serve_launches(cfg)

    def counts():
        return {k: f.launches for k, f in kernels.items()}

    def zero():
        for f in kernels.values():
            f.launches = 0

    t0 = time.perf_counter()
    params = M.init_params(cfg, seed, device=dev)
    n_params = sum(t.numel() for t in M.leaves(params))
    if n_params != cfg.n_params():
        raise AssertionError(f"{n_params} params, expected {cfg.n_params()}")
    extra = {}
    if cfg.family == "vlm":
        for block in params["stack"]["cross"]:
            block["attn_gate"].fill_(1.0)
            block["ffn_gate"].fill_(1.0)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1)
        extra["vision_embeds"] = torch.randn(
            (batch, cfg.n_vision_tokens, cfg.d_model), generator=g,
            device=dev).bfloat16()
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=batch,
                                               max_seq=max_seq,
                                               max_new_tokens=new))
    del params                    # the engine keeps what it reads
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    vision = extra.get("vision_embeds")
    # cuBLAS handles and workspaces
    eng.generate(prompts, new_tokens=2, vision_embeds=vision)

    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = eng.generate(prompts, new_tokens=new, vision_embeds=vision)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = counts()
    if launches != expect:
        raise AssertionError(f"serve launches {launches} != {expect}")
    if gen.shape != (batch, new) or not ((gen >= 0) &
                                         (gen < cfg.padded_vocab)).all():
        raise AssertionError(f"generated tokens out of range: {gen.shape}")

    def decode_steps(dcfg, logits, cache):
        """The prefill's last logits, then those of each decode step at
        `dcfg` that feeds the generated tokens one at a time into `cache`
        (grown to max_seq): [B, new, V]."""
        steps = [logits[:, -1]]
        for t in range(new - 1):
            tok = torch.as_tensor(gen[:, t:t + 1], dtype=torch.int64,
                                  device=dev)
            logits, cache = M.decode_step(eng.params, dcfg, tok, cache,
                                          prompt + t)
            steps.append(logits[:, -1])
        return torch.stack(steps, 1)

    # prefill and decode apart, their launches, the kernels on the
    # prefill's activations, and the teacher-forced check
    out = {}
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        flash_rec = FirstAndLast(fops.flash_attention)
        scan_rec = FirstAndLast(sops.ssd_scan)
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routed(flash_rec, scan_rec):
            logits, cache = eng.prefill(eng.params, {"tokens": tokens,
                                                     **extra})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = counts()
        activations = check_on_activations(torch, flash_rec.calls,
                                           scan_rec.calls)
        del flash_rec, scan_rec
        cache = eng._grow_cache(cache)
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec = decode_steps(cfg, logits, cache)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / max(new - 1, 1)
        decode_launches = counts()
        del cache
        if not torch.equal(dec.argmax(-1).cpu(), torch.as_tensor(gen).long()):
            raise AssertionError("decode logits do not give the generated "
                                 "tokens")
        seq = torch.as_tensor(np.concatenate([prompts, gen[:, :-1]], 1),
                              dtype=torch.int64, device=dev)

        def forward(fcfg, q_chunk, kv_chunk, ssd_chunk):
            with recording_routes() as routes:
                logits, _ = M.forward(eng.params, fcfg,
                                      {"tokens": seq, **extra},
                                      q_chunk=q_chunk, kv_chunk=kv_chunk,
                                      ssd_chunk=ssd_chunk)
            return logits[:, prompt - 1:].clone(), routes

        def forwards(fcfg):
            """Through the kernels, through the plain versions, and through
            the plain versions chunked otherwise (the chunks only matter to
            them: for flash 3 x 181 or 1 x 543 positions of a prompt of
            512, 3 x 45 or 1 x 135 of a prompt of 128; 128 or 64 for the
            scan)."""
            c = 256 if seq.shape[1] > 256 else 64
            runs = [forward(fcfg, c, c, 128)]
            with routed(plain_flash, plain_scan):
                runs += [forward(fcfg, c, c, 128),
                         forward(fcfg, 1024, 1024, 64)]
            return runs

        if cfg.family == "moe":
            # the served path, at the config's own capacity: its prefill's
            # expert load and drops, and the forwards through the kernels
            # and the plain versions, logits and routing
            with recording_routes() as own:
                eng.prefill(eng.params, {"tokens": tokens})
            out["expert_load"] = load = expert_load(
                torch, own, moe_capacity(prompt, cfg))
            out["prefill_drop_share"] = load["drop_share"]
            del own
            (full, routes), (plain, plain_routes), (plain_b, plain_b_routes) \
                = forwards(cfg)
            out["own_capacity"] = logit_gaps(full, plain, plain_b)
            # a bf16 rounding apart in attention can flip a top-k choice or
            # a capacity drop, and the plain versions' own chunking flips
            # some too: the kernels may flip half as many again as that
            # floor, as for the logits
            out["routing_agreement"] = agree = {
                "kernels_vs_plain": routing_agreement(routes, plain_routes),
                "plain_vs_plain": routing_agreement(plain_routes,
                                                    plain_b_routes)}
            print(f"{cfg.name}: routing agreement {agree}, expert load "
                  f"{load}, logits at its own capacity "
                  f"{out['own_capacity']}")
            for which in ("chosen", "kept"):
                if not (1 - agree["kernels_vs_plain"][which]
                        <= 1.5 * (1 - agree["plain_vs_plain"][which])):
                    raise AssertionError(
                        f"routing ({which}): kernels vs plain agree on "
                        f"{agree['kernels_vs_plain'][which]} of the "
                        f"decisions, two plain forwards on "
                        f"{agree['plain_vs_plain'][which]}")
            del full, plain, plain_b, routes, plain_routes, plain_b_routes
            # decode against the teacher-forced forward at no-drop
            # capacity, its own prefill and forwards untimed
            cfg_nd = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            out["decode_check_capacity_factor"] = cfg_nd.capacity_factor
            logits, cache = M.prefill(eng.params, cfg_nd, {"tokens": tokens},
                                      q_chunk=256, kv_chunk=256)
            dec = decode_steps(cfg_nd, logits, eng._grow_cache(cache))
            del cache
            (full, _), (plain, _), (plain_b, _) = forwards(cfg_nd)
        else:
            (full, _), (plain, _), (plain_b, _) = forwards(cfg)
        teacher_forcing = logit_gaps(full, plain, plain_b, dec)
        del full, plain, plain_b, dec
    if prefill_launches != expect or any(decode_launches.values()):
        raise AssertionError(f"launches: prefill {prefill_launches}, "
                             f"decode {decode_launches}")
    profile = profile_serve(torch, eng, cfg, tokens, gen, extra)
    return {"arch": cfg.name, "n_params": n_params,
            "param_dtype": cfg.param_dtype, "n_layers": cfg.n_layers,
            "init_s": init_s,
            "generate_s": generate_s, "prefill_s": prefill_s,
            "prompt_tokens_per_s": batch * prompt / prefill_s,
            "decode_ms_per_step": decode_ms, "launches": launches,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches,
            "kernels_on_activations": activations,
            "teacher_forcing": teacher_forcing,
            **out,
            "profile": profile,
            "shape": f"batch {batch}, prompt {prompt}, {new} new tokens, "
                     f"max_seq {max_seq}"}


def profile_serve(torch, eng, cfg, tokens, gen, extra, n_decode: int = 4
                  ) -> dict:
    """Where the serving path's device time goes: device time by kernel
    (device activity only) over one prefill, and over `n_decode` decode
    steps, each against its profiled wall time. `extra`: the prefill
    batch's other inputs (a vlm's vision embeddings)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    Sp = tokens.shape[1]
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, cache = eng.prefill(eng.params, {"tokens": tokens, **extra})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["prefill"] = _profile_rows(prof, wall, 1)
        cache = eng._grow_cache(cache)
        toks = [torch.as_tensor(gen[:, t:t + 1], dtype=torch.int64,
                                device=tokens.device) for t in range(n_decode)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(n_decode):
                M.decode_step(eng.params, cfg, toks[t], cache, Sp + t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["decode_step"] = _profile_rows(prof, wall, n_decode)
    return out


# ============================================================= host I/O planes
_DARSHAN_KEYS = ("POSIX_OPENS", "POSIX_WRITES", "POSIX_BYTES_WRITTEN",
                 "F_WRITE_TIME", "F_META_TIME")


def _darshan_totals(MONITOR) -> dict:
    tot = MONITOR.report()["total"]
    return {k: tot.get(k, 0.0) for k in _DARSHAN_KEYS}


def _darshan_delta(a: dict, b: dict) -> dict:
    d = {k: b[k] - a[k] for k in _DARSHAN_KEYS}
    busy = d["F_WRITE_TIME"] + d["F_META_TIME"]
    d["meta_time_share"] = d["F_META_TIME"] / busy if busy else None
    return d


def _species_arrays(sp) -> dict:
    """A species' dump records as host arrays, as the openPMD dump writes
    them (`write_particle_dump_openpmd`)."""
    return {"position/x": sp.x.cpu().numpy(),
            "momentum/x": sp.v[:, 0].cpu().numpy(),
            "momentum/y": sp.v[:, 1].cpu().numpy(),
            "momentum/z": sp.v[:, 2].cpu().numpy(),
            "weighting": (sp.w * sp.alive).cpu().numpy()}


def run_original_io(torch, workdir: pathlib.Path, cfg, state, written: dict,
                    n_io_ranks: int, openpmd: dict) -> dict:
    """The paper's Original-I/O baseline (`core/original_io.py`, §IV and
    Table II) on the main path's data: each mvstep diagnostic of `written`
    as one text .dat file a rank and the dmpstep particle dump of `state`
    as one binary .dmp file a rank, both split over `n_io_ranks` ranks as
    the openPMD series splits them. Every .dmp reads back bit for bit.
    Returns seconds, files, bytes and Darshan counters beside `openpmd`'s
    (the same data through the openPMD/BP4 series)."""
    import numpy as np
    from repro_torch.core.darshan import MONITOR
    from repro_torch.core.original_io import read_dmp, write_dat, write_dmp

    out_dir = workdir / "original_io"
    step = int(state.step)
    d0 = _darshan_totals(MONITOR)
    t0 = time.perf_counter()
    for dstep, diag in written.items():
        for r in range(n_io_ranks):
            part = {}
            for name, arr in diag.items():
                if isinstance(arr, np.ndarray):
                    per = max(arr.shape[0] // n_io_ranks, 1)
                    hi = arr.shape[0] if r == n_io_ranks - 1 else (r + 1) * per
                    part[name] = arr[r * per:hi]
            write_dat(out_dir, r, dstep, part)
    dat_s = time.perf_counter() - t0
    d1 = _darshan_totals(MONITOR)
    dump = {name: _species_arrays(sp) for name, sp in
            (("e", state.electrons), ("D_plus", state.ions),
             ("D", state.neutrals))}
    C = cfg.capacity
    per = C // n_io_ranks
    t0 = time.perf_counter()
    paths = []
    for r in range(n_io_ranks):
        hi = C if r == n_io_ranks - 1 else (r + 1) * per
        paths.append(write_dmp(out_dir, r, step, {
            f"{sp}/{rec}": arr[r * per:hi]
            for sp, recs in dump.items() for rec, arr in recs.items()}))
    dmp_s = time.perf_counter() - t0
    d2 = _darshan_totals(MONITOR)
    t0 = time.perf_counter()
    for r, p in enumerate(paths):
        hi = C if r == n_io_ranks - 1 else (r + 1) * per
        back = read_dmp(p, rank=r)
        for sp, recs in dump.items():
            for rec, arr in recs.items():
                if not np.array_equal(back[f"{sp}/{rec}"], arr[r * per:hi]):
                    raise AssertionError(f"read_dmp {p.name} {sp}/{rec} "
                                         f"differs")
    read_s = time.perf_counter() - t0
    files = sorted(out_dir.iterdir())
    res = {
        "ranks": n_io_ranks, "dat_steps": sorted(written),
        "dmp_step": step,
        "dat": {"s": dat_s, "files": sum(f.suffix == ".dat" for f in files),
                "bytes": sum(f.stat().st_size for f in files
                             if f.suffix == ".dat"),
                "darshan": _darshan_delta(d0, d1)},
        "dmp": {"s": dmp_s, "files": sum(f.suffix == ".dmp" for f in files),
                "bytes": sum(f.stat().st_size for f in files
                             if f.suffix == ".dmp"),
                "darshan": _darshan_delta(d1, d2), "read_back_s": read_s},
        "openpmd": openpmd}
    expect = n_io_ranks * len(written)
    if res["dat"]["files"] != expect or res["dmp"]["files"] != n_io_ranks:
        raise AssertionError(f"original I/O wrote {res['dat']['files']} .dat "
                             f"(expected {expect}) and {res['dmp']['files']}"
                             f" .dmp files (expected {n_io_ranks})")
    shutil.rmtree(out_dir, ignore_errors=True)
    return res


def print_original_io(res: dict):
    o = res["openpmd"]
    print(f"original I/O vs openPMD ({res['ranks']} ranks; diagnostics of "
          f"steps {res['dat_steps']}, dump of step {res['dmp_step']}):")
    for name, r in (("original .dat", res["dat"]), ("original .dmp",
                                                    res["dmp"]),
                    ("openPMD/BP4 series", o)):
        d = r["darshan"]
        print(f"  {name}: {r['s']:.3f} s, {r['files']} files, {r['bytes']} "
              f"bytes; opens {d['POSIX_OPENS']:.0f}, writes "
              f"{d['POSIX_WRITES']:.0f}, bytes written "
              f"{d['POSIX_BYTES_WRITTEN']:.0f}, write time "
              f"{d['F_WRITE_TIME']:.4f} s, metadata time "
              f"{d['F_META_TIME']:.4f} s, metadata share "
              f"{d['meta_time_share']}")
    print(f"  .dmp read back bit for bit in {res['dmp']['read_back_s']:.3f} s")


def insitu_reducers(cfg):
    """`examples/sst_streaming.py`'s four reducers."""
    from repro_torch.insitu import (FieldEnergy, Moments, ReducerSet,
                                    SpeciesCount)
    return ReducerSet([
        SpeciesCount("density/e", scale=cfg.dx, name="n_e"),
        SpeciesCount("density/D", scale=cfg.dx, name="n_D"),
        Moments("vdist/e", name="vdist_moments"),
        FieldEnergy("density/e", cell_volume=cfg.dx, name="e_field_energy"),
    ])


def run_insitu(torch, workdir: pathlib.Path, cfg, state, *, chunks: int = 3,
               steps_per_chunk: int = 10) -> dict:
    """In-situ streaming at `cfg`'s width from `state`: `chunks` chunks of
    `run_with_diagnostics(stream=SstStream(tee=AsyncBpWriter),
    reducers=...)`, with the four reducers of the SST example both inline
    (`reducers=`) and live on a consumer thread (`attach_reducers`); after
    the stream closes, the post-hoc replay of the teed series must equal
    both exactly."""
    from repro_torch.core.async_engine import AsyncBpWriter
    from repro_torch.core.bp_engine import EngineConfig
    from repro_torch.core.sst_engine import SstStream
    from repro_torch.insitu import (assert_parity, attach_reducers,
                                    reduce_posthoc)
    from repro_torch.pic import simulation as sim

    out = workdir / "insitu.bp4"
    tee = AsyncBpWriter(out, n_ranks=4,
                        cfg=EngineConfig(aggregators=2, codec="blosc"))
    stream = SstStream(queue_depth=2, tee=tee)
    live, inline = insitu_reducers(cfg), insitu_reducers(cfg)
    consumer = attach_reducers(stream, live)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state = sim.run_with_diagnostics(state, cfg, None, n_chunks=chunks,
                                         steps_per_chunk=steps_per_chunk,
                                         stream=stream, reducers=inline)
    finally:
        stream.close()
        consumer.join(timeout=60)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if consumer.is_alive() or consumer.error is not None:
        raise AssertionError(f"in-situ consumer failed: {consumer.error}")
    t0 = time.perf_counter()
    posthoc = reduce_posthoc(str(out), insitu_reducers(cfg))
    posthoc_s = time.perf_counter() - t0
    res_live = live.results()
    assert_parity(res_live, posthoc)
    assert_parity(inline.results(), posthoc)
    n_D = res_live["n_D"]["counts"]
    if len(n_D) != chunks:
        raise AssertionError(f"in-situ: {len(n_D)} steps reduced, "
                             f"expected {chunks}")
    shutil.rmtree(out, ignore_errors=True)
    return {"chunks": chunks, "steps": chunks * steps_per_chunk,
            "run_s": run_s, "posthoc_s": posthoc_s,
            "reduced_steps": [int(s) for s in res_live["n_e"]["steps"]],
            "n_e": [float(v) for v in res_live["n_e"]["counts"]],
            "n_D": [float(v) for v in n_D],
            "vdist_moments": {k: float(v) for k, v in
                              res_live["vdist_moments"].items()
                              if k in ("mean", "var")}}


# ===================================================================== training
#: the zamba2 train step: the launcher's defaults (batch 8, seq 256)
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "zamba2-2.7b", 8, 256, 3
#: the noise floor's other chunking of the plain versions (the trainer's
#: are min(256, seq) for attention and min(64, seq) for SSD)
FLOOR_ATTN_CHUNK, FLOOR_SSD_CHUNK = 128, 32
#: the trainer phase: smollm-360m at full width, depth cut to fit the time
TRAINER_ARCH, TRAINER_LAYERS = "smollm-360m", 4


def train_launches(cfg) -> dict:
    """The kernels' launches a remat'd train step, from the code: the
    forward launches each kernel once a call; the backward recomputes each
    checkpointed body. Hybrid: a unit is checkpointed around its inner
    checkpointed Mamba2 layers, so an SSD call runs 3 times (forward, the
    unit's recompute, the layer's recompute) and the shared block's flash
    twice (forward, the unit's recompute). Dense: each layer once more.
    The backward of either kernel launches none (flash: the plain
    `_flash_bwd_impl`; SSD: autograd of the plain `ssd_chunked`)."""
    if cfg.family == "hybrid":
        units = cfg.n_layers // cfg.shared_attn_interval
        return {"flash_attention": 2 * units, "ssd_scan": 3 * cfg.n_layers}
    if cfg.family in ("dense", "audio"):
        return {"flash_attention": 2 * cfg.n_layers, "ssd_scan": 0}
    raise ValueError(f"no train launch count for family {cfg.family}")


@functools.cache
def _plain_flash_function():
    """The flash autograd Function with the plain forward (and its lse)
    in place of the kernel; the backward is the same."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_plain

    class PlainForward(fops.FlashAttention):
        @staticmethod
        def forward(ctx, q, k, v, causal, qc, kc):
            out, lse = flash_fwd_plain(q, k, v, causal=causal, q_chunk=qc,
                                       kv_chunk=kc)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.args = (causal, qc, kc)
            return out
    return PlainForward


def plain_flash_train(q, k, v, *, causal=True, qc=512, kc=512):
    """The flash wrapper's contract through its plain version, with the
    same custom backward as the kernel's autograd Function
    (`flash_attention_bwd_plain`)."""
    return _plain_flash_function().apply(q, k, v, causal, qc, kc)


def _train_batches(torch, cfg, dev, n: int, batch: int, seq: int) -> list:
    from repro_torch.data.pipeline import SyntheticTokens, to_device
    data = SyntheticTokens(cfg.padded_vocab, seq, batch, seed=0)
    return [to_device(data.batch_at(i), dev) for i in range(n)]


def _run_steps(torch, cfg, dev, batches, *, ssd_chunk, attn_chunk, flash,
               scan, hp, launch_counters=None) -> dict:
    """A fresh train state (params from seed 0) through one step a batch,
    with the model's flash and SSD calls routed to `flash` and `scan`.
    Returns the metrics, the step wall times, each step's kernel launches
    and the state."""
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    state = init_train_state(cfg, 0, device=dev)
    step_fn = make_train_step(cfg, hp, q_chunk=attn_chunk,
                              kv_chunk=attn_chunk, ssd_chunk=ssd_chunk)
    out = {"loss": [], "grad_norm": [], "lr": [], "step_s": [],
           "launches": []}
    with routed(flash, scan):
        for b in batches:
            for fn in (launch_counters or {}).values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["launches"].append({k: fn.launches for k, fn in
                                    (launch_counters or {}).items()})
            for k in ("loss", "grad_norm", "lr"):
                out[k].append(float(m[k]))
    out["state"] = state
    out["step_fn"] = step_fn
    return out


def _param_gap(torch, a: list, b: list) -> dict:
    """RMS and max of the elementwise difference of two lists of leaves
    (b may lie on the host)."""
    sq, n, mx = 0.0, 0, 0.0
    for x, y in zip(a, b):
        d = x.float() - y.to(x.device).float()
        sq += float(torch.sum(d * d))
        n += d.numel()
        mx = max(mx, float(d.abs().max()))
    return {"rms": math.sqrt(sq / n), "max": mx}


def check_flash_lse(torch, dev) -> dict:
    """The kernel's `lse` output against the plain version's at every
    instantiated head_dim (causal and not) and at the zamba2 train shape,
    and the output itself unchanged by it; times the lse-writing instance
    beside the serving one (lse null) at the train shape. Limit on lse:
    1e-3 absolute (fp32 sums in another order and the kernel's exp2; a
    log in the wrong base or of unscaled scores is off by ~30 % of lse)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_plain
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    errs = {}
    shapes = [(2, 200, 200, 4, D, c) for D in fops.HEAD_DIMS
              for c in (True, False)]
    shapes.append((TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 32, 80, True))
    for B, Sq, Skv, H, D, causal in shapes:
        q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .bfloat16() for S in (Sq, Skv, Skv))
        out, lse = fops.flash_forward(q, k, v, causal=causal)
        out_serve = fops.flash_attention(q, k, v, causal=causal)
        ref, lref = flash_fwd_plain(q, k, v, causal=causal, q_chunk=256,
                                    kv_chunk=256)
        torch.cuda.synchronize()
        el, eo = _max_err(lse, lref), _max_err(out, ref)
        top = float(ref.float().abs().max())
        errs[(B, Sq, Skv, H, D, causal)] = (el, eo)
        if not (el <= 1e-3 and eo <= flash_limit(top)
                and torch.equal(out, out_serve)):
            raise AssertionError(f"flash lse {(B, Sq, Skv, H, D, causal)}: "
                                 f"lse err {el}, out err {eo} (limit "
                                 f"{flash_limit(top)}), equal to the "
                                 f"serving call {torch.equal(out, out_serve)}")
    print("flash lse vs plain (lse limit 1e-3; out flash_limit, and equal "
          "to the call without lse): " + ", ".join(
              f"{k}: lse {v[0]:.3g} out {v[1]:.3g}" for k, v in errs.items()))
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, 32, 80
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lse_kernel(i):
        return fops.flash_forward(q, k, v, causal=True)

    def serve_kernel(i):
        return fops.flash_attention(q, k, v, causal=True)

    def yardstick(i):
        return sdpa(qt, kt, vt, is_causal=True)
    b, by = flash_bound(B, S, S, H, D, True)
    b += 4 * B * H * S / HBM_BYTES_PER_S * 1e3     # the lse written
    row = {"name": "flash_attention_lse", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
           "path": f"{TRAIN_ARCH} train step (forward and recompute)",
           "max_abs_err": errs[(B, S, S, H, D, True)][0],
           "ms": time_ms(torch, lse_kernel, 50),
           "device_ms": device_ms(torch, lse_kernel, 20, "flash_fwd_mma"),
           "call_device_ms": library_device_ms(torch, lse_kernel, 20),
           "serve_ms": time_ms(torch, serve_kernel, 50),
           "serve_device_ms": device_ms(torch, serve_kernel, 20,
                                        "flash_fwd_mma"),
           "plain_ms": time_ms(torch, lambda i: flash_fwd_plain(
               q, k, v, causal=True, q_chunk=256, kv_chunk=256), 5),
           "library_ms": time_ms(torch, yardstick, 50),
           "library_device_ms": library_device_ms(torch, yardstick, 20),
           "bound_ms": b, "bound_by": by,
           "shape": f"B={B} Sq={S} Skv={S} H={H} D={D} bf16 causal, "
                    f"lse fp32 [B,H,S]"}
    return row


def run_train_step(torch, dev, cfg=None) -> dict:
    """zamba2-2.7b at full width and depth through `make_train_step` (remat
    on, the trainer's chunks: attention min(256, seq), SSD min(64, seq);
    AdamW at the launcher's defaults), batch 8 x seq 256, 3 steps from
    params of seed 0:
    - through the kernels, counting each kernel's launches a step against
      `train_launches`;
    - through the plain versions (flash's plain forward with the same
      backward; the plain `ssd_chunked` under autograd), from the same
      state and batches;
    - through the plain versions chunked otherwise (attention 128, SSD 32):
      the noise floor.
    The kernels' losses, grad norms (every step) and final params must be
    within 2 noise floors of the plain run's. Then a 4th step through the
    kernels under the profiler. Peak memory is printed."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.tree import tree_leaves

    cfg = cfg or get_config(TRAIN_ARCH)
    hp = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=100)
    batches = _train_batches(torch, cfg, dev, TRAIN_STEPS + 1, TRAIN_BATCH,
                             TRAIN_SEQ)
    chunk = {"attn_chunk": min(256, TRAIN_SEQ),
             "ssd_chunk": min(64, TRAIN_SEQ)}
    counters = {"flash_attention": fops.flash_attention,
                "ssd_scan": sops.ssd_scan}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kern = _run_steps(torch, cfg, dev, batches[:TRAIN_STEPS], **chunk,
                      flash=fops.flash_attention, scan=sops.ssd_scan, hp=hp,
                      launch_counters=counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = train_launches(cfg)
    for i, got in enumerate(kern["launches"]):
        if got != expect:
            raise AssertionError(f"train step {i + 1}: launches {got} != "
                                 f"{expect}")
    # a 4th step through the kernels, profiled
    state, step_fn = kern["state"], kern["step_fn"]
    k_params = [t.detach().to("cpu", copy=True)
                for t in tree_leaves(state["params"])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        state, _ = step_fn(state, batches[TRAIN_STEPS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - tp
    prof_rows = _profile_rows(prof, wall, 1)
    del state, step_fn, kern["state"], kern["step_fn"]
    torch.cuda.empty_cache()

    plain = _run_steps(torch, cfg, dev, batches[:TRAIN_STEPS], **chunk,
                       flash=plain_flash_train, scan=plain_scan, hp=hp)
    p_params = tree_leaves(plain.pop("state")["params"])
    plain.pop("step_fn")
    torch.cuda.empty_cache()
    floor = _run_steps(torch, cfg, dev, batches[:TRAIN_STEPS],
                       attn_chunk=FLOOR_ATTN_CHUNK,
                       ssd_chunk=FLOOR_SSD_CHUNK, flash=plain_flash_train,
                       scan=plain_scan, hp=hp)
    f_params = tree_leaves(floor.pop("state")["params"])
    floor.pop("step_fn")
    gaps = {}
    for key in ("loss", "grad_norm"):
        gaps[key] = {
            "kernels": max(abs(a - b) for a, b in zip(kern[key],
                                                      plain[key])),
            "floor": max(abs(a - b) for a, b in zip(floor[key],
                                                    plain[key]))}
    pk, pf = _param_gap(torch, p_params, k_params), _param_gap(
        torch, p_params, f_params)
    gaps["params_rms"] = {"kernels": pk["rms"], "floor": pf["rms"]}
    gaps["params_max"] = {"kernels": pk["max"], "floor": pf["max"]}
    del p_params, f_params, k_params
    torch.cuda.empty_cache()
    res = {"arch": cfg.name, "n_params": cfg.n_params(),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "remat": True, **chunk, "launches_per_step": kern["launches"],
           "expected_launches": expect,
           "step_s": kern["step_s"], "plain_step_s": plain["step_s"],
           "loss": kern["loss"], "plain_loss": plain["loss"],
           "floor_loss": floor["loss"], "grad_norm": kern["grad_norm"],
           "plain_grad_norm": plain["grad_norm"],
           "floor_grad_norm": floor["grad_norm"], "lr": kern["lr"],
           "gaps": gaps, "peak_memory_gib": peak,
           "profiled_step": prof_rows, "phase_s": time.perf_counter() - t0}
    print(json.dumps({"train_step": res}))
    for key, g in gaps.items():
        if not g["kernels"] <= 2 * g["floor"]:
            raise AssertionError(f"train step {key}: kernels vs plain "
                                 f"{g['kernels']} > 2 noise floors "
                                 f"({g['floor']})")
    for x in kern["loss"] + kern["grad_norm"]:
        if not math.isfinite(x):
            raise AssertionError(f"train step: non-finite metric {x}")
    return res


def run_trainer(torch, dev, workdir: pathlib.Path, full=None) -> dict:
    """smollm-360m at full width (960 wide, 15 heads of 64 over 5 kv
    heads), depth cut to TRAINER_LAYERS, through `Trainer` (batch 8, seq
    256, 4 steps, checkpoints every 2 through a device-compressed
    `CheckpointManager`), with deterministic algorithms on:
    - an uninterrupted run;
    - a run that crashes after step 3 (between the saves of steps 2 and
      4), then a run that resumes from `restore_latest` (step 2); its
      losses and final state must equal the uninterrupted run's bit for
      bit;
    - a serve (`ServeEngine.generate`) from the newest checkpoint, whose
      variables carry the JAX package's names and stacked shapes; its
      tokens must equal those of the resumed run's own params."""
    import dataclasses
    import numpy as np
    from repro_torch.ckpt.checkpoint import (Stacked, checkpoint_path,
                                             flatten_state, list_checkpoints)
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.core.bp_engine import BpReader, EngineConfig
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    full = full or get_config(TRAINER_ARCH)
    cfg = dataclasses.replace(full, n_layers=min(TRAINER_LAYERS,
                                                 full.n_layers))
    print(f"trainer phase: {cfg.name} at full width, depth cut "
          f"{full.n_layers} -> {cfg.n_layers} layers "
          f"({cfg.n_params()} params of {full.n_params()})")
    steps = 4
    tcfg = TrainerConfig(steps=steps, log_every=1, ckpt_every=2,
                         seq_len=256, global_batch=8)
    hp = AdamWConfig(lr=3e-4, warmup_steps=min(20, steps // 5 + 1),
                     total_steps=steps)
    engine = EngineConfig(aggregators=4, codec="blosc", workers=4)
    t = {}

    def trainer(path, tc=tcfg):
        return Trainer(cfg, tc, hp, workdir / path, engine_config=engine,
                       device=dev, device_compress=True)

    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        fops.flash_attention.launches = 0
        t0 = time.perf_counter()
        # the reference saves only the trainer's forced final checkpoint
        ref = trainer("ref", dataclasses.replace(tcfg, ckpt_every=10 ** 9)) \
            .run()
        t["uninterrupted_s"] = time.perf_counter() - t0
        ref_flash = fops.flash_attention.launches
        t0 = time.perf_counter()
        crashed = trainer("ckpt")
        try:
            crashed.run(crash_at=3)
            raise AssertionError("the crash was not injected")
        except RuntimeError as e:
            if "injected crash" not in str(e):
                raise
        t["crash_run_s"] = time.perf_counter() - t0
        saved_before = list_checkpoints(workdir / "ckpt")
        resumer = trainer("ckpt")
        fresh = resumer._fresh_state()
        t0 = time.perf_counter()
        resumed_from = resumer.manager.restore_latest(fresh)[1]
        t["restore_s"] = time.perf_counter() - t0
        del fresh
        t0 = time.perf_counter()
        resumed = resumer.run()
        t["resume_run_s"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(prev)
    if saved_before != [2] or resumed_from != 2:
        raise AssertionError(f"checkpoints after the crash {saved_before}, "
                             f"expected [2]; restored step {resumed_from}")
    ref_loss = {h["step"]: h["loss"] for h in ref["history"]}
    res_loss = {h["step"]: h["loss"] for h in resumed["history"]}
    if set(res_loss) != {3, 4} or any(res_loss[s] != ref_loss[s]
                                      for s in res_loss):
        raise AssertionError(f"resumed losses {res_loss} != uninterrupted "
                             f"{ref_loss}")
    a, b = flatten_state(ref["state"]), flatten_state(resumed["state"])
    for name, x in a.items():
        y = b[name]
        xs = x.parts if isinstance(x, Stacked) else [x]
        ys = y.parts if isinstance(y, Stacked) else [y]
        if not all(torch.equal(u, w) for u, w in zip(xs, ys)):
            raise AssertionError(f"resumed state {name} differs from the "
                                 f"uninterrupted run's")
    # the newest checkpoint carries the JAX package's names and shapes
    newest = list_checkpoints(workdir / "ckpt")[-1]
    with BpReader(checkpoint_path(workdir / "ckpt", newest)) as reader:
        info = reader.var_info(newest, "state/params/stack/layers/attn/wk/w")
        n_vars = len(reader.var_names(newest))
    want = [cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim]
    if list(info["shape"]) != want:
        raise AssertionError(f"checkpoint layers/attn/wk/w shape "
                             f"{info['shape']} != {want}")
    t0 = time.perf_counter()
    like = M.init_params(cfg, 1, device=dev)
    restored = CheckpointManager(workdir / "ckpt").restore_latest(
        {"params": like})
    t["serve_restore_s"] = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)).astype(np.int32)
    scfg = ServeConfig(max_batch=2, max_seq=256, max_new_tokens=8)
    fops.flash_attention.launches = 0
    toks = ServeEngine(cfg, restored[0]["params"], scfg).generate(prompts)
    serve_flash = fops.flash_attention.launches
    want_toks = ServeEngine(cfg, resumed["state"]["params"], scfg).generate(
        prompts)
    if not np.array_equal(toks, want_toks) or serve_flash != cfg.n_layers:
        raise AssertionError(f"serve from the checkpoint: tokens equal "
                             f"{np.array_equal(toks, want_toks)}, flash "
                             f"launches {serve_flash} != {cfg.n_layers}")
    res = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "full_depth": full.n_layers, "n_params": cfg.n_params(),
           "steps": steps, "ckpt_every": 2, "crash_at": 3,
           "resumed_from": resumed_from,
           "losses": [ref_loss[s] for s in sorted(ref_loss)],
           "bit_exact_resume": True, "checkpoint_vars": n_vars,
           "newest_checkpoint": newest, "serve_step": restored[1],
           "flash_launches_uninterrupted": ref_flash,
           "expected_flash_uninterrupted": steps * train_launches(cfg)[
               "flash_attention"],
           "serve_tokens": toks.tolist(), "t": t,
           "manager": manager_stats(resumer.manager)}
    if ref_flash != res["expected_flash_uninterrupted"]:
        raise AssertionError(f"trainer flash launches {ref_flash} != "
                             f"{res['expected_flash_uninterrupted']}")
    print(json.dumps({"trainer": res}))
    return res


def manager_stats(m) -> dict:
    return {**m.stats, "overlap_fraction": m.overlap_fraction(),
            "saved_steps": m.saved_steps}


def print_kernel(k: dict):
    lib = ("-" if k["library_ms"] is None else
           f"{k['library_ms']:.4f} (device {k['library_device_ms']})")
    print(f"  {k['name']}: {k['ms']:.4f} ms (device {k['device_ms']:.5f}, "
          f"whole call {k['call_device_ms']:.5f}, "
          f"plain {k['plain_ms']:.4f}, yardstick {lib}, "
          f"bound {k['bound_ms']:.5f} by {k['bound_by']}) at {k['shape']}")


def paper_cfg():
    from repro_torch.configs.bit1 import paper_config
    return paper_config()


def main() -> int:
    # the trainer phase runs with deterministic algorithms, which need
    # cuBLAS's fixed workspace, set before CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitshuffle import ops as bops
    from repro_torch.kernels.deposit import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; fp32 matmul allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} (left at its default)")

    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s")
    for src, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "error")):
                print(f"  {src}: {line.strip()}")

    # the main path's shapes: the paper's 2^25-slot species on 100,000
    # cells, and the codec's 1 MiB block of float32 state
    kernels = [check_deposit(torch, dev, 1 << 25, 100_000)]
    kernels += check_bitshuffle(torch, dev, 1 << 20, 4)
    for k in kernels:
        print_kernel(k)
    # the LM kernels at the serving paths' shapes, and where a PIC step's
    # device time goes: the profiler-timed numbers come before the long
    # main path, late in which the profiler drops device records
    t0 = time.perf_counter()
    flash_row, flash_rows = check_flash_attention(torch, dev)
    lm_kernels = [flash_row, check_ssd_scan(torch, dev)]
    for k in flash_rows[1:]:
        print_kernel(k)
    for k in lm_kernels:
        print_kernel(k)
    print(json.dumps({"flash_serve_shapes": flash_rows}))
    lse_row = check_flash_lse(torch, dev)
    print_kernel(lse_row)
    print(f"  flash with lse {lse_row['ms']:.4f} ms (device "
          f"{lse_row['device_ms']:.5f}) against the serving call without "
          f"it {lse_row['serve_ms']:.4f} ms (device "
          f"{lse_row['serve_device_ms']:.5f})")
    kernels += lm_kernels + [lse_row]
    print(f"LM kernel checks: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"step_profile": profile_steps(torch, dev)}))
    torch.cuda.empty_cache()

    # the zamba2 train step (profiled: early, before the profiler tires),
    # the kernels' launches read a step at a time inside
    train = run_train_step(torch, dev)
    prof = train["profiled_step"]
    print(f"train step ({train['arch']}, {train['n_params']} params, batch "
          f"{train['batch']} x seq {train['seq']}, remat): step s "
          f"{train['step_s']}, plain {train['plain_step_s']}; profiled "
          f"step device ms {prof['device_ms']}, wall ms "
          f"{prof['profiled_wall_ms']:.1f}, idle share {prof['idle_share']},"
          f" launches {prof['launches']}; peak "
          f"{train['peak_memory_gib']:.2f} GiB; launches a step "
          f"{train['launches_per_step'][0]}; gaps {train['gaps']}; phase "
          f"{train['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    counters = {"deposit_cic": dops.deposit,
                "byte_shuffle_blocks": bops.shuffle_blocks,
                "byte_shuffle_block": bops.shuffle_block,
                "byte_shuffle": bops.shuffle,
                "byte_unshuffle": bops.unshuffle,
                "flash_attention": fops.flash_attention,
                "ssd_scan": sops.ssd_scan}
    for fn in counters.values():
        fn.launches = 0
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    try:
        torch.cuda.reset_peak_memory_stats()
        res = run_main_path(torch, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    expect_dep = 2 * res["steps"] + 3 * res["diag_calls"]
    if launches["deposit_cic"] != expect_dep:
        raise AssertionError(f"deposit launches {launches['deposit_cic']} "
                             f"!= {expect_dep}")
    # one launch a shuffled leaf in each of the two device-compressed
    # checkpoints (serial, and the manager's through the writer plane),
    # none of the one-block wrapper
    par = res["parallel_io"]
    if (launches["byte_shuffle_blocks"] != 2 * res["shuffled_leaves"]
            or par["shuffle_launches"] != res["shuffled_leaves"]
            or launches["byte_shuffle_block"] != 0):
        raise AssertionError(f"shuffle launches: shuffle_blocks "
                             f"{launches['byte_shuffle_blocks']} (parallel "
                             f"checkpoint {par['shuffle_launches']}) for "
                             f"{res['shuffled_leaves']} leaves a checkpoint,"
                             f" shuffle_block {launches['byte_shuffle_block']}"
                             f" != 0")
    t = res["timings_s"]
    compute_steps = res["timed_steps"]
    ms_step = 1e3 * (t["compute_s"] + t["restart_compute_s"]) / compute_steps
    print(f"main path (paper_config, {compute_steps} steps): "
          f"{ms_step:.3f} ms/step; " + ", ".join(
              f"{k}={v:.3f}" for k, v in t.items()))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; device-shuffled bytes {res['device_bytes']:.0f}; "
          f"ionizations {res['ionizations']:.0f}; counts "
          f"{res['counts_start']} -> {res['counts_end']}")
    print(f"launches on the main path: {launches}")
    print_original_io(res["original_io"])
    m = par["manager"]
    print(f"parallel I/O ({par['writers']} writers, {par['transport']}): "
          f"plane spawn {par['t']['plane_spawn_s']:.3f} s; dump "
          f"{t['parallel_dump_s']:.3f} s (serial {t['dump_s']:.3f}), "
          f"{len(par['dump_identical_files'])} files byte-identical, "
          f"{par['dump_vars_read_back']} variables read back; manager "
          f"checkpoint write {m['write_s']:.3f} s (serial "
          f"{t['checkpoint_s']:.3f}), blocked {m['blocked_s']:.3f} s, "
          f"overlap {m['overlap_fraction']:.3f}, save returned in "
          f"{par['t']['save_return_s']:.3f} s, chunk behind it "
          f"{t['overlap_compute_s']:.3f} s; {par['device_bytes']:.0f} "
          f"device-shuffled bytes, {par['shuffle_launches']} shuffle "
          f"launches, bit-exact restore in {par['t']['restore_s']:.3f} s; "
          f"bytes a subfile: dump {par['dump_subfile_bytes']}, checkpoint "
          f"{par['ckpt_subfile_bytes']}; transport bytes: dump "
          f"{par['dump_transport_bytes']}, checkpoint "
          f"{par['ckpt_transport_bytes']}")

    # in-situ streaming from the main path's final state, the counts
    # zeroed just before it and read just after
    state = res.pop("state")
    for fn in counters.values():
        fn.launches = 0
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-insitu-"))
    try:
        insitu = run_insitu(torch, workdir, paper_cfg(), state)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del state
    expect_dep = 2 * insitu["steps"] + 3 * insitu["chunks"]
    if dops.deposit.launches != expect_dep:
        raise AssertionError(f"in-situ deposit launches "
                             f"{dops.deposit.launches} != {expect_dep}")
    insitu["deposit_launches"] = dops.deposit.launches
    print(json.dumps({"insitu": insitu}))
    print(f"in-situ ({insitu['chunks']} chunks of "
          f"{insitu['steps'] // insitu['chunks']} steps at paper width): "
          f"{insitu['run_s']:.3f} s streamed, post-hoc replay "
          f"{insitu['posthoc_s']:.3f} s, live == inline == post-hoc "
          f"(exact); n_D {insitu['n_D']}")
    torch.cuda.empty_cache()

    # the serving paths (SERVE_PATHS), each with the counts zeroed just
    # before its generate() and read just after
    serve_launches_by_path = {}
    for arch, batch, prompt, new, max_seq in SERVE_PATHS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        serve = run_serve_path(torch, dev, serve_config(arch), batch=batch,
                               prompt=prompt, new=new, max_seq=max_seq)
        # generate()'s launches, zeroed just before it
        serve_launches_by_path[arch] = serve["launches"]
        serve["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        serve["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"serve": serve}))
        print(f"serve path ({serve['arch']}, {serve['n_layers']} layers, "
              f"{serve['n_params']} params in {serve['param_dtype']}): "
              f"prefill {serve['prefill_s']:.3f} s "
              f"({serve['prompt_tokens_per_s']:.0f} prompt tokens/s), decode "
              f"{serve['decode_ms_per_step']:.2f} ms/step, peak "
              f"{serve['peak_memory_gib']:.2f} GiB, phase "
              f"{serve['phase_s']:.1f} s, teacher forcing "
              f"{serve['teacher_forcing']}, routing "
              f"{serve.get('routing_agreement')}, prefill drop share "
              f"{serve.get('prefill_drop_share')}")
    for arch, why in NOT_SERVED.items():
        print(f"serve path ({arch}): not run, it does not fit one card "
              f"({why})")
    print(json.dumps({"serve_launches": serve_launches_by_path}))
    serve_launches = {k: sum(v[k] for v in serve_launches_by_path.values())
                      for k in ("flash_attention", "ssd_scan")}

    # train, crash, resume and serve through the Trainer, last: its
    # deterministic mode and checkpoints touch no other phase
    torch.cuda.empty_cache()
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-trainer-"))
    try:
        trainer = run_trainer(torch, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    tt = trainer["t"]
    mg = trainer["manager"]
    print(f"trainer ({trainer['arch']}, {trainer['n_layers']} of "
          f"{trainer['full_depth']} layers, {trainer['n_params']} params): "
          f"uninterrupted {tt['uninterrupted_s']:.2f} s, crash run "
          f"{tt['crash_run_s']:.2f} s, restore {tt['restore_s']:.2f} s, "
          f"resumed run {tt['resume_run_s']:.2f} s (saves {mg['saves']}, "
          f"write {mg['write_s']:.2f} s, blocked {mg['blocked_s']:.2f} s), "
          f"serve restore {tt['serve_restore_s']:.2f} s; losses "
          f"{trainer['losses']}; resume bit-exact; served step "
          f"{trainer['serve_step']} under the JAX names "
          f"({trainer['checkpoint_vars']} variables)")

    # flash and SSD launches: the serve paths' prefills and the train
    # step's first step (the kernels' rows); the lse instance runs only on
    # the train path
    train_launch = train["launches_per_step"][0]
    path_launches = {k: serve_launches[k] + train_launch[k]
                     for k in serve_launches}
    print(json.dumps({"kernel_launches_by_path": {
        "serve": serve_launches, "train_step": train_launch,
        "trainer_uninterrupted_flash":
            trainer["flash_launches_uninterrupted"]}}))
    on_path = {"deposit_cic": launches, "byte_shuffle_blocks": launches,
               "flash_attention": path_launches, "ssd_scan": path_launches,
               "flash_attention_lse": {"flash_attention_lse":
                                       train_launch["flash_attention"]}}
    for k in kernels:
        k["launches"] = on_path.get(k["name"], launches)[k["name"]]
        k["on_path"] = k["name"] in on_path
        k["bound_share"] = (k["bound_ms"] / k["device_ms"]
                            if k["device_ms"] else None)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
