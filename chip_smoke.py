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
5. holds the flash attention and SSD scan kernels against their plain
   versions at zamba2-2.7b's prefill shapes (and a few others);
6. drives the serving path: zamba2-2.7b at full width (54 Mamba2 layers,
   d_model 2560, 2,422,670,240 random params from a seed) through
   `ServeEngine.generate` (batch 4, prompt 512, 32 new tokens), checks the
   kernels' launch counts (9 flash, 54 SSD per prefill, none in decode),
   each kernel against its plain version on the prefill's activations,
   and, in units of a noise floor, the forward through the kernels
   against the one through the plain versions and decode against a
   teacher-forced forward;
7. prints one JSON line of per-kernel numbers, then, as the last line,
   `{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero too when no CUDA device is visible, and when run
outside a checkout of the repository (it imports `repro_torch` from
`src/` beside it). It never imports JAX or the JAX package.
"""
import contextlib
import json
import math
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
    return {"timings_s": t, "steps": steps, "diag_calls": diag_calls,
            "device_bytes": dev_bytes, "restored_from": at,
            "shuffled_leaves": shuffled_leaves,
            "counts_start": {k: d0[k] for k in d0 if k.startswith("count/")},
            "counts_end": {k: d1[k] for k in d1 if k.startswith("count/")},
            "ionizations": d1["ionizations"]}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_flash_attention(torch, dev) -> dict:
    """The kernel against its plain version at the serving shape of
    zamba2-2.7b's shared block (B=4, S=512, H=32, D=80, bf16, causal), and
    at D 64/128, non-causal and ragged S; times at the serving shape."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    # bf16 outputs of two fp32 computations that round p and sum in other
    # orders: one or two bf16 ulps of values up to ~4
    tol = 3e-2
    g = torch.Generator(device=dev)
    g.manual_seed(80)

    def qkv(B, S, H, D):
        return [torch.randn((B, S, H, D), generator=g, device=dev).bfloat16()
                for _ in range(3)]

    errs = {}
    for B, S, H, D, causal in ((4, 512, 32, 80, True), (2, 512, 8, 64, True),
                               (2, 512, 8, 128, True), (2, 512, 8, 80, False),
                               (2, 320, 8, 80, True), (2, 320, 8, 128, False)):
        q, k, v = qkv(B, S, H, D)
        got = fops.flash_attention(q, k, v, causal=causal)
        ref = flash_attention_plain(q, k, v, causal=causal, q_chunk=256,
                                    kv_chunk=256)
        torch.cuda.synchronize()
        errs[(B, S, H, D, causal)] = err = _max_err(got, ref)
        if not err < tol:
            raise AssertionError(f"flash B={B} S={S} H={H} D={D} "
                                 f"causal={causal}: max_abs_err {err}")
    print("flash_attention max_abs_err vs plain (tol 3e-2): " + ", ".join(
        f"{k}: {v:.4g}" for k, v in errs.items()))

    B, S, H, D = 4, 512, 32, 80
    q, k, v = qkv(B, S, H, D)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))    # [B,H,S,D] views
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def yardstick(i):
        return sdpa(qt, kt, vt, is_causal=True)
    pairs = S * (S + 1) // 2                 # causal (query, key) pairs
    b, by = bound_ms(4 * B * S * H * D * 2, 4 * D * pairs * B * H,
                     BF16_OPS_PER_S)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:71",
            "max_abs_err": errs[(B, S, H, D, True)],
            "ms": time_ms(torch, lambda i: fops.flash_attention(q, k, v), 50),
            "device_ms": device_ms(torch, lambda i: fops.flash_attention(
                q, k, v), 20, "flash_fwd_mma"),
            "call_device_ms": library_device_ms(
                torch, lambda i: fops.flash_attention(q, k, v), 20),
            "plain_ms": time_ms(torch, lambda i: flash_attention_plain(
                q, k, v, q_chunk=256, kv_chunk=256), 5),
            "library_ms": time_ms(torch, yardstick, 50),
            "library_device_ms": library_device_ms(torch, yardstick, 20),
            "bound_ms": b, "bound_by": by,
            "shape": f"B={B} S={S} H={H} D={D} bf16 causal"}


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
    of each. The limits are those of the kernel checks (flash 3e-2, SSD y
    5e-2, SSD state relative 1e-4), set there for values up to ~4; above
    that an absolute limit grows with the reference's largest value, as a
    bf16 ulp does."""
    out = {}
    for which, (args, kw, got) in flash_calls.items():
        ref = plain_flash(*args, **kw)
        top = float(ref.float().abs().max())
        err = _max_err(got, ref)
        out[f"flash_attention/{which}"] = {"max_abs_err": err,
                                           "max_abs": top}
        if not err < 3e-2 * max(1.0, top / 4):
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


def run_serve_path(torch, dev, cfg=None, *, batch=4, prompt=512, new=32,
                   max_seq=1024) -> dict:
    """`cfg`, a hybrid config (default: zamba2-2.7b at full width), served
    through `ServeEngine.generate`: the launch counts of the kernels are
    zeroed just before it and read just after. Then prefill and each decode
    step are timed apart, with the counts read between them; each kernel's
    outputs in that prefill are held against its plain version; and the
    decode logits are held against one teacher-forced forward through the
    kernels, that forward against one through the plain versions, and both
    gaps against the noise floor: two forwards through the plain versions
    that differ only in their chunking. Returns timings, counts and the
    checks' numbers."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = cfg or get_config("zamba2-2.7b")
    if cfg.family != "hybrid":
        raise ValueError(f"run_serve_path serves a hybrid config, not "
                         f"{cfg.name} ({cfg.family})")
    kernels = {"flash_attention": fops.flash_attention,
               "ssd_scan": sops.ssd_scan}
    # per prefill: the shared block after every `shared_attn_interval`
    # Mamba2 layers, and every Mamba2 layer
    expect = {"flash_attention": cfg.n_layers // cfg.shared_attn_interval,
              "ssd_scan": cfg.n_layers}

    def counts():
        return {k: f.launches for k, f in kernels.items()}

    def zero():
        for f in kernels.values():
            f.launches = 0

    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=dev)
    n_params = sum(t.numel() for t in M.leaves(params))
    if n_params != cfg.n_params():
        raise AssertionError(f"{n_params} params, expected {cfg.n_params()}")
    eng = ServeEngine(cfg, params, ServeConfig(max_batch=batch,
                                               max_seq=max_seq,
                                               max_new_tokens=new))
    del params                    # the engine keeps what it reads
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
    eng.generate(prompts, new_tokens=2)   # cuBLAS handles and workspaces

    zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = eng.generate(prompts, new_tokens=new)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = counts()
    if launches != expect:
        raise AssertionError(f"serve launches {launches} != {expect}")
    if gen.shape != (batch, new) or not ((gen >= 0) &
                                         (gen < cfg.padded_vocab)).all():
        raise AssertionError(f"generated tokens out of range: {gen.shape}")

    # prefill and decode apart, their launches, the kernels on the
    # prefill's activations, and the teacher-forced check
    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        flash_rec = FirstAndLast(fops.flash_attention)
        scan_rec = FirstAndLast(sops.ssd_scan)
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routed(flash_rec, scan_rec):
            logits, cache = eng.prefill(eng.params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = counts()
        activations = check_on_activations(torch, flash_rec.calls,
                                           scan_rec.calls)
        del flash_rec, scan_rec
        cache = eng._grow_cache(cache)
        steps = [logits[:, -1]]
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(new - 1):
            tok = torch.as_tensor(gen[:, t:t + 1], dtype=torch.int64,
                                  device=dev)
            logits, cache = M.decode_step(eng.params, cfg, tok, cache,
                                          prompt + t)
            steps.append(logits[:, -1])
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / max(new - 1, 1)
        decode_launches = counts()
        dec = torch.stack(steps, 1)
        seq = torch.as_tensor(np.concatenate([prompts, gen[:, :-1]], 1),
                              dtype=torch.int64, device=dev)

        def forward(q_chunk, kv_chunk, ssd_chunk):
            out, _ = M.forward(eng.params, cfg, {"tokens": seq},
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               ssd_chunk=ssd_chunk)
            return out[:, prompt - 1:]

        # the chunks only matter to the plain versions: 3 x 181 or 1 x 543
        # positions for flash, 128 or 64 for the scan
        full = forward(256, 256, 128)
        with routed(plain_flash, plain_scan):
            plain = forward(256, 256, 128)
            plain_b = forward(1024, 1024, 64)
    if prefill_launches != expect or any(decode_launches.values()):
        raise AssertionError(f"launches: prefill {prefill_launches}, "
                             f"decode {decode_launches}")
    if not torch.equal(dec.argmax(-1).cpu(), torch.as_tensor(gen).long()):
        raise AssertionError("decode logits do not give the generated tokens")
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        raise AssertionError("non-finite logits")
    top = float(full.abs().max())
    # the noise floor: the plain versions' own summation order, carried
    # through every layer
    floor = float((plain - plain_b).abs().max())
    # the kernels' rounding, carried through every layer
    kdiff = float((full - plain).abs().max())
    # decode (recurrent Mamba2 step with a bf16 state, softmax over the
    # cache) and the forward (chunked scan, flash) round at other points
    diff = float((dec - full).abs().max())
    # the limits in units of the floor (or of a hundredth of the largest
    # logit, where a small model rounds alike both ways): the kernels may
    # move the logits half as much again as the plain versions' own order
    # does, decode twice as much, for its bf16 state
    unit = max(floor, 0.01 * top)
    if not (kdiff <= 1.5 * unit and diff <= 2 * unit):
        raise AssertionError(f"logits differ: decode vs forward {diff}, "
                             f"kernels vs plain {kdiff}, noise floor "
                             f"{floor} (max |logit| {top})")

    def margin(logits, gap):
        top2 = logits.topk(2, dim=-1).values
        return ((top2[..., 0] - top2[..., 1]) > 2 * gap).cpu().numpy()

    clear = margin(full, diff)
    same = full.argmax(-1).cpu().numpy() == gen
    if not same[clear].all():
        raise AssertionError("a decoded token differs from the forward's "
                             "where the margin is clear")
    kclear = margin(plain, kdiff)
    ksame = (full.argmax(-1) == plain.argmax(-1)).cpu().numpy()
    if not ksame[kclear].all():
        raise AssertionError("a token of the forward through the kernels "
                             "differs from the plain one where the margin "
                             "is clear")
    profile = profile_serve(torch, eng, cfg, tokens, gen)
    return {"arch": cfg.name, "n_params": n_params, "init_s": init_s,
            "generate_s": generate_s, "prefill_s": prefill_s,
            "prompt_tokens_per_s": batch * prompt / prefill_s,
            "decode_ms_per_step": decode_ms, "launches": launches,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches,
            "kernels_on_activations": activations,
            "teacher_forcing": {"max_abs_diff": diff, "max_abs_logit": top,
                                "kernels_vs_plain_max_abs_diff": kdiff,
                                "noise_floor_max_abs_diff": floor,
                                "clear_share": float(clear.mean()),
                                "equal_share": float(same.mean()),
                                "kernels_clear_share": float(kclear.mean()),
                                "kernels_equal_share": float(ksame.mean())},
            "profile": profile,
            "shape": f"batch {batch}, prompt {prompt}, {new} new tokens, "
                     f"max_seq {max_seq}"}


def profile_serve(torch, eng, cfg, tokens, gen, n_decode: int = 4) -> dict:
    """Where the serving path's device time goes: device time by kernel
    (device activity only) over one prefill, and over `n_decode` decode
    steps, each against its profiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    Sp = tokens.shape[1]
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, cache = eng.prefill(eng.params, {"tokens": tokens})
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


def print_kernel(k: dict):
    lib = ("-" if k["library_ms"] is None else
           f"{k['library_ms']:.4f} (device {k['library_device_ms']})")
    print(f"  {k['name']}: {k['ms']:.4f} ms (device {k['device_ms']:.5f}, "
          f"whole call {k['call_device_ms']:.5f}, "
          f"plain {k['plain_ms']:.4f}, yardstick {lib}, "
          f"bound {k['bound_ms']:.5f} by {k['bound_by']}) at {k['shape']}")


def main() -> int:
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
    # one launch a shuffled leaf, none of the one-block wrapper
    if (launches["byte_shuffle_blocks"] != res["shuffled_leaves"]
            or launches["byte_shuffle_block"] != 0):
        raise AssertionError(f"shuffle launches: shuffle_blocks "
                             f"{launches['byte_shuffle_blocks']} != "
                             f"{res['shuffled_leaves']} leaves, "
                             f"shuffle_block {launches['byte_shuffle_block']}"
                             f" != 0")
    t = res["timings_s"]
    compute_steps = res["steps"]
    ms_step = 1e3 * (t["compute_s"] + t["restart_compute_s"]) / compute_steps
    print(f"main path (paper_config, {compute_steps} steps): "
          f"{ms_step:.3f} ms/step; " + ", ".join(
              f"{k}={v:.3f}" for k, v in t.items()))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; device-shuffled bytes {res['device_bytes']:.0f}; "
          f"ionizations {res['ionizations']:.0f}; counts "
          f"{res['counts_start']} -> {res['counts_end']}")
    print(f"launches on the main path: {launches}")
    print(json.dumps({"step_profile": profile_steps(torch, dev)}))
    torch.cuda.empty_cache()

    # the serving path: zamba2-2.7b at full width
    t0 = time.perf_counter()
    lm_kernels = [check_flash_attention(torch, dev), check_ssd_scan(torch, dev)]
    for k in lm_kernels:
        print_kernel(k)
    kernels += lm_kernels
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    serve = run_serve_path(torch, dev)
    serve_launches = serve["launches"]      # generate()'s, zeroed before it
    serve["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    serve["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"serve": serve}))
    print(f"serve path ({serve['arch']}, {serve['n_params']} params): "
          f"prefill {serve['prefill_s']:.3f} s "
          f"({serve['prompt_tokens_per_s']:.0f} prompt tokens/s), decode "
          f"{serve['decode_ms_per_step']:.2f} ms/step, peak "
          f"{serve['peak_memory_gib']:.2f} GiB, teacher forcing "
          f"{serve['teacher_forcing']}")

    on_path = {"deposit_cic": launches, "byte_shuffle_blocks": launches,
               "flash_attention": serve_launches, "ssd_scan": serve_launches}
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
