#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from `src/repro_torch/csrc/` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times kernel, plain version and the
   one-call PyTorch yardstick with CUDA events;
4. drives the main path at the paper's full width (`paper_config`: 100,000
   cells, 2^25 slots for each of 3 species): compute chunks, diagnostics,
   openPMD writes, a particle dump, a device-compressed checkpoint, restore
   and restart, and checks the results and the kernels' launch counts;
5. prints one JSON line of per-kernel numbers, then, as the last line,
   `{"ok": true, "device": {...}}`.

Any failed check raises and the script exits non-zero without the last
line. It exits non-zero too when no CUDA device is visible, and when run
outside a checkout of the repository (it imports `repro_torch` from
`src/` beside it). It never imports JAX or the JAX package.
"""
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
#: NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: ops per particle of the deposit: x/dx, floor, frac, w*alive, 1-frac,
#: two products, two atomic adds
DEPOSIT_OPS = 9


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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


def device_ms(torch, fn, iters: int, kernel: str):
    """Mean device time of one launch of the CUDA kernel whose name holds
    `kernel`, over `iters` calls, from torch.profiler (no host time in
    it); None when the profiler records no device time for that kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += _device_us(ev)
            count += ev.count
    return total / 1e3 / count if count and total else None


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
    rows = sorted(((ev.key, _device_us(ev, self_only=True), ev.count)
                   for ev in prof.key_averages()), key=lambda r: -r[1])
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows) / 1e3 / n_steps
    return {"steps": n_steps, "device_ms_per_step": busy,
            "profiled_wall_ms_per_step": 1e3 * wall / n_steps,
            "top": [[k[:80], us / 1e3 / n_steps, c / n_steps]
                    for k, us, c in rows[:12]]}


def check_deposit(torch, dev, n: int, n_cells: int) -> dict:
    from repro_torch.kernels.deposit import ops as dops
    from repro_torch.kernels.deposit.ref import deposit_ref
    L = 1.0
    dx = L / n_cells
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    x = torch.rand(n, generator=g, device=dev) * L
    # a few positions at and just below L pile into the last cell
    x[:1024] = L
    x[1024:2048] = torch.nextafter(torch.tensor(L), torch.tensor(0.0))
    w = 0.5 + 1.5 * torch.rand(n, generator=g, device=dev)
    alive = (torch.rand(n, generator=g, device=dev) > 0.25).float()
    got = dops.deposit(x, w, alive, n_cells=n_cells, dx=dx)
    ref = deposit_ref(x, w, alive, n_cells, dx)
    torch.cuda.synchronize()
    max_abs = float((got - ref).abs().max())
    rel = max_abs / max(float(ref.abs().max()), 1e-9)
    total = float((w * alive).double().sum())
    charge = abs(float(got.double().sum()) * dx - total) / total
    print(f"deposit n={n} n_cells={n_cells}: max_abs_err={max_abs:.6g} "
          f"rel={rel:.3g} charge_err={charge:.3g}")
    if not rel < 1e-4:
        raise AssertionError(f"deposit disagrees with plain: rel {rel}")
    if not charge < 1e-5:
        raise AssertionError(f"deposit does not conserve charge: {charge}")

    xi = x / dx
    i0 = torch.floor(xi).long()
    frac = xi - i0
    wa = w * alive
    i0c = i0.clamp(0, n_cells - 1)
    i1c = (i0 + 1).clamp(0, n_cells - 1)
    w0, w1 = wa * (1 - frac), wa * frac
    ms = time_ms(torch, lambda i: dops.deposit(x, w, alive, n_cells=n_cells,
                                               dx=dx), 20)
    plain = time_ms(torch, lambda i: deposit_ref(x, w, alive, n_cells, dx), 5)
    lib = time_ms(torch, lambda i: (
        torch.bincount(i0c, weights=w0, minlength=n_cells),
        torch.bincount(i1c, weights=w1, minlength=n_cells)), 5)
    dms = device_ms(torch, lambda i: dops.deposit(x, w, alive,
                                                  n_cells=n_cells, dx=dx),
                    10, "deposit_cic_kernel")
    b, by = bound_ms(12 * n + 4 * n_cells, DEPOSIT_OPS * n)
    return {"name": "deposit_cic", "route": "cuda", "device_ms": dms,
            "source": "src/repro_torch/csrc/deposit.cu",
            "replaces": "src/repro/kernels/deposit/kernel.py:48",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": lib,
            "shape": f"N={n}, n_cells={n_cells}"}


def check_bitshuffle(torch, dev, block: int, itemsize: int) -> list[dict]:
    from repro_torch.core.compression import byte_shuffle
    from repro_torch.kernels.bitshuffle import ops as bops
    from repro_torch.kernels.bitshuffle.ref import (byte_shuffle_ref,
                                                    byte_unshuffle_ref)
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
    torch.cuda.synchronize()
    print("bitshuffle: shuffle_block, shuffle, unshuffle bit-exact for "
          "itemsize 2/4/8, n_items 1/7/65521/262144")

    # timing at the write path's shape: one 1 MiB codec block of float32,
    # each call on a different block of a 256 MiB buffer (cold in L2)
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
    lib = time_ms(torch, lambda i: blocks[i % n_blocks].view(-1, itemsize)
                  .t().contiguous(), n_blocks)
    lib_un = time_ms(torch, lambda i: shuffled[i % n_blocks]
                     .view(itemsize, -1).t().contiguous(), n_blocks)
    def dev_ms(fn, kernel):
        return device_ms(torch, fn, n_blocks, kernel)

    return [
        {**common, "name": "byte_shuffle_block",
         "device_ms": dev_ms(lambda i: bops.shuffle_block(
             blocks[i % n_blocks], itemsize=itemsize), "transpose_short_cols"),
         "replaces": "src/repro/kernels/bitshuffle/kernel.py:55",
         "ms": time_ms(torch, lambda i: bops.shuffle_block(
             blocks[i % n_blocks], itemsize=itemsize), n_blocks),
         "plain_ms": time_ms(torch, lambda i: byte_shuffle_ref(
             blocks[i % n_blocks], itemsize=itemsize), n_blocks),
         "library_ms": lib},
        {**common, "name": "byte_shuffle",
         "device_ms": dev_ms(lambda i: bops.shuffle(
             blocks[i % n_blocks], itemsize=itemsize), "transpose_short_cols"),
         "replaces": "src/repro/kernels/bitshuffle/kernel.py:36",
         "ms": time_ms(torch, lambda i: bops.shuffle(
             blocks[i % n_blocks], itemsize=itemsize), n_blocks),
         "plain_ms": time_ms(torch, lambda i: byte_shuffle_ref(
             blocks[i % n_blocks], itemsize=itemsize), n_blocks),
         "library_ms": lib},
        {**common, "name": "byte_unshuffle",
         "device_ms": dev_ms(lambda i: bops.unshuffle(
             shuffled[i % n_blocks], block, itemsize=itemsize),
             "transpose_short_rows"),
         "replaces": "src/repro/kernels/bitshuffle/kernel.py:74",
         "ms": time_ms(torch, lambda i: bops.unshuffle(
             shuffled[i % n_blocks], block, itemsize=itemsize), n_blocks),
         "plain_ms": time_ms(torch, lambda i: byte_unshuffle_ref(
             shuffled[i % n_blocks], itemsize=itemsize), n_blocks),
         "library_ms": lib_un},
    ]


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
            "counts_start": {k: d0[k] for k in d0 if k.startswith("count/")},
            "counts_end": {k: d1[k] for k in d1 if k.startswith("count/")},
            "ionizations": d1["ionizations"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitshuffle import ops as bops
    from repro_torch.kernels.deposit import ops as dops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda:0")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    build_s = _build.build_all()
    print(f"kernel build: {build_s:.2f} s")
    for src, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")

    # the main path's shapes: the paper's 2^25-slot species on 100,000
    # cells, and the codec's 1 MiB block of float32 state
    kernels = [check_deposit(torch, dev, 1 << 25, 100_000)]
    kernels += check_bitshuffle(torch, dev, 1 << 20, 4)
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms (device {k['device_ms']}, "
              f"plain {k['plain_ms']:.4f}, "
              f"yardstick {k['library_ms']:.4f}, bound {k['bound_ms']:.4f} "
              f"by {k['bound_by']}) at {k['shape']}")

    counters = {"deposit_cic": dops.deposit,
                "byte_shuffle_block": bops.shuffle_block,
                "byte_shuffle": bops.shuffle,
                "byte_unshuffle": bops.unshuffle}
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
    if launches["byte_shuffle_block"] != 2305:
        raise AssertionError(f"shuffle_block launches "
                             f"{launches['byte_shuffle_block']} != 2305")
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
    on_path = {"deposit_cic", "byte_shuffle_block"}
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["on_path"] = k["name"] in on_path
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
