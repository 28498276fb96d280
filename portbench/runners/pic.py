"""The PIC runner (`"runner": "pic"`): one run of a cell of BIT1's case,
set-up, the measured window, the restore, the check, and the result
line's content, to `runners/__init__.py`'s contract.

The window runs whole periods of the cell's mix: each period is
`diags_per_period` chunks of `steps_per_diag` PIC steps, each chunk
followed by a diagnostics write, and, where the mix checkpoints, one
checkpoint at the period's end. It starts no period once `seconds` have
passed and at least two have run, and ends when the last checkpoint has
committed. With tracing on, the profiler covers one whole period of the
steady cycle: from the first checkpoint's save to the end of the next
period's chunks and that checkpoint's commit (or, without checkpoints,
the second period)."""
from __future__ import annotations

import gc
import json
import os
import pathlib
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import check, counts, trace
from portbench.program import CHECKPOINTERS, Commits, Control, Program

#: what `control.py` takes from a runner: the program, its control (the
#: plain reference in bfloat16 in the program's place), and `run`
__all__ = ["Control", "Program", "run"]

SHM = pathlib.Path("/dev/shm")
#: chunks the check follows, drawn from the seed
SAMPLES = 3


def _shm_entries() -> set:
    try:
        return set(os.listdir(SHM))
    except OSError:
        return set()


class Held:
    """What the check judges, held by reference: the initial state; of
    `SAMPLES` chunks drawn from the seed (reservoir sampling over the
    chunks after the first, whose start a diagnostics write saw), the
    states at the chunk's start, before and after one of its steps (drawn
    from the seed), and at its end; the key and step counter at every
    chunk's end; every diagnostics snapshot handed to the writer; and the
    state of every checkpoint."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed & 0xFFFFFFFFFFFFFFFF)
        self.init = None
        self.samples: list = []
        self.seen = 0
        self.ends: list = []
        self.diags: dict[int, dict] = {}
        self.ckpts: dict = {}

    def draw(self, n: int):
        """(slot, k): the slot of `samples` the next chunk of `n` steps
        goes to, or None, and the step of it that is held."""
        k = int(self.rng.integers(n))
        self.seen += 1
        if len(self.samples) < SAMPLES:
            self.samples.append(None)
            return len(self.samples) - 1, k
        j = int(self.rng.integers(self.seen))
        return (j if j < SAMPLES else None), k

    def sampled(self) -> dict:
        return {int(start.step): start for start, *_ in self.samples}


def _darshan(name: str, prefix=None) -> float:
    from repro_torch.core.darshan import MONITOR
    rep = MONITOR.report()
    if prefix is None:
        return rep["total"].get(name, 0.0)
    return sum(c.get(name, 0.0) for p, c in rep["files"].items()
               if prefix in p)


def run(plan, seed: int, seconds: float, traced: bool, *, device="cuda",
        program=Program, process_start=None) -> dict:
    """The result's `correct`, `attempted`, `failed` and `checks`, the
    device's memory peak, the run's record for the metric readers
    (`record`), and the lines `run.py` prints before the result
    (`summary`)."""
    t0 = time.perf_counter() if process_start is None else process_start
    cfg, mix = plan.config, plan.mix
    shm0 = _shm_entries()
    work = pathlib.Path(tempfile.mkdtemp(prefix="portbench-"))
    prog = program(cfg, device)
    commits = Commits()
    ckpt = None
    try:
        # ------------------------------------------------------ set-up
        ck_cfg = cfg["io"]["checkpoint"] if mix["checkpoint"] else None
        if ck_cfg is not None:
            ckpt = CHECKPOINTERS[ck_cfg["path"]](ck_cfg, work / "ckpt")
        _warm(prog, ckpt, seed, work / "warm")
        state = prog.init(seed)
        series_path = work / "diag.bp4"
        series = prog.open_series(series_path)
        prog.sync()
        setup_s = time.perf_counter() - t0

        # ------------------------------------------------------ window
        held = Held(seed)
        held.init = state
        spans = trace.Spans()
        prof = None
        rec = {"checkpoints": [], "spans": spans.items}
        step = 0
        periods = 0
        per = mix["diags_per_period"]
        n = mix["steps_per_diag"]
        while True:
            if traced and periods == 1 and ckpt is None:
                prof = trace.profile_start()
            for _ in range(per):
                slot, k = held.draw(n) if step else (None, 0)
                with spans("pic.steps"):
                    if slot is None:
                        state = prog.run_chunk(state, n)
                    else:
                        # the held step through the same entry, between
                        # the chunk's steps before and after it
                        start = state
                        before = prog.run_chunk(start, k)
                        after = prog.run_chunk(before, 1)
                        state = prog.run_chunk(after, n - k - 1)
                        held.samples[slot] = (start, before, after, state)
                    prog.sync()
                held.ends.append((state.key, state.step))
                step += n
                with spans("diag.write"):
                    diag = prog.diagnostics(state)
                    prog.write_diagnostics(series, state, diag)
                held.diags[step] = diag
            if traced and periods == 1:
                if ckpt is not None:
                    with spans("ckpt.wait"):
                        ckpt.wait()
                trace.profile_stop(prof)
            if ckpt is not None:
                if traced and periods == 0:
                    prof = trace.profile_start()
                held.ckpts[step] = state
                t_call = time.perf_counter()
                with spans("ckpt.save"):
                    ckpt.save(state, step)
                rec["checkpoints"].append({"step": step, "t_call": t_call})
            periods += 1
            if periods >= 2 and spans.now() >= seconds:
                break
        with spans("ckpt.wait"):
            if ckpt is not None:
                ckpt.wait()
            series.close()
            prog.sync()
        window_s = spans.now()
        held.samples = [x for x in held.samples if x is not None]

        # ------------------------------------------------------ restore
        restored = None
        if ckpt is not None:
            newest = max(held.ckpts)
            like = held.ckpts[newest]._asdict()
            read0 = _darshan("F_READ_TIME")
            t_restore = time.perf_counter()
            restored = ckpt.restore(like)
            prog.sync()
            rec["restore"] = {"s": time.perf_counter() - t_restore,
                              "read_time": _darshan("F_READ_TIME") - read0}
        peak = (torch.cuda.max_memory_allocated()
                if prog.device.type == "cuda" else 0)

        prev = float("-inf")
        for c in rec["checkpoints"]:
            # a save waits for the previous one's commit before its own
            # write starts
            c["t_start"] = max(c["t_call"], prev)
            c["t_commit"] = prev = commits.at.get(c["step"], float("nan"))
            c["bytes"] = counts.checkpoint_bytes(prog.cfg.capacity)
            c["write_time"] = _darshan("F_WRITE_TIME",
                                       f"step_{c['step']:08d}.bp4")
            c["writers"] = ckpt.writers
            c["engine"] = ckpt.engine_step(c["step"])
        rec.update(setup_s=setup_s, window_s=window_s, steps=step,
                   periods=periods, capacity=prog.cfg.capacity,
                   n_cells=prog.cfg.n_cells)
        if prof is not None:
            rec["traced"] = _traced(prof, held.diags, n * per, work)

        # ------------------------------------------------------ check
        t_check = time.perf_counter()
        numbers = {"init_gap": check.init_gap(cfg, seed, held.init)}
        numbers["step_gap"], numbers["bad_events"] = check.step_numbers(
            cfg, [(b, a) for _, b, a, _ in held.samples])
        numbers["flight_gap"] = check.flight_gap(cfg, held.samples)
        numbers["schedule_bad"] = check.schedule_bad(held.init, held.ends, n)
        numbers.update(check.diag_numbers(
            cfg, series_path, held.diags, held.sampled(),
            {"heavy": cfg["n_neutrals"] + cfg["n_ions"],
             "charge": cfg["n_electrons"] - cfg["n_ions"]}))
        if ckpt is not None:
            numbers["ckpt_bad"] = check.ckpt_bad(work / "ckpt", held.ckpts,
                                                 seed)
            numbers["restore_bad"] = check.restore_bad(
                restored, newest, held.ckpts[newest])
        rec["check_s"] = time.perf_counter() - t_check
        attempted = (step // n + len(held.diags) + len(held.ckpts)
                     + (ckpt is not None))
        failed = (numbers["diag_readback"] + numbers.get("ckpt_bad", 0)
                  + numbers.get("restore_bad", 0))
        del held, state, restored
    finally:
        commits.close()
        if ckpt is not None:
            ckpt.close()
        # drop the write plane's queues, and their semaphores in /dev/shm,
        # before the check that none is left
        ckpt = None
        gc.collect()
        shutil.rmtree(work, ignore_errors=True)
    rec["bytes_written"] = _darshan("POSIX_BYTES_WRITTEN")
    numbers["shm_left"] = len(_shm_entries() - shm0)
    _stop_resource_tracker()
    checks = check.judged(numbers)
    return {"correct": check.correct(checks), "attempted": attempted,
            "failed": failed, "peak": peak, "record": rec, "checks": checks,
            "summary": _summary(rec)}


def _summary(rec: dict) -> list:
    """The window's periods, steps and times, and each checkpoint's."""
    out = [f"portbench: {rec['periods']} periods, {rec['steps']} steps in "
           f"{rec['window_s']:.3f} s; set-up {rec['setup_s']:.3f} s; check "
           f"{rec['check_s']:.3f} s; POSIX_BYTES_WRITTEN "
           f"{rec['bytes_written']:.0f}"]
    for c in rec["checkpoints"]:
        e = c["engine"]
        out.append(f"portbench: checkpoint {c['step']}: "
                   f"{c['t_commit'] - c['t_start']:.3f} s to commit; engine "
                   f"write {e.get('write_s', 0):.3f} s, compress "
                   f"{e.get('compress_s', 0):.3f} s, writers "
                   f"{json.dumps(e.get('worker_s'))}")
    return out


def _warm(prog, ckpt, seed: int, work: pathlib.Path):
    """A step and a diagnostics write at the cell's shapes, and a
    checkpoint saved and restored at a small size, so that every kernel
    is built and loaded and every path has run once before the window."""
    import dataclasses
    work.mkdir(parents=True)
    state = prog.run_chunk(prog.init(seed), 1)
    series = prog.open_series(work / "diag.bp4")
    prog.write_diagnostics(series, state, prog.diagnostics(state))
    series.close()
    if ckpt is not None:
        small = dataclasses.replace(prog.cfg, capacity=1 << 16,
                                    n_electrons=1 << 14, n_ions=1 << 14,
                                    n_neutrals=1 << 14)
        tiny = prog.sim.init_sim(small, seed, device=prog.device)
        ckpt.save(tiny, 0)
        ckpt.wait()
        ckpt.restore(tiny._asdict())
        shutil.rmtree(ckpt.CK.checkpoint_path(ckpt.dir, 0))
    prog.sync()
    shutil.rmtree(work)


def _traced(prof, diags: dict, steps: int, work: pathlib.Path) -> dict:
    """The traced window's device work and spans, and what the counts of
    its steps need: the live particles of each species at its start and
    the ionizations a step in it."""
    out = trace.reduced(prof, work)
    at = sorted(diags)
    start = at[at.index(steps) if steps in at else 0]
    end = start + steps
    out["steps"] = steps
    out["live"] = {k: diags[start][f"count/{k}"] for k in ("e", "D_plus", "D")}
    if end in diags:
        out["events_per_step"] = (diags[end]["ionizations"]
                                  - diags[start]["ionizations"]) / steps
    return out


def _stop_resource_tracker():
    """Ends multiprocessing's resource tracker, if the write plane started
    it, and waits for it."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()
