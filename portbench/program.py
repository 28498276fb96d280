"""The system under test, as the benchmark drives it: the port's PIC
step, diagnostics and diagnostics series (`Program`), and its two ways
to checkpoint (`InProcess`, `Plane`). Every call goes to the port's
public entry points; the benchmark adds spans and clocks around them,
and holds references to the states it will judge (a step makes new
tensors, so holding one copies nothing).

`Control` is the reference put in the program's place in bfloat16, the
control of the comparison that decides `correct`."""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import torch


class Program:
    def __init__(self, config: dict, device):
        from repro_torch.pic import simulation as sim
        self.sim = sim
        self.device = torch.device(device)
        keys = {f.name for f in dataclasses.fields(sim.PicConfig)}
        self.cfg = sim.PicConfig(**{k: v for k, v in config.items()
                                    if k in keys})
        self.diag_io = config["io"]["diagnostics"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def init(self, seed: int):
        return self.sim.init_sim(self.cfg, seed, device=self.device)

    def run_chunk(self, state, n: int):
        """`n` steps through `pic_run_chunk`."""
        return self.sim.pic_run_chunk(state, self.cfg, n) if n else state

    def diagnostics(self, state) -> dict:
        return self.sim.diagnostics(state, self.cfg,
                                    v_bins=self.diag_io["v_bins"])

    def open_series(self, path):
        from repro_torch.core import EngineConfig, Series
        d = self.diag_io
        return Series(path, "w", n_ranks=d["n_io_ranks"],
                      engine_config=EngineConfig(aggregators=d["aggregators"],
                                                 codec=d["codec"],
                                                 workers=d["workers"]))

    def write_diagnostics(self, series, state, diag):
        self.sim.write_diagnostics_openpmd(
            series, state, self.cfg, n_io_ranks=self.diag_io["n_io_ranks"],
            diag=diag)
        series.flush()


class Control(Program):
    """The plain reference in bfloat16 in the program's place: its
    initial state, steps and diagnostics, handed on as the program's
    state type so the I/O path runs as in a run."""

    def __init__(self, config: dict, device, dtype=torch.bfloat16):
        super().__init__(config, device)
        self.config, self.dtype = config, dtype

    def _state(self, d: dict):
        sim = self.sim
        from repro_torch.pic.particles import Species
        sp = {name: Species(d[k]["x"], d[k]["v"], d[k]["w"], d[k]["alive"],
                            q, m)
              for name, k, q, m in (("e", "e", -1.0, 1.0),
                                    ("i", "D_plus", 1.0, 1836.0),
                                    ("n", "D", 0.0, 1836.0))}
        z = torch.zeros((), dtype=torch.float32, device=self.device)
        return sim.PicState(sp["e"], sp["i"], sp["n"], d["key"],
                            torch.tensor(d["step"], dtype=torch.int32,
                                         device=self.device), z, z,
                            torch.tensor(d["ionizations"],
                                         dtype=torch.float32,
                                         device=self.device))

    def init(self, seed: int):
        from portbench.reference import pic
        d = pic.init_state(self.config, seed, self.device, self.dtype)
        for sp in pic.SPECIES:
            d[sp] = {f: v.float() for f, v in d[sp].items()}
        return self._state(d)

    def run_chunk(self, state, n: int):
        from portbench.check import to_ref
        from portbench.reference import pic
        if not n:
            return state
        d = to_ref(state)
        for _ in range(n):
            d, _ = pic.step(d, self.config, dtype=self.dtype)
        return self._state(d)

    def diagnostics(self, state) -> dict:
        from portbench.check import to_ref
        from portbench.reference import pic
        out = pic.diagnostics(to_ref(state), self.config,
                              v_bins=self.diag_io["v_bins"], dtype=self.dtype)
        for name, sp in (("e", state.electrons), ("D_plus", state.ions),
                         ("D", state.neutrals)):
            out[f"count/{name}"] = float(sp.alive.sum())
        out["ionizations"] = float(state.total_ionizations)
        return out


class Commits:
    """When each checkpoint committed: the return of `save_checkpoint`,
    in whatever thread ran it (the manager's writer thread for the
    plane), by step."""

    def __init__(self):
        from repro_torch.ckpt import checkpoint as CK
        self.CK, self._save = CK, CK.save_checkpoint
        self.at: dict[int, float] = {}

        def timed(directory, state, step, **kw):
            out = self._save(directory, state, step, **kw)
            self.at[step] = time.perf_counter()
            return out

        CK.save_checkpoint = timed

    def close(self):
        self.CK.save_checkpoint = self._save


class InProcess:
    """`save_checkpoint(..., device_compress=True)` in this process."""

    def __init__(self, ckpt: dict, directory: pathlib.Path):
        from repro_torch.ckpt import checkpoint as CK
        from repro_torch.core import EngineConfig
        self.CK, self.dir = CK, directory
        self.kw = dict(n_io_ranks=ckpt["n_io_ranks"],
                       engine_config=EngineConfig(
                           aggregators=ckpt["aggregators"],
                           codec=ckpt["codec"], workers=ckpt["workers"]),
                       device_compress=ckpt["device_compress"])
        self.writers = ckpt["workers"]

    def save(self, state, step: int):
        self.CK.save_checkpoint(self.dir, state._asdict(), step, **self.kw)

    def wait(self):
        pass

    def restore(self, like):
        return self.CK.restore_checkpoint(self.dir, like)

    def engine_step(self, step: int) -> dict:
        """The engine's profile of the checkpoint's one step (its write,
        compress and, for the plane, each writer's seconds)."""
        doc = json.loads((self.CK.checkpoint_path(self.dir, step)
                          / "profiling.json").read_text())
        return {k: v for k, v in doc["steps"][-1].items()
                if isinstance(v, (int, float, dict))}

    def close(self):
        pass


class Plane(InProcess):
    """`CheckpointManager(parallel_io=W, async_write=...)`: the save
    returns after its snapshot, the write goes through W writer
    processes, spawned here (set-up)."""

    def __init__(self, ckpt: dict, directory: pathlib.Path):
        super().__init__(ckpt, directory)
        from repro_torch.ckpt.manager import CheckpointManager
        self.mgr = CheckpointManager(
            directory, keep_n=ckpt["keep_n"], n_io_ranks=ckpt["n_io_ranks"],
            engine_config=self.kw["engine_config"],
            async_write=ckpt["async_write"], parallel_io=ckpt["parallel_io"],
            transport=ckpt["transport"],
            device_compress=ckpt["device_compress"])
        self.mgr._writer_plane()
        self.writers = ckpt["parallel_io"]

    def save(self, state, step: int):
        self.mgr.save(state._asdict(), step, force=True)

    def wait(self):
        self.mgr.wait()

    def restore(self, like):
        return self.mgr.restore_latest(like)

    def close(self):
        self.mgr.close()


CHECKPOINTERS = {"in_process": InProcess, "plane": Plane}
