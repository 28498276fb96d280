"""CheckpointManager: async double-buffered writes, retention, auto-restart.

The port's copy of the JAX package's manager. Fault-tolerance contract:
  * the producer never blocks on storage — save() snapshots the state and
    hands it to a writer thread; the checkpoint write (through the JBP
    async pipeline when `engine_async`, or W writer processes with
    `parallel_io`) then OVERLAPS the next steps, and `wait()` is the
    barrier that re-serialises producer and writer,
  * a checkpoint becomes visible only after its atomic rename; a crash
    mid-write leaves a .tmp the next run ignores,
  * restore_latest() walks checkpoints newest-first and returns the first
    one whose md.idx validates (torn/corrupt ones are skipped),
  * keep_n retention runs behind the durability barrier: old checkpoints
    are evicted only AFTER the newer one's sealed md.idx + rename.

The snapshot differs from the JAX package's, whose device arrays are
immutable and are handed to the writer as they are: a tensor is mutable,
so save() copies every tensor leaf before it returns — with
`device_compress` by `clone()` on its own device (the writer then
shuffles the copy there), else to host.
"""
from __future__ import annotations

import pathlib
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as CK
from repro_torch.core.bp_engine import EngineConfig


class CheckpointManager:
    def __init__(self, directory, *, every: int = 100, keep_n: int = 3,
                 n_io_ranks: int = 8,
                 engine_config: EngineConfig = EngineConfig(),
                 async_write: bool = True, engine_async: bool = False,
                 parallel_io: int = 0, transport: str = "shm",
                 device_compress: bool = False):
        # async_write is what hides checkpoint I/O behind the next steps
        # (the writer thread). engine_async additionally routes the write
        # through AsyncBpWriter — correctness-neutral (checkpoints force
        # fsync_policy="step", a blocking seal); off by default.
        # parallel_io=W routes the write through W real writer processes
        # instead (repro_torch.core.parallel_engine) — compression and
        # subfile appends leave this process entirely; takes precedence
        # over engine_async. The W processes are a PERSISTENT WriterPlane:
        # spawned lazily on the first save and retargeted per checkpoint,
        # so the spawn cost is paid once per run; with transport="shm"
        # (default) the plane's per-worker shared-memory rings stay mapped
        # across saves too. `close()` tears the plane down and unlinks the
        # rings (a finalizer covers abnormal exits).
        # device_compress=True keeps tensor leaves on their device at
        # save(): each is cloned there, and save_checkpoint byte-shuffles
        # the clone on the device before the writer handoff (workers then
        # skip the shuffle).
        self.dir = pathlib.Path(str(directory))
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = every
        self.keep_n = keep_n
        self.n_io_ranks = n_io_ranks
        self.engine_config = engine_config
        self.async_write = async_write
        self.engine_async = engine_async
        self.parallel_io = int(parallel_io)
        self.transport = transport
        self.device_compress = bool(device_compress)
        self._plane = None                       # lazy persistent write plane
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: list[int] = []
        # overlap accounting: how long save()/wait() actually stalled the
        # producer vs how long the background writes took
        self.stats = {"saves": 0, "blocked_s": 0.0, "write_s": 0.0}

    # ----------------------------------------------------------------- save
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def wait(self):
        """Barrier: the in-flight checkpoint (if any) is durable on return.
        Must run before eviction and before the manager is torn down."""
        t0 = time.perf_counter()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self.stats["blocked_s"] += time.perf_counter() - t0
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def overlap_fraction(self) -> float:
        """Share of checkpoint write time hidden behind the producer."""
        w = self.stats["write_s"]
        return max(0.0, 1.0 - self.stats["blocked_s"] / w) if w > 0 else 0.0

    def _writer_plane(self):
        """The persistent parallel write plane, spawned on first use and
        respawned if its workers died (e.g. a prior save crashed them)."""
        if not self.parallel_io:
            return None
        if self._plane is not None and not self._plane.alive():
            self._plane.shutdown()
            self._plane = None
        if self._plane is None:
            from repro_torch.core.parallel_engine import WriterPlane
            self._plane = WriterPlane(self.parallel_io,
                                      transport=self.transport)
        return self._plane

    def _snapshot(self, state):
        """A copy of `state` the producer cannot change, and the CUDA
        streams that made its device copies with an event recorded on each
        after them: [(stream, event)]."""
        streams = {}

        def snap(x):
            if isinstance(x, CK.Stacked):
                return x.map(snap)
            if isinstance(x, torch.Tensor):
                x = x.detach()
                if self.device_compress:
                    if x.is_cuda and x.device not in streams:
                        streams[x.device] = torch.cuda.current_stream(x.device)
                    return x.clone()                 # stays on its device
                return CK._host_leaf(x if x.is_cuda else x.clone())
            return np.array(x) if isinstance(x, np.ndarray) else x

        copy = CK.unflatten_like(state, {k: snap(v) for k, v in
                                         CK.flatten_state(state).items()})
        marks = []
        for stream in streams.values():
            ev = torch.cuda.Event()
            ev.record(stream)
            marks.append((stream, ev))
        return copy, marks

    def save(self, state, step: int, *, force: bool = False):
        if not force and not self.should_save(step):
            return False
        self.wait()                                  # one write in flight max
        snapshot, marks = self._snapshot(state)

        def job():
            try:
                t0 = time.perf_counter()
                # the writer's reads of the clones follow the clones, on
                # whatever stream this thread launches on
                for stream, ev in marks:
                    torch.cuda.current_stream(stream.device).wait_event(ev)
                CK.save_checkpoint(self.dir, snapshot, step,
                                   n_io_ranks=self.n_io_ranks,
                                   engine_config=self.engine_config,
                                   async_io=(self.engine_async
                                             and not self.parallel_io),
                                   parallel_io=self.parallel_io,
                                   writer_plane=self._writer_plane(),
                                   device_compress=self.device_compress)
                self.stats["write_s"] += time.perf_counter() - t0
                self.saved_steps.append(step)
                # durability barrier passed (sealed md.idx + rename above):
                # only now may older checkpoints be evicted
                self._retain()
            except BaseException as e:               # noqa: BLE001
                self._error = e

        self.stats["saves"] += 1
        if self.async_write:
            self._thread = threading.Thread(target=job, daemon=True)
            self._thread.start()
        else:
            t0 = time.perf_counter()
            job()                    # inline write: all of it blocks
            self.stats["blocked_s"] += time.perf_counter() - t0
        return True

    def _retain(self):
        steps = CK.list_checkpoints(self.dir)
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(CK.checkpoint_path(self.dir, s), ignore_errors=True)
        for tmp in self.dir.glob("*.bp4.tmp"):       # torn writes
            shutil.rmtree(tmp, ignore_errors=True)

    def close(self):
        """Drain the in-flight save and tear down the persistent writer
        plane (if any). The manager stays usable — a later save respawns
        the plane lazily."""
        try:
            self.wait()
        finally:
            plane, self._plane = self._plane, None
            if plane is not None:
                plane.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -------------------------------------------------------------- restore
    def restore_latest(self, like, shardings=None, *, parallel: int = 0):
        """Newest valid checkpoint as (state, step), or None if there is
        none. `parallel=N` fans each leaf's chunk reads over a ReaderPool.
        A restore onto a device mesh (`shardings`) needs the port's mesh
        layer (ROADMAP.md Queue 1, item 7) and raises until it exists."""
        if shardings is not None:
            raise NotImplementedError(
                "restore_latest(shardings=...) restores onto a device mesh, "
                "which needs the port's mesh layer on torch.distributed and "
                "DTensor (ROADMAP.md Queue 1, item 7); call it without "
                "shardings for a full restore")
        self.wait()
        steps = CK.list_checkpoints(self.dir)
        for step in reversed(steps):
            try:
                return CK.restore_checkpoint(self.dir, like, step=step,
                                             parallel=parallel)
            except Exception:                        # noqa: BLE001
                continue
        return None
