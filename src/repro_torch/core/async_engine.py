"""Async double-buffered write pipeline for the JBP engine (paper §V).

The paper's throughput story is that I/O must become a *background
activity*: the PIC cycle keeps pushing/depositing while the previous step's
diagnostics are still being compressed, aggregated and appended. The sync
`BpWriter` stalls the producer for the whole of `end_step()`;
`AsyncBpWriter` splits the step into

    producer thread                      writer thread
    ---------------                      -------------
    put() ... put()
    end_step(blocking=False)
      -> _take_snapshot(copy=True)
      -> bounded in-flight queue  ---->  _write_step(snapshot):
    (compute next step overlaps)           compress -> aggregator assignment
                                           -> subfile appends -> md.0 append
                                           -> crc-sealed md.idx record

Snapshots are deep copies, so the producer may reuse its buffers the moment
`end_step` returns (the relaxation of the openPMD "unmodified until flush"
contract that makes overlap possible). The queue is bounded
(`queue_depth`, default 2): when the writer falls behind, `end_step`
BLOCKS, so at most `queue_depth` snapshots sit queued plus one being
written — the producer never runs more than `queue_depth + 1` steps ahead
of storage, which bounds peak host memory at `queue_depth + 1` step
payloads (back-pressure, like SST's reliable mode).

Ordering + durability: a single dedicated writer thread pops snapshots
FIFO, so md.0/md.idx grow in submission order and the on-disk layout is
byte-identical to a sync write of the same puts (data.* and md.0 exactly;
md.idx differs only in its wall-clock timestamp field). A step is durable
iff its crc-sealed md.idx record validates — unchanged from BpWriter.
`fsync_policy="step"` implies a BLOCKING seal: `end_step` waits until the
background fsync of md.0+md.idx has completed, so checkpoint writers keep
their crash-consistency guarantee.

The bounded-queue/drain core lives in `_PipelinedCommitter` so the
composed parallel plane (`ParallelBpWriter(async_commit=True)`) reuses the
exact same discipline in front of its two-phase commit: one committer
thread, FIFO seals, drop-after-failure, `drain()` barrier, error latching
surfaced at the next producer call.

`profiling.json` gains per-step `backlog` / `queue_wait_s` /
`queue_delay_s` fields and an `"async"` summary with the compute-overlap
fraction (what share of write time the producer did NOT spend blocked).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from repro_torch.core.bp_engine import BpWriter, EngineConfig, StepSnapshot
from repro_torch.core.dxt import TRACER


class _PipelinedCommitter:
    """Bounded snapshot queue + one committer thread — the async pipeline's
    core, engine-agnostic: `commit_fn(snapshot) -> profile` is the only
    contract (BpWriter._write_step for the thread engine, the two-phase
    ParallelBpWriter._commit_step for the process plane).

    Discipline shared by every user:
      * FIFO: one thread pops, so steps seal in submission order;
      * back-pressure: `submit` blocks once `queue_depth` snapshots queue;
      * drop-after-failure: once a step failed, later queued snapshots are
        discarded, never sealed — a gapped series must not look durable;
      * error latching: the first failure is re-raised (fresh exception,
        chained via __cause__) at the next submit/drain/check.
    """

    def __init__(self, commit_fn: Callable[[StepSnapshot], dict], *,
                 queue_depth: int = 2, name: str = "jbp-async-seal"):
        self.queue_depth = max(1, int(queue_depth))
        self._commit_fn = commit_fn
        self._q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        self._error: Optional[BaseException] = None
        self._stats_lock = threading.Lock()
        self._blocked_s = 0.0      # producer time lost to back-pressure/seals
        self._stopped = False
        self._halt = False         # interrupt path: stop committing NOW
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # -------------------------------------------------------------- producer
    def submit(self, snap: StepSnapshot, *, blocking: bool) -> dict:
        """Enqueue one snapshot; blocks on back-pressure, and (with
        `blocking`) until the step's seal completed — then returns the real
        profile. Non-blocking returns a {"queued": True} placeholder."""
        # error check AFTER the caller snapshotted: like the sync writer, a
        # failing end_step discards the step and leaves the engine ready
        # for begin_step — it must not wedge the producer protocol
        self.check_error()
        snap.extra["backlog"] = self._q.qsize()
        snap.extra["t_submit"] = time.perf_counter()
        sealed = threading.Event()
        holder: dict = {}
        t0 = time.perf_counter()
        self._q.put((snap, sealed, holder))    # blocks when queue_depth deep
        queue_wait = time.perf_counter() - t0
        if blocking:
            sealed.wait()
        blocked = (time.perf_counter() - t0) if blocking else queue_wait
        with self._stats_lock:
            self._blocked_s += blocked
        if blocking:
            self.check_error()
            return holder["prof"]
        return {"step": snap.step, "queued": True,
                "backlog": snap.extra["backlog"], "queue_wait_s": queue_wait}

    def drain(self):
        """Barrier: returns once every submitted step is committed (per the
        owning engine's fsync policy); raises a latched failure."""
        t0 = time.perf_counter()
        self._q.join()
        with self._stats_lock:
            self._blocked_s += time.perf_counter() - t0
        self.check_error()

    def shutdown(self):
        """Drain WITHOUT raising, then stop the committer thread — the
        engine's close() calls this first so teardown always completes;
        it checks the latched error itself once handles are released.
        The stop half runs even when the drain is INTERRUPTED
        (KeyboardInterrupt escaping the queue join): the owning engine is
        about to close the md handles, so the thread must be dead — or at
        least halted — before that, never left sealing underneath them."""
        if self._stopped:
            return
        t0 = time.perf_counter()
        try:
            self._q.join()         # like drain(), but never raises early
        finally:
            with self._stats_lock:
                self._blocked_s += time.perf_counter() - t0
            self._stopped = True
            self._halt = True      # belt for the interrupted-drain path
            try:
                self._q.put_nowait(None)   # empty after a clean join
            except queue.Full:
                pass               # interrupted: _halt is the wake-up
            self._thread.join(timeout=10.0)

    @property
    def blocked_s(self) -> float:
        with self._stats_lock:
            return self._blocked_s

    # --------------------------------------------------------------- thread
    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            snap, sealed, holder = item
            try:
                # after a failed step, later queued snapshots are DROPPED,
                # not written: sealing step N+1 when step N is missing would
                # present a gapped series as durable — a sync writer raises
                # at N and never reaches N+1, and async must match. A halted
                # committer (interrupted shutdown) drops for the same reason.
                if self._error is None and not self._halt:
                    snap.extra["queue_delay_s"] = (time.perf_counter() -
                                                   snap.extra.pop("t_submit"))
                    with TRACER.span("pipeline", path=f"step.{snap.step}"):
                        holder["prof"] = self._commit_fn(snap)
            except BaseException as e:     # noqa: BLE001 — surfaced to producer
                self._error = e            # first failure is the root cause
            finally:
                sealed.set()
                self._q.task_done()
                if self._halt:
                    return         # owner is tearing the engine down NOW

    def check_error(self):
        """Surface a background commit failure to the producer. Each call
        raises a FRESH exception chained to the original via __cause__ —
        re-raising the stored object itself would accrete a new traceback
        per call site (end_step, drain, close all check) and misreport
        where the failure happened."""
        err = self._error
        if err is None:
            return
        try:
            fresh = type(err)(*err.args)
        except Exception:                      # noqa: BLE001 — odd signature
            fresh = RuntimeError(f"async writer failed: {err!r}")
        raise fresh from err

    def stats_doc(self) -> dict:
        """The profiling.json "async" block, minus the engine-side totals."""
        return {"queue_depth": self.queue_depth,
                "producer_blocked_s": self.blocked_s}

    def profile_block(self, profile_steps) -> dict:
        """The full profiling.json "async" block for an engine whose
        per-step profiles are `profile_steps` — overlap accounting lives
        HERE so both engines report the same formula (overlap = share of
        commit time the producer did NOT spend blocked)."""
        write_s = sum(p.get("write_s", 0.0) for p in profile_steps)
        blocked = self.blocked_s
        overlap = max(0.0, 1.0 - blocked / write_s) if write_s > 0 else 0.0
        return dict(self.stats_doc(), write_s=write_s,
                    overlap_fraction=overlap)


class AsyncBpWriter(BpWriter):
    """Drop-in BpWriter with a background write pipeline.

    end_step(blocking=False) -> snapshot + enqueue, returns a placeholder
                                profile ({"queued": True, ...}).
    end_step(blocking=True)  -> waits for the step's seal; returns the real
                                profile (forced when fsync_policy="step").
    drain()                  -> barrier: every queued step sealed on disk.
    close()                  -> drain, stop the writer thread, then the
                                normal BpWriter close (fsync + profiling).
    """

    def __init__(self, path, n_ranks: int, cfg: EngineConfig = EngineConfig(),
                 *, queue_depth: int = 2):
        super().__init__(path, n_ranks, cfg)
        self._committer = _PipelinedCommitter(self._write_step,
                                              queue_depth=queue_depth)
        self.queue_depth = self._committer.queue_depth
        self._closed = False

    # -------------------------------------------------------------- producer
    def end_step(self, blocking: bool = False) -> dict:
        if self.cfg.fsync_policy == "step":
            blocking = True            # durable seal must precede the return
        # a blocking end_step holds the producer until the write completes,
        # so the chunk views stay valid — skip the deep copy (checkpoints
        # of model-sized state must not double peak host memory)
        snap = self._take_snapshot(copy=not blocking)
        return self._committer.submit(snap, blocking=blocking)

    def drain(self):
        """Barrier: returns once every submitted step is written AND sealed
        (its md.idx record on disk per the engine's fsync policy)."""
        self._committer.drain()

    def close(self):
        """Drain, stop the writer thread, then the normal BpWriter close.
        A failed background write must NOT leak the thread or the md.0/
        md.idx handles: shutdown always completes, the error is raised
        once at the end (subsequent close() calls are no-ops)."""
        if self._closed:
            return
        try:
            self._committer.shutdown()
        finally:
            self._closed = True
            super().close()
        self._committer.check_error()

    # ------------------------------------------------- committer pass-throughs
    @property
    def _writer_error(self) -> Optional[BaseException]:
        return self._committer._error

    @property
    def _writer_thread(self) -> threading.Thread:
        return self._committer._thread

    def _check_error(self):
        self._committer.check_error()

    # -------------------------------------------------------------- profiling
    def _profile_doc(self) -> dict:
        doc = super()._profile_doc()
        doc["async"] = self._committer.profile_block(self._profile)
        return doc

    def overlap_stats(self) -> dict:
        """Live view of the compute/I-O overlap accounting."""
        return dict(self._profile_doc()["async"], steps=len(self._profile))
