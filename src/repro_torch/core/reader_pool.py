"""ReaderPool — the read-side mirror of the work-stealing writer pool.

`BpReader.read_var` assembles a box selection chunk by chunk: payload read,
decompress, scatter into the output array. Serially that is bounded by one
core even though (a) the payload reads hit M independent subfiles and (b)
zlib/bz2 release the GIL while decompressing. The pool fans the per-chunk
work out over worker threads with PER-AGGREGATOR AFFINITY:

  * `submit(affinity, fn, *args)` routes a task to worker `affinity % N`,
    so one subfile's chunks land on one worker — its cached file handle is
    reused and the reads stay sequential within the subfile (the access
    pattern aggregation exists to create is preserved on the read side),
  * an idle worker STEALS from the longest other queue (back-of-deque, the
    opposite end from the owner), so a straggler aggregator — a big
    compressed chunk, a slow OST behind a striped subfile — is absorbed by
    the rest of the pool exactly like the writer pool absorbs slow
    aggregators,
  * a failing task never kills its worker: the first error is recorded and
    re-raised from the barrier (the WriterPool lesson, applied to reads).

One pool may serve CONCURRENT read_var calls (restore_sharded fetch
callbacks run on several threads): each call submits its tasks under a
`ReadBatch`, and `drain_batch` waits on — and raises errors of — that
batch alone, so one caller's failed chunk can never surface in another
caller's read (or worse, vanish while the victim returns zero-filled
data). The pool also GROWS in place (`ensure`) instead of being torn down
and recreated, so a caller holding a reference mid-read never races a
shutdown.

Handle affinity is the reader's side of the contract: `BpReader` keeps one
payload handle per (worker thread, aggregator), so no lock is ever taken
around seek+read — affinity makes the common case one handle per subfile,
and stealing at worst opens one extra handle on the stealing thread.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS


class ReadBatch:
    """Completion tracker for one caller's group of tasks: its own
    outstanding count and its own first-error slot."""

    def __init__(self):
        self.outstanding = 0
        self.error: Optional[BaseException] = None


class ReaderPool:
    """Affinity-scheduled, work-stealing thread pool for chunk reads."""

    def __init__(self, n_workers: int):
        self._cond = threading.Condition()
        self._queues: list[deque] = []
        self._outstanding = 0                 # submitted, not yet finished
        self._stop = False
        self._error: Optional[BaseException] = None   # batch-less tasks
        self._threads: list[threading.Thread] = []
        # worker wake-ups since construction. Waits are purely
        # notification-driven (submit/finish/stop notify; NO wait timeout),
        # so an idle pool must show ZERO wakeups — a daemon hosting a
        # resident pool sits at 0% CPU between requests. The counter is the
        # observable that keeps it that way (tests assert on it).
        self.wakeups = 0
        self.ensure(max(1, int(n_workers)))

    @property
    def n_workers(self) -> int:
        return len(self._threads)

    def ensure(self, n_workers: int):
        """Grow the pool to at least `n_workers` threads, in place — never
        torn down and recreated, so concurrent callers holding a reference
        cannot race a shutdown."""
        with self._cond:
            if self._stop:
                raise RuntimeError("ReaderPool is shut down")
            while len(self._threads) < n_workers:
                i = len(self._threads)
                self._queues.append(deque())
                t = threading.Thread(target=self._worker, args=(i,),
                                     name=f"jbp-reader-{i}", daemon=True)
                self._threads.append(t)
                t.start()

    # ------------------------------------------------------------- scheduling
    def batch(self) -> ReadBatch:
        return ReadBatch()

    def submit(self, affinity: int, fn: Callable, *args,
               batch: Optional[ReadBatch] = None):
        """Queue one task on the worker owning `affinity` (e.g. the chunk's
        aggregator id) — same affinity, same worker, same cached handle.
        With `batch`, completion and errors are tracked per batch."""
        with self._cond:
            if self._stop:
                raise RuntimeError("ReaderPool is shut down")
            self._queues[affinity % len(self._queues)].append(
                (fn, args, batch))
            self._outstanding += 1
            if batch is not None:
                batch.outstanding += 1
            self._cond.notify_all()

    def _take(self, i: int):
        """Own queue first (front); else steal the tail of the longest other
        queue — stolen work is the work least likely to be reached soon by
        its owner."""
        q = self._queues[i]
        if q:
            return q.popleft()
        victim = max((v for v in self._queues if v), key=len, default=None)
        if victim is not None:
            return victim.pop()
        return None

    def _worker(self, i: int):
        while True:
            with self._cond:
                task = self._take(i)
                while task is None and not self._stop:
                    self._cond.wait()         # notification-driven: no spin
                    self.wakeups += 1
                    task = self._take(i)
                if task is None:              # stopped and drained
                    return
            fn, args, batch = task
            try:
                with TRACER.span("read_task", rank=i), \
                        METRICS.timer("read_task", key=f"w{i}"):
                    fn(*args)
            except BaseException as e:        # noqa: BLE001 — raised at barrier
                with self._cond:
                    if batch is not None:
                        if batch.error is None:
                            batch.error = e
                    elif self._error is None:  # first failure = root cause
                        self._error = e
            finally:
                with self._cond:
                    self._outstanding -= 1
                    if batch is not None:
                        batch.outstanding -= 1
                    self._cond.notify_all()

    # --------------------------------------------------------------- barriers
    def drain_batch(self, batch: ReadBatch):
        """Barrier for ONE caller's tasks; raises that batch's first error
        (another caller's failures are invisible here, and vice versa)."""
        with self._cond:
            while batch.outstanding:
                self._cond.wait()
            err, batch.error = batch.error, None
        if err is not None:
            raise err

    def drain(self):
        """Global barrier: every submitted task has run. Raises the first
        BATCH-LESS task error recorded since the last drain (the pool stays
        usable)."""
        with self._cond:
            while self._outstanding:
                self._cond.wait()
            err, self._error = self._error, None
        if err is not None:
            raise err

    def shutdown(self):
        try:
            self.drain()
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            for t in self._threads:
                t.join(timeout=2.0)
