"""Two-level write aggregation (paper §IV-C).

N writer ranks are assigned to M aggregators (`OPENPMD_ADIOS2_BP5_NumAgg`
analogue). Each aggregator owns one `data.<m>` subfile; its ranks' chunk
payloads are concatenated into that subfile. A work-stealing thread pool
drains the aggregator queues — slow aggregators (straggler OSTs, big
payloads) are absorbed by idle workers, which is the straggler-mitigation
story for 1000+-node deployments (DESIGN.md §6).

Multi-process write plane (repro_torch.core.parallel_engine): each writer
PROCESS constructs a `SubfileSet` that owns only its aggregator ids
(`owned=`), so W processes share one BP directory without ever opening
each other's subfiles — per-process subfile ownership is what makes the
parallel plane free of cross-process write coordination.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, Optional

from repro_torch.core.darshan import open_file
from repro_torch.core.striping import OstPool, StripeConfig, StripedFile


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    num_aggregators: int = 1
    num_workers: int = 4                      # writer threads (work-stealing)
    stripe: Optional[StripeConfig] = None     # stripe each subfile if set


def aggregator_of(rank: int, n_ranks: int, m: int) -> int:
    """Contiguous block assignment: rank -> aggregator (ADIOS2 default)."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    if not 0 <= rank < n_ranks:
        raise ValueError(
            f"rank {rank} out of range for n_ranks={n_ranks} "
            f"(valid ranks are 0..{n_ranks - 1})")
    m = min(m, n_ranks)
    return rank * m // n_ranks


class SubfileSet:
    """The M open data.<m> subfiles of one step/series (striped or plain).

    `owned` restricts which aggregator ids this instance opens and may
    append to (default: all M). A multi-process writer gives each process
    `owned={w}` so subfile handles are never shared across processes;
    appending to an un-owned aggregator is a clear error instead of a
    silent cross-process corruption.
    """

    def __init__(self, dirpath, m: int, *, stripe: Optional[StripeConfig] = None,
                 ost_pool: Optional[OstPool] = None,
                 owned: Optional[Iterable[int]] = None):
        self.dirpath = dirpath
        self.m = m
        self.owned = frozenset(range(m) if owned is None else owned)
        bad = [i for i in self.owned if not 0 <= i < m]
        if bad:
            raise ValueError(f"owned aggregator ids {bad} out of range 0..{m - 1}")
        self._offsets = {i: 0 for i in self.owned}
        self._locks = {i: threading.Lock() for i in self.owned}
        self._files = {}
        for i in sorted(self.owned):
            if stripe is not None and ost_pool is not None:
                self._files[i] = StripedFile(ost_pool, f"data.{i}", stripe,
                                             rank=i)
            else:
                self._files[i] = open_file(dirpath / f"data.{i}", "wb",
                                           rank=i)

    def _check_owned(self, agg_id: int):
        if agg_id not in self.owned:
            raise ValueError(
                f"aggregator {agg_id} is not owned by this SubfileSet "
                f"(owned: {sorted(self.owned)}) — each writer process may "
                f"only append to its own subfiles")

    def append(self, agg_id: int, payload: bytes) -> int:
        """Thread-safe append; returns the subfile offset written at.
        Appends are sequential per subfile — no seek() is ever needed (the
        log-structured layout is exactly why BP4 avoids metadata ops)."""
        self._check_owned(agg_id)
        with self._locks[agg_id]:
            off = self._offsets[agg_id]
            f = self._files[agg_id]
            if isinstance(f, StripedFile):
                f.write(payload, offset=off)
            else:
                f.write(payload)
            self._offsets[agg_id] = off + len(payload)
            return off

    def flush_one(self, agg_id: int):
        """Push one subfile's bytes to the OS (no durability barrier)."""
        self._check_owned(agg_id)
        with self._locks[agg_id]:
            self._files[agg_id].flush()

    def fsync_one(self, agg_id: int):
        """Durability barrier for one subfile (parallel prepare phase)."""
        self._check_owned(agg_id)
        with self._locks[agg_id]:
            # fsync under the per-subfile lock is the point: the barrier
            # must order against concurrent appends to the same subfile
            self._files[agg_id].fsync()   # jbplint: disable=JBP004

    def fsync_close(self):
        for f in self._files.values():
            f.fsync()
            f.close()


class WriterPool:
    """Work-stealing writer pool: tasks are (agg_id, payload, on_done).

    A failing task must not kill its worker thread: the pool would silently
    shrink and a later `drain()` would hang forever on the un-consumed
    queue. Instead the FIRST task error is recorded and re-raised from
    `drain()`; workers stay alive and keep draining.
    """

    def __init__(self, n_workers: int):
        self.n_workers = max(1, n_workers)
        self._q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._err_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        for i in range(self.n_workers):
            t = threading.Thread(target=self._worker, name=f"jbp-writer-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self):
        while not self._stop.is_set():
            try:
                task = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                fn, args = task
                fn(*args)
            except BaseException as e:         # noqa: BLE001 — surfaced in drain
                with self._err_lock:
                    if self._error is None:    # first failure is the root cause
                        self._error = e
            finally:
                self._q.task_done()

    def submit(self, fn: Callable, *args):
        self._q.put((fn, args))

    def drain(self):
        """Barrier: every submitted task has run. Raises the first task
        error recorded since the last drain (the pool stays usable)."""
        self._q.join()
        with self._err_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def shutdown(self):
        try:
            self.drain()
        finally:
            self._stop.set()
            for t in self._threads:
                t.join(timeout=2.0)
