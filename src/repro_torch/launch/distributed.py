"""Host helpers of multi-process bring-up: the I/O rank ranges and the
spawned writer processes of the parallel write plane
(`repro_torch.core.parallel_engine`).

The port's own copy of the JAX package's host helpers (no JAX in them).
The process-group bring-up (`initialize`) comes with the port's mesh
layer on `torch.distributed`.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import queue as _queue
import time
from typing import Callable, Optional


def io_rank_range(n_io_ranks: int, process_id: int, num_processes: int):
    """Which logical I/O ranks this host owns (block assignment, mirroring
    aggregation.aggregator_of so rank->aggregator locality is preserved)."""
    lo = process_id * n_io_ranks // num_processes
    hi = (process_id + 1) * n_io_ranks // num_processes
    return range(lo, hi)


def writer_rank_range(w: int, n_ranks: int, n_writers: int) -> range:
    """Ranks owned by writer/aggregator `w` — the exact inverse image of
    `aggregation.aggregator_of`'s contiguous block assignment, so a writer
    process knows up front which ranks' chunks it will receive."""
    m = min(n_writers, max(n_ranks, 1))
    lo = -(-w * n_ranks // m)              # ceil(w * n_ranks / m)
    hi = -(-(w + 1) * n_ranks // m)
    return range(lo, hi)


class WorkerAckQueue:
    """Coordinator-side fan-in over one result queue PER worker.

    A single shared `mp.Queue` has one pipe write-lock shared by every
    worker's feeder thread. A worker SIGKILLed inside the
    `send_bytes`..`release` window abandons that lock and every
    SURVIVING worker's acks wedge behind it forever — `close()` then
    times out instead of returning. With one queue per worker the
    abandoned lock dies with its owner; peers keep acking.

    Exposes the `get(timeout=)` / `get_nowait()` subset the coordinator
    uses, so call sites treat it exactly like a shared queue.
    """

    def __init__(self, queues):
        self.queues = list(queues)
        self._next = 0

    def get_nowait(self):
        for _ in range(len(self.queues)):
            q = self.queues[self._next]
            self._next = (self._next + 1) % len(self.queues)
            try:
                return q.get_nowait()
            except _queue.Empty:
                continue
        raise _queue.Empty

    def get(self, timeout: Optional[float] = None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            try:
                return self.get_nowait()
            except _queue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    raise
            readers = [q._reader for q in self.queues]
            wait_t = (0.1 if deadline is None
                      else max(0.0, min(0.1, deadline - time.monotonic())))
            multiprocessing.connection.wait(readers, timeout=wait_t)


def spawn_io_workers(n_workers: int, target: Callable, make_args: Callable,
                     *, method: str = "spawn"):
    """Spawn REAL I/O writer processes (the multi-process write plane of
    repro_torch.core.parallel_engine).

    `target` must be a module-level function (picklable by reference under
    the spawn start method — spawn, not fork: the parent may hold a CUDA
    context and runtime threads that do not survive a fork). `make_args(w,
    task_q, result_q)` builds the argument tuple for worker `w`.

    Returns ([(process, task_queue)], ack_queue): one task queue per
    worker (commands flow down) and a `WorkerAckQueue` fan-in over one
    private result queue per worker (acks flow up — private so a killed
    worker cannot wedge its peers' acks behind an abandoned pipe lock).
    Workers are daemonic, so an abnormal parent exit reaps them.
    """
    ctx = multiprocessing.get_context(method)
    workers = []
    result_qs = []
    for w in range(n_workers):
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        p = ctx.Process(target=target, args=make_args(w, task_q, result_q),
                        name=f"jbp-io-{w}", daemon=True)
        p.start()
        workers.append((p, task_q))
        result_qs.append(result_q)
    return workers, WorkerAckQueue(result_qs)
