"""Multi-process bring-up on `torch.distributed`, and the host helpers of
the parallel write plane: the port of the JAX package's
`launch/distributed.py`.

`initialize` brings up the process group each rank joins before it
builds a mesh (`launch.mesh.make_mesh`): one device a rank, nccl for CUDA
and gloo for the CPU; a job of one process needs none (`make_mesh` brings
up a one-rank group itself). The contract of the reference holds:
env-driven, idempotent, and a restart re-enters through
`CheckpointManager.restore_latest(shardings=...)`, whose elastic restore
(`ckpt.checkpoint.restore_sharded`) lets a job come back at another world
size reading only the boxes each rank needs.

`RankPool` runs functions on W such ranks, spawned processes on the CPU
that share a `FileStore`: tests and the smoke run drive the multi-rank
paths (sharded saves, elastic restores) with it on one host.
`repair_gloo_cuda_gather` gives such a gloo group the functional
all-gather of CUDA tensors that torch's gloo lacks, so W ranks that share
one card can hold their tensors on it (`launch.mesh.make_mesh` installs
it for a gloo group whose mesh is on "cuda").
`io_rank_range`, `writer_rank_range`, `WorkerAckQueue` and
`spawn_io_workers` are the write plane's
(`repro_torch.core.parallel_engine`).
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import queue as _queue
import time
import traceback
from typing import Callable, Optional


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None) -> dict:
    """Idempotent `torch.distributed` bring-up from args or env, as
    torchrun sets it: `MASTER_ADDR:MASTER_PORT` (the coordinator),
    `WORLD_SIZE` and `RANK`, and `LOCAL_RANK` for the card a CUDA rank
    takes. `coordinator` is "host:port" (TCP) or an init-method URL such
    as "file:///path/to/store". With more than one process it calls
    `init_process_group`: nccl for CUDA (`device`, CUDA unless "cpu" is
    asked for), gloo for the CPU; a second call checks the group and
    returns. Returns the reference's dict; a rank drives one device, so
    `global_devices` is the world size."""
    import torch
    import torch.distributed as dist

    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("RANK", "0")))
    if num_processes > 1:
        if dist.is_initialized():
            have = (dist.get_world_size(), dist.get_rank())
            if have != (num_processes, process_id):
                raise RuntimeError(f"process group of world {have[0]}, rank "
                                   f"{have[1]} already up; asked for world "
                                   f"{num_processes}, rank {process_id}")
        else:
            if coordinator is None:
                raise ValueError("a multi-process job needs a coordinator "
                                 "(argument or MASTER_ADDR/MASTER_PORT)")
            if dev.type == "cuda":
                local = int(os.environ.get("LOCAL_RANK", process_id))
                torch.cuda.set_device(local % torch.cuda.device_count())
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=(coordinator if "://" in coordinator
                             else f"tcp://{coordinator}"),
                world_size=num_processes, rank=process_id)
    return {"process_id": process_id, "num_processes": num_processes,
            "local_devices": 1, "global_devices": num_processes}


def gloo_all_gather(input, group_size: int, group_name: str):
    """The body of the repaired `_c10d_functional::all_gather_into_tensor`
    (`repair_gloo_cuda_gather`): the rank-major concatenation along dim 0
    of every rank's `input`, as the functional op returns it, gathered by
    the c10d `all_gather_into_tensor` on the group that `group_name`
    names. It completes before it returns, so the functional
    `wait_tensor` that follows finds no work to wait on. The kernel is
    registered for the op, not for a group, so a group that is not gloo
    is refused here, at every call."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group_name)
    backend = dist.get_backend(pg)
    if backend != "gloo":
        raise RuntimeError(f"the repaired all-gather serves gloo groups "
                           f"only; group {group_name}'s backend is "
                           f"{backend}")
    out = input.new_empty((group_size * input.shape[0],)
                          + tuple(input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(), group=pg)
    return out


_GATHER_REPAIR = None


def repair_gloo_cuda_gather():
    """Give `_c10d_functional::all_gather_into_tensor` a CUDA kernel that
    runs `gloo_all_gather`, for a default process group on gloo whose
    ranks hold their tensors on a card.

    Why it exists: on torch 2.11 the functional all-gather, which every
    DTensor redistribution to `Replicate` issues, reaches gloo's
    `allgather_into_tensor_coalesced`, which gloo lacks for CUDA tensors:
    each rank dies with SIGSEGV in it, or, under
    `TORCH_DISTRIBUTED_DEBUG=DETAIL`, raises "Backend gloo does not
    support allgather_into_tensor_coalesced". gloo's c10d
    `all_gather_into_tensor` of CUDA tensors completes, and the other
    functional collectives do. The kernel is registered once a process
    under the `CUDA` key only: the op's CPU kernel stays torch's. It
    replaces the op's CUDA kernel for every group of the process, so it
    is installed only when the default group is gloo, and its body
    refuses any group that is not (an nccl group gathers CUDA tensors
    itself). Returns the `torch.library.Library` that holds the
    registration."""
    global _GATHER_REPAIR
    import torch
    import torch.distributed as dist
    backend = dist.get_backend()
    if backend != "gloo":
        raise ValueError(f"the functional all-gather is repaired for gloo "
                         f"groups only; the default group's backend is "
                         f"{backend}")
    if _GATHER_REPAIR is None:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", gloo_all_gather, "CUDA")
        _GATHER_REPAIR = lib
    return _GATHER_REPAIR


def _rank_main(rank: int, world: int, init_method: str, tasks, results):
    """A `RankPool` rank: joins the group, then runs each task sent to it
    until it gets None; a task's error goes home as its traceback."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    initialize(init_method, world, rank, device="cpu")
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((True, fn(*args)))
            except Exception:                    # noqa: BLE001 — sent home
                results.put((False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """`world` spawned processes, the ranks of one gloo process group on
    the CPU (a `FileStore` at `store_dir/store`, no TCP port). `run(fn,
    *args)` calls `fn(*args)` in every rank and returns the results in
    rank order; `fn` is sent by reference, so it must be a module-level
    function. A rank's error, or no answer within `timeout` seconds (a
    collective some rank never joined), raises and tears the pool down."""

    def __init__(self, world: int, store_dir, *, timeout: float = 300.0):
        ctx = multiprocessing.get_context("spawn")
        os.makedirs(store_dir, exist_ok=True)
        init = f"file://{os.path.abspath(os.fspath(store_dir))}/store"
        self.timeout = timeout
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, init, self.tasks[r],
                                        self.results[r]),
                                  name=f"rank-{r}", daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn: Callable, *args) -> list:
        for q in self.tasks:
            q.put((fn, args))
        out, errors = [], []
        deadline = time.monotonic() + self.timeout
        for r, q in enumerate(self.results):
            ok, val = self._result(r, q, deadline, fn.__name__)
            out.append(val)
            if not ok:
                errors.append(f"rank {r}:\n{val}")
        if errors:
            self.close()
            raise RuntimeError(f"{fn.__name__} failed in "
                               f"{len(errors)} rank(s):\n" + "\n".join(errors))
        return out

    def _result(self, r: int, q, deadline: float, what: str):
        """Rank r's (ok, value), or raise once it has died or the deadline
        has passed (the pool is then torn down)."""
        while True:
            try:
                return q.get(timeout=min(1.0, max(0.0, deadline
                                                  - time.monotonic())))
            except _queue.Empty:
                pass
            dead = [(i, p.exitcode) for i, p in enumerate(self.procs)
                    if not p.is_alive()]
            if dead or time.monotonic() >= deadline:
                self.close()
                why = (f"rank(s) exited: {dead}" if dead else
                       f"no answer within {self.timeout} s")
                raise RuntimeError(f"rank {r} gave no result for {what}: "
                                   f"{why}")

    def close(self):
        """Stop every rank: a clean exit where it can, else terminated."""
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


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
