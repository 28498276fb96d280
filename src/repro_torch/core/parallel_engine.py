"""Multi-process parallel write plane for the JBP engine (paper §IV-C).

The paper's headline claim is *parallel* I/O: N ranks streaming
simultaneously into M aggregated BP4 subfiles. `BpWriter` reproduces the
format but drives every "rank" from one Python process — aggregate write
throughput is bounded by one process and one GIL. `ParallelBpWriter`
makes the write plane real:

    coordinator (rank 0)                 writer process w (of W)
    --------------------                 -----------------------
    put() routes chunks by               owns data.<w>   (SubfileSet owned={w})
    aggregator_of(rank, N, W)            owns md.<w>.shard (private metadata)
    end_step():
      phase 1  PREPARE  --- headers ---> view chunk in shm ring
               (chunk bytes go through      -> compress -> append data.<w>
               a per-worker ShmRing:        -> sealed shard record -> ack
               ONE memcpy, no pickle)    (ack doubles as the slot free-list)
               validate every sealed
               shard record (crc) read
               back from md.<w>.shard
      phase 2  COMMIT
               merge shard chunk tables
               -> md.0 record
               -> crc-sealed md.idx record

Durability is a TWO-PHASE COMMIT: a worker's sealed shard record is its
"prepared" vote; the crc-sealed md.idx record written by the coordinator
is the commit. A crash (or worker failure) anywhere before the commit
leaves shard records and payload bytes with no md.idx record — the step
is dropped by `BpReader` exactly like a torn step today, and orphaned
shard/payload bytes are dead weight, never wrong data. `md.0`/`md.idx`
are byte-compatible with the single-process writer, so the reader needs
ZERO format changes (shards are a writer-side artifact; `md.0` remains
the reader-visible merged metadata). The port's own copy of the JAX
package's plane: the same protocol and the same bytes on disk.

Tensors stay on the COORDINATOR. `compression.outbound_chunk` gives a
tensor chunk its form there: byte-shuffled on its device
(`device_compress` with a blosc codec: one `shuffle_blocks` launch a
chunk, then the D2H copy) or copied to host; either way only numpy bytes
(an ndarray, a `ShmHeader`, or a pre-shuffled chunk's raw bytes) cross
to a worker. The workers import no torch and hold no device context.

Chunk TRANSPORT (`transport=`): the default `"shm"` moves chunk bytes
through a per-worker `repro_torch.core.shm_transport.ShmRing` — the
coordinator memcpys each chunk into a shared-memory slot and sends only
a small `ShmHeader` down the control queue; the worker compresses
straight from the mapped pages. Slots are freed when the step's ack
arrives (prepared OR error — the ack is the free-list), so slot contents
are stable for exactly the life of the step, and a worker dying with a
slot in flight drops the step like a torn shard, nothing more. Payloads
that cannot fit the ring (oversized, or a full ring) fall back to the
`"pickle"` path per chunk — the transport degrades, it never blocks.
`transport="pickle"` pickles whole ndarrays down the queue (the
baseline the shm transport is measured against).

ASYNC COMPOSITION (`async_commit=True`): a bounded snapshot queue (the
`_PipelinedCommitter` shared with `AsyncBpWriter`) sits in FRONT of the
coordinator — `end_step()` deep-copies the step and returns immediately;
a dedicated committer thread runs the full two-phase commit in the
background. The producer sees neither compression nor commit latency;
`drain()` is the durability barrier; `fsync_policy="step"` forces a
blocking seal exactly like the async engine. This is what
`Series(parallel_io=W, async_commit=True)` wires up.

Worker processes are spawned (never forked — the parent may hold a CUDA
context and runtime threads) via `launch.distributed.spawn_io_workers`;
control
messages travel down per-worker task queues, so compression + subfile
appends + shard seals run with W-way real parallelism across processes.

Shard record format (md.<w>.shard, append-only log):

    <QQI: step, blob_len, crc32(blob)> <blob: {"step", "chunks": {name: [...]}}>

`iter_shard_records` replays a shard and stops at the first torn record —
the recovery primitive for crashed writers. Note a shard may contain
sealed records for steps that were never committed (prepare succeeded,
commit did not); md.idx is always the commit truth.

Persistent plane: a `WriterPlane` spawns W workers ONCE and keeps them
idle between series; `ParallelBpWriter(..., plane=plane)` retargets them
("open") and releases them ("finish") per series, so periodic checkpoint
writes stop paying W process spawns per save (`CheckpointManager` holds
one plane for the whole run). The plane also owns the shm rings: they
stay mapped across saves and are unlinked in `shutdown()` — plus a
`weakref.finalize` so an abnormal exit leaks nothing in /dev/shm. On
"finished"/"closed" every worker ships its own Darshan
`MONITOR.snapshot()` back on the ack (including the new
`TRANSPORT_SHM_BYTES` / `TRANSPORT_PICKLE_FALLBACK_BYTES` counters) and
the coordinator merges it — `parser_dump` in the parent covers the whole
write plane.

DXT tracing (`repro_torch.core.dxt`): when the coordinator's TRACER is enabled
the flag rides the spawn args / "open" payload, workers trace their own
compress/seal spans + per-op file events, and ship trace buffers home on
the "prepared" ack (per step) and "finished"/"closed" (remainder) next
to the counter snapshot — each snapshot carries the worker's clock epoch
so `TRACER.ingest` rebases everything onto the coordinator's wall clock.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import pathlib
import queue as _queue
import struct
import threading
import time
import traceback
import weakref
import zlib
from typing import Any, Optional

import numpy as np

from repro_torch.core import compression as C
from repro_torch.core.aggregation import SubfileSet, aggregator_of
from repro_torch.core.bp_engine import (ChunkMeta, EngineConfig, StepSnapshot,
                                  build_md_record, encode_chunk, put_chunk,
                                  record_compress_counters,
                                  seal_md_record, take_step_snapshot)
from repro_torch.core.darshan import MONITOR, merge_worker_payload, open_file
from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS, StepJournal, journal_path
from repro_torch.core.shm_transport import (DEFAULT_RING_BYTES, ShmHeader, ShmRing,
                                      unlink_rings, validate_transport)
from repro_torch.core.striping import OstPool
from repro_torch.launch.distributed import spawn_io_workers

SHARD_HDR = struct.Struct("<QQI")      # step, blob_len, crc32(blob)


def shard_path(path, w: int) -> pathlib.Path:
    return pathlib.Path(str(path)) / f"md.{w}.shard"


def iter_shard_records(path, w: int):
    """Replay writer `w`'s metadata shard: yield (step, record) for every
    crc-valid sealed record, stopping at the first torn/corrupt one (the
    shard is an append-only log, so a torn tail is the crash case)."""
    p = shard_path(path, w)
    if not p.exists():
        return
    with open_file(p, "rb") as f:
        raw = f.read()
    off = 0
    while off + SHARD_HDR.size <= len(raw):
        step, ln, crc = SHARD_HDR.unpack_from(raw, off)
        blob = raw[off + SHARD_HDR.size:off + SHARD_HDR.size + ln]
        if len(blob) != ln or (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
            return
        yield step, json.loads(blob)
        off += SHARD_HDR.size + ln


def read_shard_record(path, wid: int, info: dict, step: int) -> dict:
    """Phase-1 validation: read writer `wid`'s sealed shard record of
    `step` back from disk (at `info["shard_off"]`, `info["shard_len"]`
    bytes) and crc-check it — the coordinator commits only what is durably
    prepared. A torn/corrupt shard aborts the step like a torn step."""
    with open_file(shard_path(path, wid), "rb", rank=0) as f:
        f.seek(info["shard_off"])
        raw = f.read(info["shard_len"])
    if len(raw) < SHARD_HDR.size:
        raise RuntimeError(f"torn shard record from writer {wid} "
                           f"(step {step} not committed)")
    rstep, ln, crc = SHARD_HDR.unpack_from(raw, 0)
    blob = raw[SHARD_HDR.size:SHARD_HDR.size + ln]
    if (rstep != step or len(blob) != ln
            or (zlib.crc32(blob) & 0xFFFFFFFF) != crc):
        raise RuntimeError(f"torn shard record from writer {wid} "
                           f"(step {step} not committed)")
    return json.loads(blob)


def seal_shard_record(shard, step: int, chunks: dict) -> dict:
    """Append writer's prepared vote for `step` to its open shard file:
    the crc-sealed record of its chunk table (`chunks`: name -> chunk
    jsons, in the order the chunks were appended). Returns the record's
    offset, length and crc (the "prepared" ack's fields)."""
    blob = json.dumps({"step": step, "chunks": chunks}).encode()
    crc = zlib.crc32(blob) & 0xFFFFFFFF
    rec_off = shard.tell()
    shard.write(SHARD_HDR.pack(step, len(blob), crc))
    shard.write(blob)
    return {"shard_off": rec_off, "shard_len": SHARD_HDR.size + len(blob),
            "crc": crc}


# --------------------------------------------------------------------- worker
def _open_worker_files(path: pathlib.Path, w: int, n_writers: int,
                       cfg: EngineConfig):
    """Open worker `w`'s subfile + metadata shard for one series."""
    ost_pool = (OstPool(path, cfg.n_osts)
                if cfg.stripe is not None else None)
    subfiles = SubfileSet(path, n_writers, stripe=cfg.stripe,
                          ost_pool=ost_pool, owned=(w,))
    shard = open_file(shard_path(path, w), "wb", rank=w)
    return subfiles, shard


def _worker_main(w: int, path_str, n_writers: int, cfg, task_q, result_q,
                 ring_name: Optional[str] = None, trace: bool = False,
                 metrics: bool = False):
    """One writer process: owns data.<w> + md.<w>.shard while a series is
    open. With `path_str=None` the worker starts IDLE (a `WriterPlane`
    member) and is retargeted per series via "open"/"finish" — the process
    (spawn cost, imports, page cache) persists across series.

    `ring_name` attaches the worker to its shm transport ring (created by
    the coordinator/plane); chunk items then arrive as `ShmHeader`s and
    are read as zero-copy views over the mapped pages. Raw ndarrays in the
    same items list are the pickle fallback and always accepted.

    Protocol (every message is (tag, w, step, payload)):
      in:  ("open", None, (path, n_writers, cfg))  retarget at a new series
           ("step", step, items)  items = [(name, rank, offset, chunk), ...]
                                  chunk = ndarray | ShmHeader; an optional
                                  5th element is a meta dict: {"codec": spec}
                                  overrides cfg.codec for that chunk, and
                                  meta["pre"] marks chunk as the raw bytes
                                  of a device-preconditioned (pre-shuffled)
                                  array to rebuild as a PreshuffledChunk
           ("finish", None, None)  fsync + close files; worker stays alive
           ("close", None, None)   close files (if open) and exit
      out: ("ready", w, None, None)           files open / idle, accepting
           ("prepared", w, step, info)        payload + shard sealed on disk
                                              (info["dxt"]: trace snapshot
                                              when tracing)
           ("error", w, step, traceback_str)  step failed; worker stays alive
           ("finished", w, None, payload)     files closed; monitor snapshot,
                                              or {"darshan","dxt"} when
                                              tracing (merge_worker_payload
                                              takes either)
           ("closed", w, None, payload)       exiting; same payload shape

    The "prepared"/"error" ack is also the transport FREE-LIST: the
    coordinator releases the step's ring slots when it arrives (the worker
    is guaranteed done reading them), so the ring never needs cross-process
    synchronization. The darshan payload on "finished"/"closed" is the
    worker's own `MONITOR.snapshot()` (reset after shipping, so a
    persistent worker ships per-series deltas); the coordinator merges it
    so `parser_dump` covers the whole write plane.
    """
    from repro_torch.core.darshan import CTR, MONITOR

    # orphan watchdog: a coordinator SIGKILLed (or OOM-killed) cannot tell
    # the workers anything — without this they would block on task_q.get()
    # forever, pinning their fds AND keeping the shared resource tracker
    # alive so the transport rings never get unlinked. Exiting on parent
    # death lets the tracker reap /dev/shm. (No-op when _worker_main runs
    # as a thread in tests: parent_process() is None in the main process.)
    parent = multiprocessing.parent_process()
    # DXT: a spawned worker inherits tracing from the coordinator's flag
    # (env-based enablement also works — spawn re-imports dxt.py). Trace
    # buffers are shipped home ONLY from a real child process: in thread
    # mode the parent's TRACER *is* this tracer, and a reset-snapshot
    # would steal the coordinator's own events.
    if trace and parent is not None:
        TRACER.enable()
    # metrics plane: same inheritance story as DXT — the coordinator's flag
    # rides the spawn args / "open" payload; enabling in thread mode would
    # alias the parent's registry, so only a real child flips it
    if metrics and parent is not None:
        METRICS.enable()

    def _ship_payload(reset: bool):
        snap = MONITOR.snapshot()
        if reset:
            MONITOR.reset()
        if parent is not None and (TRACER.enabled or METRICS.enabled):
            out = {"darshan": snap}
            if TRACER.enabled:
                out["dxt"] = TRACER.snapshot(reset=True)
            if METRICS.enabled:
                out["metrics"] = METRICS.snapshot(reset=True)
            return out
        return snap

    if parent is not None:
        def _exit_with_parent():
            parent.join()               # returns only when the parent died
            os._exit(2)
        threading.Thread(target=_exit_with_parent, daemon=True,
                         name="jbp-orphan-watchdog").start()

    subfiles = shard = None
    spath = str(path_str) if path_str is not None else ""
    ring = None
    if ring_name is not None:
        try:
            ring = ShmRing(name=ring_name, create=False)
        except BaseException:                   # noqa: BLE001
            result_q.put(("error", w, None, traceback.format_exc()))
            return

    def _teardown():
        nonlocal subfiles, shard
        if subfiles is not None:
            subfiles.fsync_close()
            shard.fsync()
            shard.close()
            subfiles = shard = None

    if path_str is not None:
        try:
            subfiles, shard = _open_worker_files(
                pathlib.Path(path_str), w, n_writers, cfg)
        except BaseException:                   # noqa: BLE001
            result_q.put(("error", w, None, traceback.format_exc()))
            return
    result_q.put(("ready", w, None, None))
    while True:
        msg = task_q.get()
        tag = msg[0]
        if tag == "open":
            try:
                _teardown()                     # stale series, if any
                o_path, o_n, o_cfg = msg[2][:3]
                if len(msg[2]) > 3 and msg[2][3] and parent is not None:
                    TRACER.enable()             # coordinator traces this series
                if len(msg[2]) > 4 and msg[2][4] and parent is not None:
                    METRICS.enable()            # coordinator meters this series
                n_writers, cfg = o_n, o_cfg
                spath = str(o_path)
                subfiles, shard = _open_worker_files(
                    pathlib.Path(o_path), w, n_writers, cfg)
            except BaseException:               # noqa: BLE001
                result_q.put(("error", w, None, traceback.format_exc()))
                continue                        # plane stays usable
            result_q.put(("ready", w, None, None))
            continue
        if tag == "finish":
            try:
                _teardown()
            except BaseException:               # noqa: BLE001
                result_q.put(("error", w, None, traceback.format_exc()))
                continue
            result_q.put(("finished", w, None, _ship_payload(reset=True)))
            continue
        if tag == "close":
            try:
                _teardown()
            except BaseException:               # noqa: BLE001
                pass                            # exiting anyway
            result_q.put(("closed", w, None, _ship_payload(reset=False)))
            if ring is not None:
                ring.close()
            return
        _, step, items = msg
        if subfiles is None:
            result_q.put(("error", w, step,
                          "worker received a step with no open series"))
            continue
        try:
            t0 = time.perf_counter()
            tcomp = 0.0
            shm_bytes = fallback_bytes = 0
            payloads, metas = [], []
            with TRACER.span("compress", path=f"data.{w}", rank=w) as csp:
                for item in items:
                    name, rank, offset, chunk = item[:4]
                    meta = item[4] if len(item) > 4 else None
                    if isinstance(chunk, ShmHeader):
                        arr = ring.view(chunk)  # zero-copy: shared pages
                        shm_bytes += chunk.nbytes
                    else:
                        arr = chunk             # pickle path / spill
                        fallback_bytes += arr.nbytes
                    codec = (meta or {}).get("codec") or cfg.codec
                    pre = (meta or {}).get("pre")
                    if pre is not None:
                        # coordinator shuffled this chunk on-device and shipped
                        # the raw shuffled bytes; rebuild the wrapper so
                        # encode_chunk skips the host shuffle stage
                        arr = C.PreshuffledChunk(
                            np.ascontiguousarray(arr).view(np.uint8).reshape(-1),
                            pre["dtype"], tuple(pre["shape"]), pre["block"],
                            pre["vmin"], pre["vmax"])
                    raw_nbytes = arr.nbytes
                    tc = time.perf_counter()
                    payload, shape, stats, _ = encode_chunk(
                        arr, codec, cfg.compression_block)
                    tcomp += time.perf_counter() - tc
                    record_compress_counters(w, f"data.{w}", codec,
                                             raw_nbytes, len(payload), None)
                    payloads.append(payload)
                    metas.append((name, rank, offset, shape, len(payload),
                                  stats))
                    del arr                     # release any shm view NOW
                csp.length = sum(len(p) for p in payloads)
            if METRICS.enabled:
                METRICS.observe("compress", tcomp, key=f"data.{w}",
                                nbytes=sum(len(p) for p in payloads))
            if ring is not None:
                tkey = f"{spath}/transport"
                if shm_bytes:
                    MONITOR.record(w, tkey, CTR.TRANSPORT_SHM_BYTES,
                                   inc=shm_bytes)
                if fallback_bytes:
                    MONITOR.record(w, tkey, CTR.TRANSPORT_PICKLE_FALLBACK_BYTES,
                                   inc=fallback_bytes)
            base = subfiles.append(w, b"".join(payloads))
            off = base
            chunks: dict[str, list] = {}
            for name, rank, offset, shape, nb, (vmin, vmax) in metas:
                chunks.setdefault(name, []).append(
                    ChunkMeta(rank, tuple(offset), tuple(shape), w, off, nb,
                              vmin, vmax).to_json())
                off += nb
            # the record offset is re-derived from the file position every
            # step: a previous FAILED step may have left (torn) bytes in
            # the shard, and a stale counter would desync every later
            # commit ("worker stays alive" requires this)
            tseal = time.perf_counter()
            with TRACER.span("seal", path=f"md.{w}.shard", rank=w) as ssp:
                sealed = seal_shard_record(shard, step, chunks)
                ssp.length = sealed["shard_len"] - SHARD_HDR.size
                if cfg.fsync_policy == "step":
                    subfiles.fsync_one(w)
                    shard.fsync()
                else:
                    subfiles.flush_one(w)
                    shard.flush()  # coordinator reads the record back NOW
            if METRICS.enabled:
                METRICS.observe("seal", time.perf_counter() - tseal,
                                nbytes=sealed["shard_len"] - SHARD_HDR.size,
                                key=f"md.{w}.shard")
            info = {**sealed, "compress_s": tcomp, "bytes_stored": off - base,
                    "shm_bytes": shm_bytes, "fallback_bytes": fallback_bytes,
                    "worker_s": time.perf_counter() - t0}
            if parent is not None and TRACER.enabled:
                # ship this step's trace events home on the ack itself —
                # the coordinator's timeline stays live, not close-time
                info["dxt"] = TRACER.snapshot(reset=True)
            if parent is not None and METRICS.enabled:
                # per-step histogram shard home on the same ack: the
                # coordinator's journal frame carries this worker's cells
                info["metrics"] = METRICS.snapshot(reset=True)
            result_q.put(("prepared", w, step, info))
        except BaseException:                   # noqa: BLE001
            result_q.put(("error", w, step, traceback.format_exc()))


# ---------------------------------------------------------------- coordinator
def collect_acks(workers, result_q, kind: str, expect, *,
                 timeout: float, step: Optional[int] = None) -> dict:
    """Wait for one `kind` ack per worker in `expect`; raise on worker
    errors or deaths. Acks for other steps (stale messages from an
    aborted step) are ignored. Shared by the per-series coordinator and
    the persistent WriterPlane."""
    pending = set(expect)
    got: dict[int, Any] = {}
    errors: list[tuple[int, str]] = []
    deadline = time.monotonic() + timeout
    while pending:
        try:
            tag, wid, mstep, payload = result_q.get(timeout=1.0)
        except _queue.Empty:
            dead = [i for i in pending if not workers[i][0].is_alive()]
            if dead:
                raise RuntimeError(
                    f"writer process(es) {dead} died before acking "
                    f"{kind!r} — step aborted (not committed)")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"timed out after {timeout}s waiting for "
                    f"{kind!r} from writer(s) {sorted(pending)}")
            continue
        if tag == "error":
            if step is not None and mstep is not None and mstep != step:
                continue           # stale error from an already-aborted step
            errors.append((wid, payload))
            pending.discard(wid)
        elif tag == kind and (step is None or mstep == step):
            got[wid] = payload
            pending.discard(wid)
        # anything else: stale ack from an aborted step — drop it
    if errors:
        detail = "\n".join(f"--- writer {i} ---\n{tb}" for i, tb in errors)
        raise RuntimeError(
            f"parallel write failed on writer(s) "
            f"{[i for i, _ in errors]}:\n{detail}")
    return got


def _make_rings(n: int, ring_bytes: int) -> list[ShmRing]:
    """One transport ring per worker, cleaned up as a unit on failure."""
    rings: list[ShmRing] = []
    try:
        for _ in range(n):
            rings.append(ShmRing(ring_bytes))
    except BaseException:
        unlink_rings(rings)
        raise
    return rings


class WriterPlane:
    """W persistent writer processes, reusable across series.

    `ParallelBpWriter(..., plane=plane)` retargets the plane's workers at
    its series ("open") and releases them on close ("finish") WITHOUT
    tearing the processes down — the spawn/import cost is paid once per
    plane, not once per series. This is what makes periodic parallel
    checkpoints cheap: `CheckpointManager` keeps one plane alive for the
    whole run instead of spawning W processes every `every` steps.

    The plane also owns the shm transport rings (`transport="shm"`): one
    per worker, mapped for the plane's whole life, so repeated checkpoint
    saves reuse the same shared pages. `shutdown()` unlinks them, and a
    `weakref.finalize` guarantees the unlink even when the plane is
    leaked or the process dies with an unhandled exception.
    """

    def __init__(self, n_writers: int, *, ack_timeout: float = 300.0,
                 transport: str = "shm",
                 ring_bytes: int = DEFAULT_RING_BYTES):
        validate_transport(transport)
        self.m = max(1, int(n_writers))
        self.ack_timeout = ack_timeout
        self.transport = transport
        self._shut = False
        self.rings: list[ShmRing] = (
            _make_rings(self.m, ring_bytes) if transport == "shm" else [])
        self._ring_finalizer = weakref.finalize(
            self, unlink_rings, list(self.rings))
        ring_names = [r.name for r in self.rings] or [None] * self.m
        self.workers, self.result_q = spawn_io_workers(
            self.m, _worker_main,
            lambda i, tq, rq: (i, None, self.m, None, tq, rq, ring_names[i],
                               TRACER.enabled, METRICS.enabled))
        try:       # idle-ready handshake: every process is up and listening
            collect_acks(self.workers, self.result_q, "ready", range(self.m),
                         timeout=self.ack_timeout)
        except BaseException:
            self.shutdown(_collect=False)
            raise

    def pids(self) -> list[int]:
        return [p.pid for p, _ in self.workers]

    def alive(self) -> bool:
        return not self._shut and all(p.is_alive() for p, _ in self.workers)

    def shutdown(self, _collect: bool = True):
        """Exit every worker; merge their Darshan counters into this
        process's MONITOR; unlink the transport rings (idempotent)."""
        if self._shut:
            return
        self._shut = True
        for p, tq in self.workers:
            if p.is_alive():
                tq.put(("close", None, None))
        if _collect:
            try:
                got = collect_acks(
                    self.workers, self.result_q, "closed",
                    [i for i, (p, _) in enumerate(self.workers)
                     if p.is_alive()], timeout=self.ack_timeout)
                for payload in got.values():
                    merge_worker_payload(payload)
            except BaseException:               # noqa: BLE001
                pass                            # best effort on teardown
        for p, tq in self.workers:
            tq.close()
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)             # reap: no zombie PID entry
        self._ring_finalizer()                  # close + unlink every ring

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.shutdown()


class ParallelBpWriter:
    """BpWriter-protocol writer backed by W real writer processes.

    Drop-in for `BpWriter` on the producer side (begin_step/put/
    set_attribute/end_step/close). The number of aggregators equals the
    number of writer processes: each process owns its subfile outright,
    which is what makes the plane coordination-free between commits.

    `transport="shm"` (default) moves chunk bytes through per-worker
    shared-memory rings; `"pickle"` is the queue-serialization baseline.
    `async_commit=True` pipelines the whole two-phase commit behind a
    bounded snapshot queue: `end_step()` returns after a deep-copy
    snapshot, `drain()` is the durability barrier (otherwise `drain()` is
    a no-op — the sync `end_step` is its own commit barrier).
    """

    def __init__(self, path, n_ranks: int, cfg: EngineConfig = EngineConfig(),
                 *, n_writers: Optional[int] = None, ack_timeout: float = 300.0,
                 plane: Optional[WriterPlane] = None, transport: str = "shm",
                 ring_bytes: int = DEFAULT_RING_BYTES,
                 async_commit: bool = False, queue_depth: int = 2):
        validate_transport(transport)
        self.path = pathlib.Path(str(path))
        self.path.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.n_ranks = n_ranks
        w = n_writers if n_writers is not None else cfg.aggregators
        self.m = min(max(1, int(w)), max(n_ranks, 1))
        if plane is not None:
            self.m = min(self.m, plane.m)
            # the plane owns worker processes AND rings: inherit its mode
            transport = plane.transport
        self.ack_timeout = ack_timeout
        self._plane = plane
        self.async_commit = bool(async_commit)
        if cfg.stripe is not None:
            OstPool(self.path, cfg.n_osts)      # create ost dirs up front
            for i in range(self.m):
                with open_file(self.path / f"data.{i}.stripe.json", "w",
                               rank=0) as sf:
                    sf.write(json.dumps(
                        {"stripe_count": cfg.stripe.stripe_count,
                         "stripe_size": cfg.stripe.stripe_size}))
        self._md = open_file(self.path / "md.0", "wb", rank=0)
        self._idx = open_file(self.path / "md.idx", "wb", rank=0)
        self._md_off = 0
        self._step: Optional[int] = None
        self._pending: dict[str, dict] = {}
        self._attrs: dict[str, Any] = {}
        self._profile: list[dict] = []
        # metrics journal sidecar: one frame per committed step carrying
        # the coordinator's delta + every worker's shipped shard
        self._journal = (StepJournal(journal_path(self.path))
                         if METRICS.enabled and cfg.profiling else None)
        self._closed = False
        self._crash_after_prepare = False       # test hook: torn-commit sim
        self._rings: list[ShmRing] = []
        self._ring_finalizer = None
        try:
            if plane is not None:
                # retarget the persistent plane's first m workers at this
                # series; spawn cost is NOT paid here, rings are the plane's
                self._workers, self._result_q = plane.workers, plane.result_q
                self._rings = plane.rings[:self.m]
                for wid in range(self.m):
                    self._workers[wid][1].put(
                        ("open", None, (str(self.path), self.m, cfg,
                                        TRACER.enabled, METRICS.enabled)))
            else:
                if transport == "shm":
                    self._rings = _make_rings(self.m, ring_bytes)
                    self._ring_finalizer = weakref.finalize(
                        self, unlink_rings, list(self._rings))
                ring_names = [r.name for r in self._rings] or [None] * self.m
                self._workers, self._result_q = spawn_io_workers(
                    self.m, _worker_main,
                    lambda i, tq, rq: (i, str(self.path), self.m, cfg, tq, rq,
                                       ring_names[i], TRACER.enabled,
                                       METRICS.enabled))
            self._collect("ready", range(self.m))   # spawn/open failures here
        except BaseException:
            # a failed bring-up must not leak the md handles, the rings, OR
            # the workers that DID come up (they would block on task_q.get
            # holding their subfile/shard fds until parent exit); a
            # borrowed plane is left alive — its workers stay idle-usable
            self._md.close()
            self._idx.close()
            if plane is None:
                for p, _ in getattr(self, "_workers", []):
                    if p.is_alive():
                        p.terminate()
                    p.join(timeout=2.0)
                if self._ring_finalizer is not None:
                    self._ring_finalizer()
            raise
        self.transport = "shm" if self._rings else "pickle"
        # the pipelined committer sits in FRONT of the coordinator: it owns
        # the two-phase commit ordering exactly like AsyncBpWriter's seal
        # thread owns md.0/md.idx ordering
        self._committer = None
        if self.async_commit:
            from repro_torch.core.async_engine import _PipelinedCommitter
            self._committer = _PipelinedCommitter(
                self._commit_step, queue_depth=queue_depth,
                name="jbp-parallel-commit")

    # ------------------------------------------------------------------ step
    def begin_step(self, step: int):
        if self._step is not None:
            raise RuntimeError(
                f"begin_step({step}) while step {self._step} is still open "
                f"(previous step not closed — call end_step() first)")
        self._step = step
        self._pending = {}

    def set_attribute(self, name: str, value):
        self._attrs[name] = value

    put = put_chunk

    def _take_snapshot(self, *, copy: bool) -> StepSnapshot:
        """Capture the open step and reset producer-side state (the shared
        bp_engine snapshot contract: `copy=True` deep-copies chunk arrays,
        a tensor by `clone()` on its own device, so an async producer may
        reuse its buffers immediately)."""
        snap = take_step_snapshot(self._step, self._pending, self._attrs,
                                  copy=copy)
        self._step = None
        self._pending = {}
        return snap

    # ----------------------------------------------------------- ack plumbing
    def _collect(self, kind: str, expect, step: Optional[int] = None) -> dict:
        return collect_acks(self._workers, self._result_q, kind, expect,
                            timeout=self.ack_timeout, step=step)

    def _read_shard_record(self, wid: int, info: dict, step: int) -> dict:
        return read_shard_record(self.path, wid, info, step)

    # ------------------------------------------------------------------ commit
    def end_step(self, blocking: bool = False) -> dict:
        """Sync mode: run the two-phase commit inline (the commit barrier).
        `async_commit` mode: snapshot + enqueue; `blocking=True` (forced by
        fsync_policy="step") waits for the background seal instead."""
        if self._committer is None:
            return self._commit_step(self._take_snapshot(copy=False))
        if self.cfg.fsync_policy == "step":
            blocking = True            # durable seal must precede the return
        snap = self._take_snapshot(copy=not blocking)
        return self._committer.submit(snap, blocking=blocking)

    def _commit_step(self, snap: StepSnapshot) -> dict:
        step = snap.step
        t0 = time.perf_counter()

        by_w: dict[int, list] = {}
        n_bytes_raw = 0
        for name, var in snap.pending.items():
            codec = var.get("codec") or self.cfg.codec
            for rank, offset, arr in var["chunks"]:
                # no tensor crosses: a pre-shuffled chunk leaves the worker
                # only the LZ stage (its encode skips the host shuffle)
                arr = C.outbound_chunk(arr, self.cfg, self.path, codec)
                n_bytes_raw += arr.nbytes
                wid = aggregator_of(rank, self.n_ranks, self.m)
                by_w.setdefault(wid, []).append((name, rank, offset, arr,
                                                 codec))

        # ---- phase 1: PREPARE — fan chunks out, await sealed-shard votes.
        # shm transport: ONE memcpy into the worker's ring per chunk, only
        # the header crosses the queue; a chunk the ring cannot hold right
        # now falls back to pickling that one array (never blocks).
        shm_slots: dict[int, list[int]] = {}
        shm_bytes = fallback_bytes = 0
        try:
            with TRACER.span("transport", path=str(self.path),
                             length=n_bytes_raw):
                for wid, items in by_w.items():
                    ring = self._rings[wid] if self._rings else None
                    wire_items = []
                    tw0 = time.perf_counter()
                    wid_bytes = 0
                    for name, rank, offset, arr, codec in items:
                        meta = None
                        if isinstance(arr, C.PreshuffledChunk):
                            # ship the shuffled bytes; the wrapper's metadata
                            # rides the wire item so the worker can rebuild it
                            meta = {"codec": codec,
                                    "pre": {"dtype": arr.dtype.str,
                                            "shape": arr.shape,
                                            "block": arr.block,
                                            "vmin": arr.vmin,
                                            "vmax": arr.vmax}}
                            arr = arr.data
                        elif codec != self.cfg.codec:
                            meta = {"codec": codec}
                        hdr = (ring.write_array(arr)
                               if ring is not None else None)
                        wid_bytes += arr.nbytes
                        if hdr is not None:
                            shm_slots.setdefault(wid, []).append(hdr.offset)
                            shm_bytes += arr.nbytes
                            sent = hdr
                        else:
                            if ring is not None:
                                fallback_bytes += arr.nbytes
                            sent = arr
                        wire_items.append((name, rank, offset, sent, meta)
                                          if meta is not None
                                          else (name, rank, offset, sent))
                    self._workers[wid][1].put(("step", step, wire_items))
                    if METRICS.enabled:
                        # per-worker transport latency: the straggler axis
                        # the autotuner reads (a slow ring = a slow worker)
                        METRICS.observe("transport",
                                        time.perf_counter() - tw0,
                                        nbytes=wid_bytes, key=f"w{wid}")
            with TRACER.span("prepare", path=str(self.path)):
                acks = self._collect("prepared", by_w, step=step)
        finally:
            # the ack (prepared OR error OR abort) is the free-list: the
            # step is resolved, the worker is done (or dead) — reclaim its
            # slots in allocation order. An aborted step's slots may still
            # be read by a straggling worker, but that step is never
            # committed, so the garbage it might produce is torn-shard
            # dead weight by construction.
            for wid, offs in shm_slots.items():
                for off in offs:
                    self._rings[wid].free(off)
        worker_mets: dict[int, dict] = {}
        for wid, a in acks.items():             # workers ship per-step traces
            trace = a.pop("dxt", None)
            if trace:
                TRACER.ingest(trace)
            met = a.pop("metrics", None)
            if met:
                # fold into the live registry (the jbpd/metrics-op view)
                # AND keep the per-worker shard for this step's journal
                # frame — the two views stay additive-identical
                METRICS.merge(met)
                worker_mets[wid] = met
        merged: dict[str, list] = {name: [] for name in snap.pending}
        for wid in sorted(acks):
            rec = self._read_shard_record(wid, acks[wid], step)
            for name, chunk_list in rec["chunks"].items():
                merged[name].extend(chunk_list)
        t_prepare = time.perf_counter() - t0
        if METRICS.enabled:
            METRICS.observe("prepare", t_prepare, nbytes=n_bytes_raw,
                            key=str(self.path))

        if self._crash_after_prepare:
            raise RuntimeError("simulated coordinator crash between "
                               "prepare and commit")

        # ---- phase 2: COMMIT — merge shard chunk tables into md.0/md.idx
        # (record layout and seal ordering live in bp_engine so every
        # engine commits identically — byte parity is not re-implemented)
        with TRACER.span("commit", path=str(self.path)) as sp:
            md_rec = build_md_record(step, snap.attrs, snap.pending, merged)
            blob = json.dumps(md_rec).encode()
            sp.length = len(blob)
            self._md_off = seal_md_record(
                self._md, self._idx, self._md_off, step, blob,
                fsync_step=self.cfg.fsync_policy == "step")

        dt = time.perf_counter() - t0
        if METRICS.enabled:
            METRICS.observe("commit", dt - t_prepare, nbytes=len(blob),
                            key=str(self.path))
        prof = {"step": step, "write_s": dt, "prepare_s": t_prepare,
                "commit_s": dt - t_prepare,
                "compress_s": sum(a["compress_s"] for a in acks.values()),
                "bytes_raw": n_bytes_raw,
                "bytes_stored": sum(a["bytes_stored"] for a in acks.values()),
                "transport": self.transport,
                "transport_shm_bytes": shm_bytes,
                "transport_pickle_bytes": (fallback_bytes if self._rings
                                           else n_bytes_raw),
                "aggregators": self.m, "writers": self.m,
                "worker_s": {str(wid): acks[wid]["worker_s"]
                             for wid in sorted(acks)}}
        prof.update(snap.extra)
        self._profile.append(prof)
        if self._journal is not None:
            # single-threaded by the commit contract (caller thread, or the
            # committer thread in async mode) — ordered like md.idx appends
            self._journal.frame(step, prof, MONITOR.report()["total"],
                                METRICS.snapshot(reset=True)["hists"],
                                workers=worker_mets)
        return prof

    def drain(self):
        """Durability barrier. Sync mode: no-op (end_step() already commits
        synchronously). async_commit: block until every queued step's
        md.idx record is sealed per the fsync policy."""
        if self._committer is not None:
            self._committer.drain()

    # ------------------------------------------------------------------ close
    def _profile_doc(self) -> dict:
        doc = {"engine": "JBP(BP4-parallel)", "aggregators": self.m,
               "writers": self.m, "codec": self.cfg.codec,
               "transport": self.transport, "steps": self._profile}
        if self._committer is not None:
            doc["async"] = self._committer.profile_block(self._profile)
        return doc

    def overlap_stats(self) -> dict:
        """Live view of the commit-overlap accounting (async_commit)."""
        doc = self._profile_doc()
        return dict(doc.get("async", {}), steps=len(self._profile))

    def _drain_stale_acks(self):
        """Throw away unconsumed result-queue messages (acks of aborted
        steps) so worker feeder threads are never wedged on a full pipe at
        exit — part of the close-cannot-hang contract. Owned-queue path
        only: a plane's queue outlives this writer."""
        try:
            while True:
                self._result_q.get_nowait()
        except _queue.Empty:
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        errors: list[BaseException] = []
        if self._committer is not None:
            try:
                self._committer.shutdown()      # drain; never raises early
            except BaseException as e:          # noqa: BLE001
                errors.append(e)
        fin_mets: dict[int, dict] = {}

        def _absorb(got: dict):
            # keep each worker's residual metrics shard for the journal's
            # final frame BEFORE the payload merge folds it into the live
            # registry — the two views stay additive-identical
            for wid, payload in got.items():
                if isinstance(payload, dict):
                    met = payload.get("metrics")
                    if met:
                        fin_mets[wid] = met
                merge_worker_payload(payload)

        if self._plane is not None:
            # release, don't kill: workers fsync+close this series' files
            # and go back to idle — the plane is reusable immediately
            for wid in range(self.m):
                self._workers[wid][1].put(("finish", None, None))
            try:
                _absorb(self._collect(
                    "finished", [i for i in range(self.m)
                                 if self._workers[i][0].is_alive()]))
            except BaseException as e:          # noqa: BLE001
                errors.append(e)
        else:
            for _, tq in self._workers:
                tq.put(("close", None, None))
            try:
                _absorb(self._collect(
                    "closed", [i for i, (p, _) in enumerate(self._workers)
                               if p.is_alive()]))
            except BaseException as e:          # noqa: BLE001
                errors.append(e)
            # a worker that died mid-step (or is wedged) must not turn
            # close() into a hang: drain stale acks so exiting workers can
            # flush their feeder threads, close the task queues, and
            # terminate anything join() cannot reap
            self._drain_stale_acks()
            for p, tq in self._workers:
                tq.close()
                p.join(timeout=10.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
            if self._ring_finalizer is not None:
                self._ring_finalizer()          # close + unlink every ring
        if self.cfg.fsync_policy != "step":
            self._md.fsync()
            self._idx.fsync()
        self._md.close()
        self._idx.close()
        if self.cfg.profiling:
            with open_file(self.path / "profiling.json", "w", rank=0) as f:
                f.write(json.dumps(self._profile_doc(), indent=1))
        if TRACER.enabled:
            # after the worker merges above: the sidecar is the MERGED
            # coordinator+worker timeline on one wall clock
            TRACER.dump(self.path / "dxt.json")
        if self._journal is not None:
            # final frame: close-time residuals (md fsyncs, profiling.json,
            # each worker's post-last-step shard) — sum over journal frames
            # reproduces the live registry exactly
            self._journal.frame(-1, {"final": True},
                                MONITOR.report()["total"],
                                METRICS.snapshot(reset=True)["hists"],
                                workers=fin_mets)
            self._journal.close()
            self._journal = None
        if self._committer is not None:
            self._committer.check_error()       # background commit failures
        if errors:
            raise errors[0]

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
            return
        try:
            self.close()
        except BaseException:                   # noqa: BLE001
            pass       # the in-flight exception is the root cause; keep it
