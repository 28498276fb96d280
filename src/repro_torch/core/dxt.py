"""DXT-style per-operation I/O tracing (paper §III-D).

The paper's analysis leans on Darshan eXtended Tracing: not just *how
much* I/O each rank did (the `DarshanMonitor` counters) but *when each
operation ran* — which rank wrote which bytes to which subfile at what
time. That per-operation timeline is what exposes stragglers, commit
stalls and serialization that aggregate counters average away. We own the
whole I/O stack, so the trace is explicit rather than LD_PRELOADed:

  * every `InstrumentedFile` op (open/read/write/seek/flush/fsync/close)
    records one event `(rank, path, op, offset, length, t_start, t_end)`
    — offsets come from the handle's own position tracking, exactly what
    DXT's X_POSIX module logs,
  * the planes emit higher-level SPANS for the step lifecycle — snapshot,
    compress, shm transport, shard seal, two-phase commit, cache
    fetch/serve — so the timeline shows the *why* between the POSIX ops,
  * writer worker PROCESSES ship their trace buffers home on the existing
    "prepared"/"finished"/"closed" ack paths next to their Darshan
    counter snapshots; every snapshot carries a per-process CLOCK EPOCH
    (a paired `time.time()`/`time.perf_counter()` sample) so `ingest`
    rebases everything onto one global wall-clock axis — merged timelines
    are comparable across processes (and across hosts, to NTP accuracy).

Cost discipline: tracing OFF is one attribute load + branch per op (the
hot paths check `TRACER.enabled` before calling anything). Tracing ON is
bounded memory — per-thread ring buffers of `capacity` events each;
when a ring fills the OLDEST event is dropped and counted, never blocking
an I/O path (`bench_darshan_costs.run_tracing_overhead` holds the write
path to <= 5% overhead).

Exports:
  * `to_dxt_text(events)` — darshan-parser DXT-style text (`X_POSIX`
    lines per file record, spans as `X_SPAN`),
  * `to_chrome(events)` — Chrome trace-event JSON, loadable in Perfetto
    (chrome://tracing): pid = source process (coordinator / writer worker
    / daemon connection), tid = rank within it,
  * `TRACER.dump(path)` / `load_trace(path)` — the `dxt.json` sidecar the
    writers leave next to `profiling.json`, which `repro.tools.jbpdxt`
    analyzes (timeline summary, per-subfile/OST straggler table,
    bandwidth-over-time).

Enable programmatically (`TRACER.enable()`) or via the environment
(`JBP_DXT=1`, inherited by spawned writer workers); `JBP_DXT_CAPACITY`
overrides the per-thread ring size.

The profiler sink: while a `torch.profiler` session records, every span
also opens a profiler range named `<layer>.<op>` ("bp.encode",
"pic.spawn", "ckpt.publish"), which the profiler exports beside the
kernels, on the device trace's clock: a `record_function` range, which
the trace holds as a `user_annotation` event.
`annotate(name)` opens such a range alone, for work the ring already
logs as POSIX ops (`bp.fsync`, `bp.read`). The profiler sees a range on
the thread that started it, and on every thread with
`_ExperimentalConfig(profile_all_threads=True)`. Whether a session
records is read from `torch.autograd.profiler` in `sys.modules`, so this
module never imports torch. With the ring off, no session recording and
no metrics observation asked for, `span` returns the shared no-op span:
no clock read, no allocation, no device sync.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

from repro_torch.core.metrics import METRICS

DEFAULT_CAPACITY = int(os.environ.get("JBP_DXT_CAPACITY", 1 << 15))

# span vocabulary (the step-lifecycle ops, distinct from the POSIX ops
# recorded by InstrumentedFile): keep these stable — jbpdxt and the
# Chrome export group by them
SPAN_OPS = ("snapshot", "compress", "transport", "prepare", "seal",
            "commit", "pipeline", "cache_fetch", "serve", "read_task",
            "device_shuffle", "d2h_wait", "encode", "append", "decode",
            "publish", "h2d", "deposit", "key", "ionize", "spawn", "push",
            "step", "fwd_bwd", "adamw", "ssd_bwd", "flash_bwd")
POSIX_OPS = ("open", "read", "write", "seek", "flush", "fsync", "close")


class _ThreadBuf:
    """One thread's bounded event ring. Appends are single-threaded (the
    owning thread); snapshots copy under the GIL."""

    __slots__ = ("events", "dropped", "cap")

    def __init__(self, cap: int):
        self.events: deque = deque()
        self.dropped = 0
        self.cap = cap


def _recording():
    """`record_function` while a profiler session records, else None
    (looked up, never imported)."""
    ap = sys.modules.get("torch.autograd.profiler")
    if ap is None or not ap._is_profiler_enabled:
        return None
    return ap.record_function


class _Span:
    """Context manager for one lifecycle span: a profiler range (`rf`)
    while a session records, one ring event on exit while the ring is on
    (`ring`), and one `METRICS` observation of the same interval under
    (op, path) where the site asked for it (`observe`). `length` may be
    set inside the block (e.g. bytes moved by a transport span)."""

    __slots__ = ("_tr", "op", "path", "rank", "length", "_t0", "_rf",
                 "_ring", "_observe")

    def __init__(self, tr: "DxtTracer", op: str, path: str, rank: int,
                 length: int, rf, ring: bool, observe: bool):
        self._tr = tr
        self.op = op
        self.path = path
        self.rank = rank
        self.length = length
        self._rf = rf
        self._ring = ring
        self._observe = observe

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        if self._ring or self._observe:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if self._ring or self._observe:
            t1 = time.perf_counter()
            if self._ring:
                self._tr.record(self.rank, self.path, self.op, 0,
                                self.length, self._t0, t1)
            if self._observe:
                METRICS.observe(self.op, t1 - self._t0, nbytes=self.length,
                                key=self.path)
        if self._rf is not None:
            self._rf.__exit__(*a)
        return False


class _NullSpan:
    """The tracing-off span: no clock reads, no record. One shared
    instance; `length` writes are absorbed by __slots__ on each use."""

    __slots__ = ("length",)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_SPAN = _NullSpan()


class DxtTracer:
    """Process-global per-operation trace recorder.

    Events live in bounded per-thread ring buffers (no locks on the
    record path — each thread appends to its own deque; registration of a
    new thread's buffer is the only locked step). `snapshot()` exports a
    picklable dict with this process's clock epoch; `ingest()` folds
    another process's snapshot in, rebased onto the wall-clock axis;
    `events()` returns the single merged timeline.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.enabled = bool(int(os.environ.get("JBP_DXT", "0") or 0))
        self.src = f"pid{os.getpid()}"
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._bufs: list[_ThreadBuf] = []
        # events ingested from other processes, already on the wall axis:
        # (src, rank, path, op, offset, length, t0, t1)
        self._foreign: list[tuple] = []
        self._foreign_dropped = 0
        self._stamp_epoch()

    def _stamp_epoch(self):
        # paired wall/monotonic sample: everything recorded in this
        # process is rebased wall = perf + (epoch_wall - epoch_perf)
        self.epoch = (time.time(), time.perf_counter())

    # ---------------------------------------------------------------- control
    def enable(self, capacity: Optional[int] = None):
        if capacity is not None:
            self.capacity = int(capacity)
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self, capacity: Optional[int] = None):
        """Drop every recorded and ingested event (buffers of other
        threads included) and restamp the clock epoch."""
        with self._lock:
            if capacity is not None:
                self.capacity = int(capacity)
            for b in self._bufs:
                b.events.clear()
                b.dropped = 0
                b.cap = self.capacity
            self._foreign = []
            self._foreign_dropped = 0
            self.src = f"pid{os.getpid()}"
            self._stamp_epoch()

    # ----------------------------------------------------------------- record
    def _register(self) -> _ThreadBuf:
        buf = _ThreadBuf(self.capacity)
        with self._lock:
            self._bufs.append(buf)
        self._tls.buf = buf
        return buf

    def record(self, rank: int, path: str, op: str, offset: int, length: int,
               t0: float, t1: float):
        """Append one event to the calling thread's ring (oldest-dropped
        when full — I/O never blocks on its own trace)."""
        if not self.enabled:
            return
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._register()
        ev = buf.events
        if len(ev) >= buf.cap:
            ev.popleft()
            buf.dropped += 1
        ev.append((rank, path, op, offset, length, t0, t1))

    def span(self, op: str, path: str = "", rank: int = 0, length: int = 0,
             *, layer: str = "bp", observe: bool = False):
        """Lifecycle span context manager: a ring event while the ring is
        on, a `<layer>.<op>` range while a profiler records, and with
        `observe` a `METRICS.observe(op, seconds, nbytes=length,
        key=path)` while the metrics plane is on; the shared no-op span
        when none of these is."""
        rng = _recording()
        observe = observe and METRICS.enabled
        if not (self.enabled or observe or rng is not None):
            return _NULL_SPAN
        rf = None if rng is None else rng(f"{layer}.{op}")
        return _Span(self, op, path, rank, length, rf, self.enabled, observe)

    @staticmethod
    def annotate(name: str):
        """A profiler range named `name` while a session records, else the
        shared no-op span; nothing goes to the ring."""
        rng = _recording()
        return _NULL_SPAN if rng is None else rng(name)

    @staticmethod
    def now() -> float:
        """The trace clock (perf_counter) — for callers timing raw events
        by hand instead of through `span`."""
        return time.perf_counter()

    # ------------------------------------------------------- snapshot / merge
    def snapshot(self, reset: bool = False) -> dict:
        """Picklable dump of this PROCESS's own events (not ingested
        foreign ones) — what a writer worker ships home on its ack.
        `reset=True` clears the shipped buffers (per-step deltas)."""
        with self._lock:
            bufs = list(self._bufs)
        events: list = []
        dropped = 0
        for b in bufs:
            events.extend(b.events)     # atomic copy under the GIL
            dropped += b.dropped
            if reset:
                b.events.clear()
                b.dropped = 0
        events.sort(key=lambda e: e[5])
        return {"src": self.src, "epoch": list(self.epoch),
                "dropped": dropped, "events": [list(e) for e in events]}

    def ingest(self, snap: Optional[dict]):
        """Fold another process's `snapshot()` into the merged timeline,
        rebasing its perf_counter timestamps onto the wall-clock axis via
        its shipped epoch."""
        if not snap or not (snap.get("events") or snap.get("dropped")):
            return
        ew, ep = snap.get("epoch", (0.0, 0.0))
        shift = ew - ep
        src = snap.get("src", "?")
        rebased = [(src, r, p, o, off, ln, t0 + shift, t1 + shift)
                   for r, p, o, off, ln, t0, t1 in snap.get("events", ())]
        with self._lock:
            self._foreign.extend(rebased)
            self._foreign_dropped += int(snap.get("dropped", 0))

    def events(self) -> list[tuple]:
        """The single merged timeline: own events (rebased with this
        process's epoch) + every ingested snapshot, sorted by t_start.
        Tuples: (src, rank, path, op, offset, length, t0, t1) — t0/t1 are
        wall-clock seconds on one shared axis."""
        shift = self.epoch[0] - self.epoch[1]
        own = self.snapshot()
        merged = [(self.src, r, p, o, off, ln, t0 + shift, t1 + shift)
                  for r, p, o, off, ln, t0, t1 in own["events"]]
        with self._lock:
            merged.extend(self._foreign)
        merged.sort(key=lambda e: e[6])
        return merged

    def dropped(self) -> int:
        with self._lock:
            own = sum(b.dropped for b in self._bufs)
            return own + self._foreign_dropped

    def stats(self) -> dict:
        """The `jbpd --stats` / parser_dump summary block."""
        with self._lock:
            n_own = sum(len(b.events) for b in self._bufs)
            n_foreign = len(self._foreign)
        return {"enabled": self.enabled, "events": n_own + n_foreign,
                "dropped": self.dropped(), "capacity": self.capacity}

    # ------------------------------------------------------------ persistence
    def dump(self, path) -> dict:
        """Write the merged timeline as the `dxt.json` sidecar (next to
        profiling.json). Returns the document written."""
        doc = {"format": "jbp-dxt-1", "generated": time.time(),
               "dropped": self.dropped(),
               "events": [list(e) for e in self.events()]}
        # raw open() on purpose: the sidecar is the tracer's OWN output —
        # routing it through InstrumentedFile would trace the trace dump
        with open(str(path), "w") as f:   # jbplint: disable=JBP002
            json.dump(doc, f)
        return doc


def load_trace(path) -> dict:
    """Read a `dxt.json` sidecar back: {"events": [tuples], "dropped": n}.
    Accepts a series directory (looks for dxt.json inside) or the file."""
    p = str(path)
    if os.path.isdir(p):
        p = os.path.join(p, "dxt.json")
    # raw open() on purpose: reading the tracer's own sidecar through
    # InstrumentedFile would pollute the counters the trace is explaining
    with open(p) as f:   # jbplint: disable=JBP002
        doc = json.load(f)
    if doc.get("format") != "jbp-dxt-1":
        raise ValueError(f"{p}: not a jbp DXT trace (format="
                         f"{doc.get('format')!r})")
    doc["events"] = [tuple(e) for e in doc.get("events", [])]
    return doc


# -------------------------------------------------------------------- exports
def to_chrome(events, dropped: int = 0) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing loadable).

    pid <-> source process (coordinator, each writer worker, the daemon),
    tid <-> rank/worker/connection within it. POSIX ops and lifecycle
    spans are complete ("X") events; process names arrive as "M" metadata
    records. Timestamps are microseconds relative to the earliest event.
    """
    srcs: dict[str, int] = {}
    out: list[dict] = []
    t_base = min((e[6] for e in events), default=0.0)
    for src, rank, path, op, off, ln, t0, t1 in events:
        pid = srcs.setdefault(src, len(srcs) + 1)
        ev = {"name": op, "cat": "span" if op in SPAN_OPS else "posix",
              "ph": "X", "pid": pid, "tid": int(rank),
              "ts": (t0 - t_base) * 1e6,
              "dur": max((t1 - t0) * 1e6, 0.001),
              "args": {"path": path, "offset": int(off),
                       "length": int(ln)}}
        out.append(ev)
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": src}} for src, pid in srcs.items()]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms",
            "otherData": {"format": "jbp-dxt-1", "dropped": int(dropped)}}


def to_dxt_text(events, dropped: int = 0) -> str:
    """darshan-parser DXT-style text: one block per file record with
    X_POSIX lines (rank, op, segment, offset, length, start, end), then
    an X_SPAN module for the lifecycle spans. Times are seconds relative
    to the earliest event, like darshan's job-relative timestamps."""
    t_base = min((e[6] for e in events), default=0.0)
    lines = ["# DXT-style trace (repro/core/dxt.py)",
             f"# events: {len(events)}  dropped: {dropped}"]
    by_file: dict[str, list] = {}
    spans: list = []
    for e in events:
        (spans if e[3] in SPAN_OPS else
         by_file.setdefault(e[2], [])).append(e)
    for path in sorted(by_file):
        lines.append("#")
        lines.append(f"# DXT, file_name: {path}")
        lines.append("# Module\tRank\tOp\tSegment\tOffset\tLength\t"
                     "Start(s)\tEnd(s)")
        seg: dict[int, int] = {}
        for src, rank, _p, op, off, ln, t0, t1 in by_file[path]:
            s = seg.get(rank, 0)
            seg[rank] = s + 1
            lines.append(f" X_POSIX\t{rank}\t{op}\t{s}\t{off}\t{ln}\t"
                         f"{t0 - t_base:.6f}\t{t1 - t_base:.6f}")
    if spans:
        lines.append("#")
        lines.append("# DXT, module: X_SPAN (step lifecycle)")
        lines.append("# Module\tRank\tOp\tSrc\tLength\tStart(s)\tEnd(s)")
        for src, rank, path, op, off, ln, t0, t1 in spans:
            lines.append(f" X_SPAN\t{rank}\t{op}\t{src}\t{ln}\t"
                         f"{t0 - t_base:.6f}\t{t1 - t_base:.6f}")
    return "\n".join(lines)


TRACER = DxtTracer()
