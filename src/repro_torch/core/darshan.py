"""Darshan-style I/O monitoring.

The paper (§III-D) uses Darshan's LD_PRELOAD interposition to attribute I/O
time per process to reads / writes / metadata. We own the whole I/O stack, so
instrumentation is explicit: every file op in the framework goes through
`InstrumentedFile`, and `DarshanMonitor` keeps darshan-parser-style counters
per (rank, file) — POSIX_OPENS, POSIX_WRITES, POSIX_BYTES_WRITTEN,
F_WRITE_TIME, F_META_TIME, ... plus access-size histograms and a time heatmap.

Thread-safe: aggregator writer pools hammer this concurrently.
"""
from __future__ import annotations

import difflib
import os
import threading
import time
from collections import defaultdict
from typing import Optional

from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS


class _FrozenCounterRegistry:
    """The single source of truth for every legal counter name. A typo'd
    literal at a call site used to silently mint a brand-new counter —
    now `record()` validates against `KNOWN_COUNTERS` at runtime, jbplint
    (JBP003) keeps call sites on these constants statically, and the
    namespace itself is frozen so nobody grows it from the outside."""

    # POSIX op/byte counters (darshan-parser names)
    POSIX_OPENS = "POSIX_OPENS"
    POSIX_READS = "POSIX_READS"
    POSIX_WRITES = "POSIX_WRITES"
    POSIX_SEEKS = "POSIX_SEEKS"
    POSIX_FLUSHES = "POSIX_FLUSHES"
    POSIX_FSYNCS = "POSIX_FSYNCS"
    POSIX_CLOSES = "POSIX_CLOSES"
    POSIX_STATS = "POSIX_STATS"
    POSIX_BYTES_READ = "POSIX_BYTES_READ"
    POSIX_BYTES_WRITTEN = "POSIX_BYTES_WRITTEN"
    # per-class time accumulators (Fig-5-style read/write/meta attribution)
    F_READ_TIME = "F_READ_TIME"
    F_WRITE_TIME = "F_WRITE_TIME"
    F_META_TIME = "F_META_TIME"
    # chunk-transport accounting for the parallel write plane: bytes that
    # moved coordinator->worker through shared-memory rings vs the pickle
    # fallback (recorded by the WORKER, shipped home on its ack and merged)
    TRANSPORT_SHM_BYTES = "TRANSPORT_SHM_BYTES"
    TRANSPORT_PICKLE_FALLBACK_BYTES = "TRANSPORT_PICKLE_FALLBACK_BYTES"
    # served-read accounting for the jbpd data service: decompressed-chunk
    # cache hits/misses, requests COALESCED onto another client's in-flight
    # fetch, and response bytes handed off zero-copy via ShmRing vs framed
    SERVICE_CACHE_HIT = "SERVICE_CACHE_HIT"
    SERVICE_CACHE_MISS = "SERVICE_CACHE_MISS"
    SERVICE_COALESCED = "SERVICE_COALESCED"
    SERVICE_SHM_BYTES = "SERVICE_SHM_BYTES"
    SERVICE_SOCKET_BYTES = "SERVICE_SOCKET_BYTES"
    # device-side compression plane (repro_torch.core.compression device path):
    # bytes byte-shuffled on-accelerator before the host LZ stage, host-LZ
    # seconds that ran while a later block was still in the device/D2H
    # stage (the double-buffered overlap win), and raw-minus-stored bytes
    # for payloads encoded by the error-bounded lossy codec
    COMPRESS_DEVICE_BYTES = "COMPRESS_DEVICE_BYTES"
    COMPRESS_OVERLAP_TIME = "COMPRESS_OVERLAP_TIME"
    LOSSY_BYTES_SAVED = "LOSSY_BYTES_SAVED"
    # host-codec seconds decoding stored payloads on the read side (the
    # inflate and unshuffle of `BpReader`), summed over reading threads
    DECOMPRESS_TIME = "DECOMPRESS_TIME"
    # DXT trace summary fields (parser_dump / jbpd watch frames). These are
    # REPORT keys, never recorded directly, so they are excluded from
    # KNOWN_COUNTERS below.
    DXT_ENABLED = "dxt_enabled"
    DXT_EVENTS = "dxt_events"
    DXT_DROPPED = "dxt_dropped"
    DXT_OP = "dxt_op"

    def __setattr__(self, name, value):
        raise AttributeError(
            "the counter registry is frozen — add new counters in "
            "repro_torch.core.darshan._FrozenCounterRegistry, not at call sites")


CTR = _FrozenCounterRegistry()

#: every name `record()` accepts (the recordable counter families)
KNOWN_COUNTERS = frozenset(
    v for k, v in vars(_FrozenCounterRegistry).items()
    if k.isupper() and isinstance(v, str) and not v.startswith("dxt_"))


def _unknown_counter(name) -> str:
    close = difflib.get_close_matches(str(name), sorted(KNOWN_COUNTERS), n=1)
    hint = f" — did you mean {close[0]!r}?" if close else ""
    return (f"unknown Darshan counter {name!r}; counters are frozen in "
            f"repro_torch.core.darshan.CTR{hint}")


_COUNTER_KEYS = (
    CTR.POSIX_OPENS, CTR.POSIX_READS, CTR.POSIX_WRITES, CTR.POSIX_SEEKS,
    CTR.POSIX_FLUSHES, CTR.POSIX_FSYNCS, CTR.POSIX_CLOSES, CTR.POSIX_STATS,
    CTR.POSIX_BYTES_READ, CTR.POSIX_BYTES_WRITTEN,
)
_TIME_KEYS = (CTR.F_READ_TIME, CTR.F_WRITE_TIME, CTR.F_META_TIME)
_TRANSPORT_KEYS = (CTR.TRANSPORT_SHM_BYTES,
                   CTR.TRANSPORT_PICKLE_FALLBACK_BYTES)
_SERVICE_KEYS = (CTR.SERVICE_CACHE_HIT, CTR.SERVICE_CACHE_MISS,
                 CTR.SERVICE_COALESCED, CTR.SERVICE_SHM_BYTES,
                 CTR.SERVICE_SOCKET_BYTES)
_COMPRESS_KEYS = (CTR.COMPRESS_DEVICE_BYTES, CTR.COMPRESS_OVERLAP_TIME,
                  CTR.LOSSY_BYTES_SAVED, CTR.DECOMPRESS_TIME)

_SIZE_BINS = (100, 1024, 10 * 1024, 100 * 1024, 1024**2, 4 * 1024**2,
              10 * 1024**2, 100 * 1024**2)


def _size_bin(n: int) -> str:
    lo = 0
    for hi in _SIZE_BINS:
        if n <= hi:
            return f"{lo}-{hi}"
        lo = hi
    return f">{_SIZE_BINS[-1]}"


class DarshanMonitor:
    """Global singleton registry of I/O counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with getattr(self, "_lock", threading.Lock()):
            self._t0 = time.perf_counter()
            # wall-clock instant of _t0: shipped in snapshot() so merge()
            # can rebase another process's heatmap bins onto THIS monitor's
            # time base (each process's bins are relative to its private
            # _t0 — superimposing them raw misaligns the timelines)
            self._t0_epoch = time.time()
            self._per_rank = defaultdict(lambda: defaultdict(float))
            self._per_file = defaultdict(lambda: defaultdict(float))
            self._size_hist = defaultdict(float)
            self._heatmap = defaultdict(float)      # (rank, time_bin) -> bytes
            self.heatmap_bin_s = 0.1

    # ------------------------------------------------------------------ record
    def record(self, rank: int, path: str, counter: str, inc: float = 1.0,
               tkey: Optional[str] = None, dt: float = 0.0, nbytes: int = 0):
        if counter not in KNOWN_COUNTERS:
            raise KeyError(_unknown_counter(counter))
        if tkey is not None and tkey not in KNOWN_COUNTERS:
            raise KeyError(_unknown_counter(tkey))
        with self._lock:
            r = self._per_rank[rank]
            f = self._per_file[path]
            r[counter] += inc
            f[counter] += inc
            if tkey:
                r[tkey] += dt
                f[tkey] += dt
            if nbytes:
                bkey = (CTR.POSIX_BYTES_WRITTEN if "WRITE" in counter
                        else CTR.POSIX_BYTES_READ)
                r[bkey] += nbytes
                f[bkey] += nbytes
                self._size_hist[_size_bin(nbytes)] += 1
                tbin = int((time.perf_counter() - self._t0) / self.heatmap_bin_s)
                self._heatmap[(rank, tbin)] += nbytes

    # -------------------------------------------------------- snapshot / merge
    def snapshot(self) -> dict:
        """Plain-dict (picklable) dump of every raw counter — what a writer/
        reader WORKER PROCESS ships back to the coordinator on its ack, so
        `parser_dump` in the parent covers the whole I/O plane, not just the
        coordinator's own file ops."""
        with self._lock:
            return {
                "per_rank": {r: dict(c) for r, c in self._per_rank.items()},
                "per_file": {p: dict(c) for p, c in self._per_file.items()},
                "size_hist": dict(self._size_hist),
                "heatmap": [[r, b, v] for (r, b), v in self._heatmap.items()],
                "epoch": self._t0_epoch,
                "bin_s": self.heatmap_bin_s,
            }

    def merge(self, snap: dict):
        """Fold a `snapshot()` from another process into this monitor
        (additive on every counter). Heatmap bins are REBASED via the
        snapshot's clock epoch: bin b of the source covers wall time
        `src_epoch + b*bin_s`, which lands at a different bin index on
        this monitor's axis — two monitors started at different times
        must not superimpose their timelines at bin 0."""
        if not snap:
            return
        with self._lock:
            for r, counters in snap.get("per_rank", {}).items():
                dst = self._per_rank[r]
                for k, v in counters.items():
                    dst[k] += v
            for p, counters in snap.get("per_file", {}).items():
                dst = self._per_file[p]
                for k, v in counters.items():
                    dst[k] += v
            for k, v in snap.get("size_hist", {}).items():
                self._size_hist[k] += v
            src_epoch = snap.get("epoch")
            src_bin = snap.get("bin_s", self.heatmap_bin_s)
            for r, b, v in snap.get("heatmap", []):
                if src_epoch is not None:
                    t = src_epoch + b * src_bin       # wall time of the bin
                    b = int((t - self._t0_epoch) / self.heatmap_bin_s)
                self._heatmap[(r, max(b, 0))] += v

    # ------------------------------------------------------------------ report
    def report(self, n_procs: Optional[int] = None) -> dict:
        """n_procs: logical process count to normalize by (aggregated writes
        are attributed to aggregator ids, so 'observed ranks' undercounts the
        job size — pass the real rank count for per-process numbers)."""
        with self._lock:
            ranks = sorted(self._per_rank)
            agg: dict[str, float] = defaultdict(float)
            for r in ranks:
                for k, v in self._per_rank[r].items():
                    agg[k] += v
            n = max(n_procs if n_procs else len(ranks), 1)
            per_proc = {k: agg.get(k, 0.0) / n
                        for k in (_COUNTER_KEYS + _TIME_KEYS +
                                  _TRANSPORT_KEYS + _SERVICE_KEYS +
                                  _COMPRESS_KEYS)}
            return {
                "n_ranks": len(ranks),
                "total": dict(agg),
                "avg_per_process": per_proc,
                "files": {p: dict(c) for p, c in self._per_file.items()},
                "access_size_histogram": dict(self._size_hist),
            }

    def cost_per_process(self, n_procs: Optional[int] = None) -> dict:
        """Fig-5-style: average seconds per process for reads/writes/meta."""
        rep = self.report(n_procs)["avg_per_process"]
        return {"read_s": rep["F_READ_TIME"], "write_s": rep["F_WRITE_TIME"],
                "meta_s": rep["F_META_TIME"]}

    def heatmap(self) -> dict:
        with self._lock:
            return {f"rank{r}@{b * self.heatmap_bin_s:.1f}s": v
                    for (r, b), v in sorted(self._heatmap.items())}

    def total_files_written(self) -> int:
        rep = self.report()
        return sum(1 for p, c in rep["files"].items()
                   if c.get("POSIX_BYTES_WRITTEN", 0) > 0)

    def parser_dump(self, n_procs: Optional[int] = None) -> str:
        """darshan-parser-style text report (one block per file record)."""
        rep = self.report(n_procs)
        lines = ["# darshan-style report (repro/core/darshan.py)",
                 f"# nprocs: {n_procs or rep['n_ranks']}", "#"]
        lines.append("# <counter> <value> — job totals")
        for k in (_COUNTER_KEYS + _TIME_KEYS + _TRANSPORT_KEYS
                  + _SERVICE_KEYS + _COMPRESS_KEYS):
            lines.append(f"total_{k}\t{rep['total'].get(k, 0.0):.6f}")
        lines.append("#")
        lines.append("# per-file records")
        for path, c in sorted(rep["files"].items()):
            lines.append(f"file\t{path}")
            for k in sorted(c):
                lines.append(f"\t{k}\t{c[k]:.6f}")
        lines.append("#")
        lines.append("# access size histogram")
        for k, v in sorted(rep["access_size_histogram"].items()):
            lines.append(f"hist\t{k}\t{v:.0f}")
        # DXT trace summary — per-operation tracing state (repro_torch.core.dxt);
        # always emitted so consumers can parse the block unconditionally
        ts = TRACER.stats()
        lines.append("#")
        lines.append("# DXT trace summary (per-operation tracing)")
        lines.append(f"dxt_enabled\t{1 if ts['enabled'] else 0}")
        lines.append(f"dxt_events\t{ts['events']}")
        lines.append(f"dxt_dropped\t{ts['dropped']}")
        if ts["events"]:
            by_op: dict[str, int] = {}
            for _s, _r, _p, op, _o, _l, _t0, _t1 in TRACER.events():
                by_op[op] = by_op.get(op, 0) + 1
            for op in sorted(by_op):
                lines.append(f"dxt_op\t{op}\t{by_op[op]}")
        return "\n".join(lines)


MONITOR = DarshanMonitor()


class InstrumentedFile:
    """File handle that reports every op to the monitor — and, when DXT
    tracing is on, records one `(rank, path, op, offset, length, t0, t1)`
    event per op (offsets from the handle's own position tracking; the
    trace costs one branch per op while disabled)."""

    def __init__(self, path: str, mode: str, rank: int = 0,
                 monitor: DarshanMonitor = MONITOR):
        self.path = str(path)
        self.rank = rank
        self.mon = monitor
        t0 = time.perf_counter()
        # the one legitimate raw open(): this IS the instrumentation
        # primitive every other file op routes through
        self._f = open(self.path, mode)   # jbplint: disable=JBP002
        t1 = time.perf_counter()
        self._pos = self._f.tell()          # append modes start at EOF
        self.mon.record(rank, self.path, CTR.POSIX_OPENS, 1.0, CTR.F_META_TIME,
                        t1 - t0)
        if TRACER.enabled:
            TRACER.record(rank, self.path, "open", self._pos, 0, t0, t1)

    def write(self, data) -> int:
        t0 = time.perf_counter()
        n = self._f.write(data)
        t1 = time.perf_counter()
        nb = n if isinstance(n, int) else len(data)
        off = self._pos
        self._pos = off + nb
        self.mon.record(self.rank, self.path, CTR.POSIX_WRITES, 1.0,
                        CTR.F_WRITE_TIME, t1 - t0, nbytes=nb)
        if TRACER.enabled:
            TRACER.record(self.rank, self.path, "write", off, nb, t0, t1)
        if METRICS.enabled:
            METRICS.observe("write", t1 - t0, nbytes=nb, key=self.path)
        return nb

    def read(self, n: int = -1):
        t0 = time.perf_counter()
        data = self._f.read(n)
        t1 = time.perf_counter()
        off = self._pos
        self._pos = off + len(data)
        self.mon.record(self.rank, self.path, CTR.POSIX_READS, 1.0,
                        CTR.F_READ_TIME, t1 - t0, nbytes=len(data))
        if TRACER.enabled:
            TRACER.record(self.rank, self.path, "read", off, len(data),
                          t0, t1)
        if METRICS.enabled:
            METRICS.observe("read", t1 - t0, nbytes=len(data), key=self.path)
        return data

    def seek(self, off: int, whence: int = 0):
        t0 = time.perf_counter()
        r = self._f.seek(off, whence)
        t1 = time.perf_counter()
        self._pos = self._f.tell() if whence else off
        self.mon.record(self.rank, self.path, CTR.POSIX_SEEKS, 1.0,
                        CTR.F_META_TIME, t1 - t0)
        if TRACER.enabled:
            TRACER.record(self.rank, self.path, "seek", self._pos, 0, t0, t1)
        return r

    def tell(self) -> int:
        return self._f.tell()

    def flush(self):
        """Userspace-buffer flush (write(2) without the fsync barrier) —
        metadata time that used to be invisible to the monitor."""
        t0 = time.perf_counter()
        self._f.flush()
        t1 = time.perf_counter()
        self.mon.record(self.rank, self.path, CTR.POSIX_FLUSHES, 1.0,
                        CTR.F_META_TIME, t1 - t0)
        if TRACER.enabled:
            TRACER.record(self.rank, self.path, "flush", self._pos, 0, t0, t1)

    def fsync(self):
        with TRACER.annotate("bp.fsync"):
            t0 = time.perf_counter()
            self._f.flush()
            os.fsync(self._f.fileno())
            t1 = time.perf_counter()
        self.mon.record(self.rank, self.path, CTR.POSIX_FSYNCS, 1.0,
                        CTR.F_META_TIME, t1 - t0)
        if TRACER.enabled:
            TRACER.record(self.rank, self.path, "fsync", self._pos, 0, t0, t1)
        if METRICS.enabled:
            METRICS.observe("fsync", t1 - t0, key=self.path)

    def close(self):
        t0 = time.perf_counter()
        self._f.close()
        t1 = time.perf_counter()
        self.mon.record(self.rank, self.path, CTR.POSIX_CLOSES, 1.0,
                        CTR.F_META_TIME, t1 - t0)
        if TRACER.enabled:
            TRACER.record(self.rank, self.path, "close", self._pos, 0, t0, t1)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_file(path, mode, rank: int = 0,
              monitor: DarshanMonitor = MONITOR) -> InstrumentedFile:
    return InstrumentedFile(path, mode, rank=rank, monitor=monitor)


def merge_worker_payload(payload, monitor: DarshanMonitor = MONITOR,
                         tracer=TRACER, metrics=METRICS):
    """Merge one worker's "finished"/"closed"/ack payload into this
    process's monitor (and tracer/metrics registry). Instrumented workers
    ship `{"darshan": <monitor snapshot>, "dxt": <tracer snapshot>,
    "metrics": <registry snapshot>}` (each key optional); workers with
    tracing off (and pre-DXT peers) ship the bare monitor snapshot."""
    if not isinstance(payload, dict):
        return
    if "darshan" in payload or "dxt" in payload or "metrics" in payload:
        snap = payload.get("darshan")
        if snap:
            monitor.merge(snap)
        trace = payload.get("dxt")
        if trace:
            tracer.ingest(trace)
        hist = payload.get("metrics")
        if hist:
            metrics.merge(hist)
    else:
        monitor.merge(payload)
