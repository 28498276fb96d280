"""JBP — the BP4-style log-structured parallel write engine (paper Fig 1).

Directory layout mirrors ADIOS2 BP4:

    <name>.bp4/
      data.0 .. data.M-1    aggregated subfiles (optionally Lustre-striped
                            across emulated OSTs: ost<k>/data.<m>.obj)
      md.0                  per-step variable metadata (chunk tables)
      md.idx                fixed-size index records -> rapid metadata scan
      profiling.json        per-step engine timings (ADIOS2-compatible idea)

Write protocol per step (all ranks logical):
  1. every rank `put()`s its chunks (numpy views — zero copy),
  2. `end_step()` compresses chunks (codec from EngineConfig), assigns
     rank -> aggregator, and the work-stealing WriterPool appends payloads
     to the M subfiles,
  3. the chunk table (rank, box, subfile, offset, nbytes) goes to md.0,
     then a crc-sealed 64-byte record goes to md.idx — a step is durable
     iff its idx record validates, which is the crash-consistency story.

Reads never touch subfiles until the box intersection says so: md.idx ->
md.0 -> exact byte ranges. Arbitrary box selections let a restarted job
with a different mesh read exactly the bytes each new shard needs
(elastic re-sharding).

Async pipeline: `end_step()` is factored into `_take_snapshot()` (capture
the step's chunks + attrs) and `_write_step(snapshot)` (compress, assign
aggregators, append subfiles, seal metadata). `BpWriter` runs both inline;
`repro_torch.core.async_engine.AsyncBpWriter` enqueues snapshots onto a bounded
in-flight queue and runs `_write_step` on a background writer thread, so
computation overlaps I/O. Durability semantics are IDENTICAL in both modes:
a step is durable iff its crc-sealed md.idx record validates, sync and
async writers produce byte-identical data.* and md.0 files for the same
puts, and `fsync_policy="step"` always means the seal (fsync of md.0 and
md.idx) has happened before `end_step` returns to the producer.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import struct
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np

from repro_torch.core import compression as C
from repro_torch.core.aggregation import (AggregatorConfig, SubfileSet, WriterPool,
                                    aggregator_of)
from repro_torch.core.darshan import CTR, MONITOR, open_file
from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS, StepJournal, journal_path
from repro_torch.core.reader_pool import ReaderPool
from repro_torch.core.striping import OstPool, StripeConfig, StripedFile

IDX_RECORD = struct.Struct("<QQQIIQQQ")   # step, md_off, md_len, crc, flags, t_ns, reserved x2
IDX_SIZE = IDX_RECORD.size


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    aggregators: int = 1
    # none | blosc | bzip2 | zlib | lossy:<abs> | lossy:rel:<rel>
    codec: str = "none"
    compression_block: int = C.DEFAULT_BLOCK
    # run the blosc byte-shuffle preconditioner ON-DEVICE for tensor puts
    # (kernels/bitshuffle CUDA kernel + async D2H overlapping the host
    # Z_RLE stage); host/numpy puts are unaffected
    device_compress: bool = False
    stripe: Optional[StripeConfig] = None
    n_osts: int = 4
    workers: int = 4
    profiling: bool = True
    # "close": BP4-style — metadata buffered, fsync once at series close
    #          (max throughput; a crash loses only the current series).
    # "step":  fsync md.0+md.idx every step (checkpoint durability).
    fsync_policy: str = "close"


@dataclasses.dataclass
class ChunkMeta:
    rank: int
    offset: tuple
    extent: tuple
    agg: int
    file_offset: int
    nbytes: int
    # per-block value statistics, ADIOS2-style: recorded in md.0 at write
    # time so min/max queries never decompress a payload. None for empty
    # or non-numeric blocks (and for series written before stats existed).
    vmin: Optional[float] = None
    vmax: Optional[float] = None

    def to_json(self):
        d = {"rank": self.rank, "offset": list(self.offset),
             "extent": list(self.extent), "agg": self.agg,
             "foff": self.file_offset, "nbytes": self.nbytes}
        if self.vmin is not None:
            d["min"] = self.vmin
            d["max"] = self.vmax
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ChunkMeta":
        return cls(d["rank"], tuple(d["offset"]), tuple(d["extent"]),
                   d["agg"], d["foff"], d["nbytes"],
                   d.get("min"), d.get("max"))


def chunk_stats(arr: np.ndarray) -> tuple[Optional[float], Optional[float]]:
    """(min, max) of a block, or (None, None) when undefined. NaNs are
    ignored; stats are recorded only when both bounds are FINITE, so md.0
    stays strict JSON (a bare NaN/Infinity token would break every
    standards-compliant consumer of `jbpls --json`)."""
    if arr.size == 0 or arr.dtype.kind not in "iufb":
        return None, None
    lo, hi = float(arr.min()), float(arr.max())
    if arr.dtype.kind == "f" and not (np.isfinite(lo) and np.isfinite(hi)):
        finite = arr[np.isfinite(arr)]        # rare path: NaN/inf present
        if finite.size == 0:
            return None, None
        return float(finite.min()), float(finite.max())
    return lo, hi


def finite_stats(vmin: float, vmax: float, kind: str,
                 size: int) -> tuple[Optional[float], Optional[float]]:
    """The `chunk_stats` contract applied to bounds computed ELSEWHERE
    (device-side reductions, PreshuffledChunk metadata): record only
    finite bounds of ordered dtypes, else (None, None)."""
    if size == 0 or kind not in "iufb":
        return None, None
    if not (math.isfinite(vmin) and math.isfinite(vmax)):
        return None, None
    return float(vmin), float(vmax)


def encode_chunk(arr, codec: str, block: int, *, device_compress: bool = False):
    """Compress ONE chunk whatever its form — numpy ndarray (host path),
    torch tensor (on-device shuffle + D2H overlapping the host LZ stage
    when `device_compress`, else materialized to host first), or a
    `PreshuffledChunk` from an upstream preconditioner (host finishes the
    encode, shuffle skipped). Returns
    (payload, extent_shape, (vmin, vmax), DeviceStats | None) — the ONE
    chunk encode shared by the thread-pool engine's agg jobs and the
    multi-process engine's workers, so payload bytes cannot drift."""
    if isinstance(arr, C.PreshuffledChunk):
        return (C.array_payload_preshuffled(arr, codec), arr.shape,
                finite_stats(arr.vmin, arr.vmax, arr.dtype.kind, arr.size),
                None)
    if C.is_device_array(arr):
        if device_compress:
            payload, ds = C.device_array_payload(arr, codec, block=block)
            kind = C.np_dtype(arr.dtype).kind
            return (payload, tuple(arr.shape),
                    finite_stats(ds.vmin, ds.vmax, kind, arr.numel()), ds)
        arr = arr.cpu().numpy()
    payload = C.array_payload(arr, codec, block=block)
    return payload, arr.shape, chunk_stats(arr), None


def record_compress_counters(rank: int, path: str, codec: str,
                             raw_nbytes: int, payload_len: int, dstats):
    """Fold one encoded chunk's device/lossy accounting into the Darshan
    monitor: on-chip shuffled bytes + overlapped host-LZ seconds (device
    path) and raw-minus-stored bytes for lossy-coded payloads."""
    if dstats is not None and dstats.device_bytes:
        MONITOR.record(rank, path, CTR.COMPRESS_DEVICE_BYTES,
                       inc=float(dstats.device_bytes),
                       tkey=CTR.COMPRESS_OVERLAP_TIME, dt=dstats.overlap_s)
    if C.parse_codec(codec)[0] == "lossy" and payload_len < raw_nbytes:
        MONITOR.record(rank, path, CTR.LOSSY_BYTES_SAVED,
                       inc=float(raw_nbytes - payload_len))


def validate_put_rank(rank: int, n_ranks: int):
    """The put() boundary check — an out-of-range rank must be a clear
    ValueError here, not an opaque IndexError deep in SubfileSet."""
    if not 0 <= rank < n_ranks:
        raise ValueError(
            f"put(rank={rank}) out of range for a writer opened with "
            f"n_ranks={n_ranks} (valid ranks are 0..{n_ranks - 1})")


def build_md_record(step: int, attrs: dict, pending: dict,
                    chunks_json: dict[str, list]) -> dict:
    """The global per-step metadata record written to md.0 — THE one
    definition of the on-disk chunk-table layout and ordering. Shared by
    the sync, async and multi-process writers: byte parity across engines
    (and therefore reader compatibility) depends on every writer building
    its record here."""
    return {
        "step": step,
        "attrs": attrs,
        "vars": {
            name: {"dtype": var["dtype"], "shape": list(var["shape"]),
                   "chunks": sorted(chunks_json[name],
                                    key=lambda c: (c["rank"],
                                                   tuple(c["offset"])))}
            for name, var in pending.items()},
    }


def seal_md_record(md, idx, md_off: int, step: int, blob: bytes,
                   *, fsync_step: bool) -> int:
    """Append one md.0 blob and its crc-sealed md.idx record — the commit
    point of every engine. With `fsync_step` the seal is durable before
    returning (md.0 fsynced BEFORE the idx record exists, so a validated
    idx record always points at durable metadata); otherwise bytes reach
    the OS and the fsync is deferred to close. Returns the new md offset."""
    with TRACER.span("seal", path=getattr(idx, "path", ""),
                     length=len(blob), observe=True):
        md.write(blob)
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        rec = IDX_RECORD.pack(step, md_off, len(blob), crc, 1,
                              time.time_ns(), 0, 0)
        if fsync_step:
            md.fsync()
            idx.write(rec)
            idx.fsync()
        else:
            idx.write(rec)
            md.flush()   # bytes reach the OS; fsync deferred to close
            idx.flush()
    return md_off + len(blob)


def put_chunk(writer, name: str, array, *, global_shape: tuple,
              offset: tuple, rank: int, codec: Optional[str] = None):
    """Register one rank's chunk of variable `name` for the writer's open
    step — the ONE `put` of every engine (`BpWriter`, `AsyncBpWriter` and
    `ParallelBpWriter` bind it), as their snapshots share
    `take_step_snapshot`.

    `array` may be a numpy ndarray, a torch tensor (left on its device
    until the step is written — the device-compress path shuffles it
    there), or a `PreshuffledChunk` from an upstream preconditioner.
    `codec` overrides the engine codec for THIS variable (e.g.
    "lossy:1e-3" for particle data while fields stay lossless)."""
    if writer._step is None:
        raise RuntimeError("put() outside begin/end_step")
    validate_put_rank(rank, writer.n_ranks)
    if isinstance(array, C.PreshuffledChunk) or C.is_device_array(array):
        a = array                      # no host materialization here
    else:
        a = np.ascontiguousarray(array)
    gshape = tuple(int(x) for x in global_shape)
    var = writer._pending.setdefault(name, {
        "dtype": C.np_dtype(a.dtype).str, "shape": gshape, "chunks": []})
    if var["shape"] != gshape:
        raise ValueError(
            f"put({name!r}) global_shape {gshape} conflicts with "
            f"{var['shape']} from an earlier put of this step")
    if codec is not None:
        C.parse_codec(codec)           # fail fast on bad specs
        prev = var.get("codec")
        if prev is not None and prev != codec:
            raise ValueError(
                f"put({name!r}) codec {codec!r} conflicts with {prev!r} "
                f"from an earlier put of this step")
        var["codec"] = codec
    var["chunks"].append((rank, tuple(int(x) for x in offset), a))


@dataclasses.dataclass
class StepSnapshot:
    """One step's puts, captured at end_step time — the unit of work handed
    to `_write_step`. The sync writer builds one and writes it inline; the
    async writer deep-copies chunk arrays (`copy=True`) so the producer may
    reuse its buffers immediately, and queues it for the background seal."""
    step: int
    pending: dict[str, dict]
    attrs: dict[str, Any]
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


def take_step_snapshot(step: Optional[int], pending: dict, attrs: dict, *,
                       copy: bool) -> StepSnapshot:
    """Build one StepSnapshot from a writer's open-step state — the ONE
    place the snapshot contract lives (every engine's `_take_snapshot`
    delegates here, so the {dtype, shape, chunks} structure and the
    `copy=True` deep-copy semantics cannot drift between engines)."""
    if step is None:
        raise RuntimeError("end_step() outside begin_step()")

    def _copy_chunk(arr):
        # ndarrays and tensors are mutable, so both are deep-copied (a
        # tensor on its own device); PreshuffledChunks are minted fresh by
        # the preconditioner, so the producer cannot mutate them
        if isinstance(arr, np.ndarray):
            return np.array(arr)
        return arr.clone() if C.is_device_array(arr) else arr

    with TRACER.span("snapshot", path=f"step.{step}") as sp:
        if copy:
            pending = {name: {**{k: v for k, v in var.items()
                                 if k != "chunks"},
                              "chunks": [(r, off, _copy_chunk(arr))
                                         for r, off, arr in var["chunks"]]}
                       for name, var in pending.items()}
        sp.length = sum(arr.nbytes for var in pending.values()
                        for _, _, arr in var["chunks"])
    return StepSnapshot(step, pending, dict(attrs))


class BpWriter:
    def __init__(self, path, n_ranks: int, cfg: EngineConfig = EngineConfig()):
        self.path = pathlib.Path(str(path))
        self.path.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.n_ranks = n_ranks
        self.m = min(cfg.aggregators, max(n_ranks, 1))
        self.pool = WriterPool(cfg.workers)
        ost_pool = None
        if cfg.stripe is not None:
            ost_pool = OstPool(self.path, cfg.n_osts)
            for i in range(self.m):
                with open_file(self.path / f"data.{i}.stripe.json", "w",
                               rank=0) as sf:
                    sf.write(json.dumps(
                        {"stripe_count": cfg.stripe.stripe_count,
                         "stripe_size": cfg.stripe.stripe_size}))
        self.subfiles = SubfileSet(self.path, self.m, stripe=cfg.stripe,
                                   ost_pool=ost_pool)
        self._md = open_file(self.path / "md.0", "wb", rank=0)
        self._idx = open_file(self.path / "md.idx", "wb", rank=0)
        self._md_off = 0
        self._step: Optional[int] = None
        self._pending: dict[str, dict] = {}
        self._attrs: dict[str, Any] = {}
        self._profile: list[dict] = []
        # metrics journal sidecar (metrics.jsonl next to profiling.json):
        # one frame per sealed step while the metrics plane is enabled
        self._journal = (StepJournal(journal_path(self.path))
                         if METRICS.enabled and cfg.profiling else None)

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

    def replace_attributes(self, attrs: dict):
        """Replace the attribute set wholesale. Attributes normally
        ACCUMULATE across steps (each step's md.0 record stores the current
        set); a replaying tool (jbprepack) needs per-step exactness instead
        — what the source step recorded, nothing more."""
        self._attrs = dict(attrs)

    put = put_chunk

    def _take_snapshot(self, *, copy: bool) -> StepSnapshot:
        """Capture the open step and reset producer-side state. With
        `copy=True` chunk arrays are deep-copied (the async contract: the
        caller may mutate its buffers the moment end_step returns)."""
        snap = take_step_snapshot(self._step, self._pending, self._attrs,
                                  copy=copy)
        self._step = None
        self._pending = {}
        return snap

    def end_step(self) -> dict:
        return self._write_step(self._take_snapshot(copy=False))

    def _write_step(self, snap: StepSnapshot) -> dict:
        """Compress + aggregate + append + seal one snapshot. Must be called
        from ONE thread at a time (the caller thread here; the dedicated
        writer thread in AsyncBpWriter) — md.0/md.idx appends are ordered."""
        step = snap.step
        t0 = time.perf_counter()
        results: dict[str, list[ChunkMeta]] = {n: [] for n in snap.pending}
        lock = threading.Lock()
        errors: list = []
        tcomp_total = [0.0]

        # Coalesce: one job per aggregator compresses its ranks' chunks and
        # issues a SINGLE append (one write syscall per aggregator per step
        # instead of one per chunk — §Perf hillclimb C iteration r6).
        by_agg: dict[int, list] = {}
        n_bytes_raw = 0
        for name, var in snap.pending.items():
            codec = var.get("codec") or self.cfg.codec
            for rank, offset, arr in var["chunks"]:
                n_bytes_raw += arr.nbytes
                agg = aggregator_of(rank, self.n_ranks, self.m)
                by_agg.setdefault(agg, []).append(
                    (name, rank, offset, arr, codec))

        def agg_job(agg, items):
            try:
                tc = time.perf_counter()
                dpath = str(self.path / f"data.{agg}")
                payloads, metas = [], []
                with TRACER.span("compress", path=f"data.{agg}",
                                 rank=agg, observe=True) as sp:
                    for name, rank, offset, arr, codec in items:
                        payload, shape, stats, dstats = encode_chunk(
                            arr, codec, self.cfg.compression_block,
                            device_compress=self.cfg.device_compress)
                        record_compress_counters(
                            agg, dpath, codec, arr.nbytes, len(payload),
                            dstats)
                        payloads.append(payload)
                        metas.append((name, rank, offset, shape,
                                      len(payload), stats))
                    sp.length = sum(len(p) for p in payloads)
                tcomp = time.perf_counter() - tc
                blob = b"".join(payloads)
                with TRACER.span("append", rank=agg, length=len(blob)):
                    base = self.subfiles.append(agg, blob)
            except Exception as e:   # noqa: BLE001
                errors.append(e)
                return
            with lock:
                off = base
                for name, rank, offset, shape, nb, (vmin, vmax) in metas:
                    results[name].append(ChunkMeta(rank, offset, shape, agg,
                                                   off, nb, vmin, vmax))
                    off += nb
                tcomp_total[0] += tcomp

        for agg, items in by_agg.items():
            self.pool.submit(agg_job, agg, items)
        self.pool.drain()
        if errors:
            raise errors[0]

        # ---- metadata record (md.0), then sealed index record (md.idx) ------
        md_rec = build_md_record(
            step, snap.attrs, snap.pending,
            {name: [c.to_json() for c in results[name]]
             for name in snap.pending})
        blob = json.dumps(md_rec).encode()
        self._md_off = seal_md_record(
            self._md, self._idx, self._md_off, step, blob,
            fsync_step=self.cfg.fsync_policy == "step")

        dt = time.perf_counter() - t0
        prof = {"step": step, "write_s": dt, "compress_s": tcomp_total[0],
                "bytes_raw": n_bytes_raw,
                "bytes_stored": sum(c.nbytes for cl in results.values()
                                    for c in cl),
                "aggregators": self.m}
        prof.update(snap.extra)
        self._profile.append(prof)
        self._journal_frame(step, prof)
        return prof

    def _journal_frame(self, step: int, prof: dict,
                       workers: Optional[dict] = None):
        """Append one metrics.jsonl frame for a sealed step: absolute
        Darshan totals (the journal stores deltas), this process's
        per-step histogram delta, and any per-worker shipped shards.
        Single-threaded by the same contract as `_write_step`."""
        if self._journal is None:
            return
        self._journal.frame(step, prof, MONITOR.report()["total"],
                            METRICS.snapshot(reset=True)["hists"],
                            workers=workers)

    def _profile_doc(self) -> dict:
        return {"engine": "JBP(BP4)", "aggregators": self.m,
                "codec": self.cfg.codec, "steps": self._profile}

    def close(self):
        self.pool.shutdown()
        self.subfiles.fsync_close()
        if self.cfg.fsync_policy != "step":
            self._md.fsync()
            self._idx.fsync()
        self._md.close()
        self._idx.close()
        if self.cfg.profiling:
            with open_file(self.path / "profiling.json", "w", rank=0) as f:
                f.write(json.dumps(self._profile_doc(), indent=1))
        if TRACER.enabled:
            TRACER.dump(self.path / "dxt.json")
        if self._journal is not None:
            # final frame: close-time residuals (fsyncs, profiling.json) —
            # the journal's cumulative stays identical to the live registry
            self._journal_frame(-1, {"final": True})
            self._journal.close()
            self._journal = None


def _box_intersection(coff, cext, sel_off, sel_ext):
    """[lo, hi) overlap of two boxes, or None when they don't intersect."""
    lo = tuple(max(a, b) for a, b in zip(coff, sel_off))
    hi = tuple(min(a + e, b + f) for a, e, b, f in
               zip(coff, cext, sel_off, sel_ext))
    if any(l >= h for l, h in zip(lo, hi)):
        return None
    return lo, hi


class BpReader:
    """Reader with a metadata-only query plane (the paper's "rapid metadata
    extraction" claim, §V):

      * md.idx is scanned once (fixed-size crc-sealed records); md.0 blobs
        are crc-validated up front but JSON-parsed LAZILY per step — opening
        a 10k-step series to read one iteration parses one record,
      * every query below (`var_names`, `iter_chunks`, `chunks_in_box`,
        `var_minmax`, `var_nbytes`, `layout`, `variables`) is answered from
        md.idx/md.0 alone — no `data.*` subfile is ever opened until
        `read_var()` actually needs payload bytes,
      * `read_var` prunes chunks with the same `_box_intersection`
        predicate `chunks_in_box` uses, so an empty-intersection selection
        performs zero payload I/O,
      * `read_var(parallel=N)` fans a multi-chunk read plan out over a
        `ReaderPool` (N worker threads, per-aggregator handle affinity) —
        payload reads hit the M subfiles concurrently and decompression
        overlaps across cores (zlib/bz2 release the GIL). Results are
        byte-identical to the serial path; `parallel` passed to the
        constructor sets the default for every read.
    """

    def __init__(self, path, *, parallel: int = 0, chunk_cache=None):
        self.path = pathlib.Path(str(path))
        self.default_parallel = int(parallel)
        # Service-plane hook: an object with
        #     get_or_fetch(key, fetch, nbytes) -> np.ndarray
        # consulted by `read_chunk` for every decompressed chunk (key =
        # (series, step, var, agg, file_offset) — chunk-granular, exactly
        # what jbpd's LRU cache and request coalescing key on). None (the
        # default) reads and decompresses inline, as ever.
        self.chunk_cache = chunk_cache
        self._blobs: dict[int, bytes] = {}        # step -> validated md.0 blob
        self._meta: dict[int, dict] = {}          # step -> parsed record cache
        self.idx_records: dict[int, dict] = {}    # step -> md.idx fields
        self._data_handles: dict[int, Any] = {}   # agg -> cached payload handle
        self._io_lock = threading.Lock()          # seek+read must be atomic
        self._pool: Optional[ReaderPool] = None   # lazy parallel-read plane
        self._tls = threading.local()             # per-worker handle cache
        self._side_handles: list = []             # every per-thread handle
        self._load_index()

    def _load_index(self):
        """md.idx scan -> md.0 regions; crc-invalid/truncated steps dropped."""
        idx_p = self.path / "md.idx"
        md_p = self.path / "md.0"
        if not idx_p.exists() or not md_p.exists():
            return
        with open_file(idx_p, "rb") as f:
            raw = f.read()
        with open_file(md_p, "rb") as f:
            md = f.read()
        for i in range(0, len(raw) - IDX_SIZE + 1, IDX_SIZE):
            step, off, ln, crc, flags, t_ns, _, _ = IDX_RECORD.unpack_from(raw, i)
            blob = md[off:off + ln]
            if len(blob) != ln or (zlib.crc32(blob) & 0xFFFFFFFF) != crc:
                continue                       # torn/corrupt step -> ignore
            self._blobs[step] = blob
            self.idx_records[step] = {"md_off": off, "md_len": ln,
                                      "flags": flags, "t_ns": t_ns}

    def _record(self, step: int) -> dict:
        rec = self._meta.get(step)
        if rec is None:
            rec = self._meta[step] = json.loads(self._blobs[step])
        return rec

    @property
    def steps(self) -> dict[int, dict]:
        """Eager step->record view (compat with the pre-lazy reader):
        touching it parses every remaining md.0 record."""
        for s in self._blobs:
            self._record(s)
        return self._meta

    def valid_steps(self) -> list[int]:
        return sorted(self._blobs)

    def attributes(self, step: int) -> dict:
        return self._record(step).get("attrs", {})

    def var_names(self, step: int) -> list[str]:
        return sorted(self._record(step)["vars"])

    def var_info(self, step: int, name: str) -> dict:
        return self._record(step)["vars"][name]

    # ------------------------------------------------- metadata query layer
    def iter_chunks(self, step: int, name: str):
        """Lazily yield one ChunkMeta per stored block of `name`."""
        for ch in self.var_info(step, name)["chunks"]:
            yield ChunkMeta.from_json(ch)

    def chunks_in_box(self, step: int, name: str, offset: tuple,
                      extent: tuple) -> list[ChunkMeta]:
        """The read plan: chunk metas intersecting the selection box."""
        sel_off, sel_ext = tuple(offset), tuple(extent)
        return [c for c in self.iter_chunks(step, name)
                if _box_intersection(c.offset, c.extent, sel_off, sel_ext)]

    def _accum_var(self, step: int, name: str,
                   layout: Optional[dict] = None) -> dict:
        """Single chunk-table walk for one (step, name): byte totals, chunk
        count, min/max fold, and (when `layout` is passed) aggregator
        occupancy — THE one place the accumulation semantics live."""
        info = self.var_info(step, name)
        itemsize = np.dtype(info["dtype"]).itemsize
        raw = stored = chunks = 0
        lo: Optional[float] = None
        hi: Optional[float] = None
        stats_ok = True
        for c in self.iter_chunks(step, name):
            n = 1
            for e in c.extent:
                n *= int(e)
            raw += n * itemsize
            stored += c.nbytes
            chunks += 1
            if layout is not None:
                d = layout.setdefault(c.agg, {"chunks": 0, "bytes": 0,
                                              "end": 0})
                d["chunks"] += 1
                d["bytes"] += c.nbytes
                d["end"] = max(d["end"], c.file_offset + c.nbytes)
            if c.vmin is None:
                stats_ok = False
            else:
                lo = c.vmin if lo is None else min(lo, c.vmin)
                hi = c.vmax if hi is None else max(hi, c.vmax)
        return {"info": info, "raw": raw, "stored": stored, "chunks": chunks,
                "minmax": (lo, hi) if stats_ok and lo is not None else None}

    def var_minmax(self, step: int, name: str) -> Optional[tuple]:
        """Global (min, max) from the chunk statistics alone; None when any
        block lacks finite stats (pre-stats series, empty/non-numeric/
        all-NaN blocks)."""
        return self._accum_var(step, name)["minmax"]

    def var_nbytes(self, step: int, name: str) -> tuple[int, int]:
        """(raw, stored) bytes — raw derived from extents x itemsize,
        stored summed from the chunk table. ratio = raw / stored."""
        a = self._accum_var(step, name)
        return a["raw"], a["stored"]

    def scan(self, steps=None, name_filter=None) -> dict:
        """ONE pass over the chunk tables producing every aggregate the
        listing tools need (re-walking md.0 per query would multiply the
        cost of the thing that exists to be fast):

          variables: name -> {dtype, shape, steps, chunks_per_step,
                              shape_varies, raw, stored}
                     (shape/chunks_per_step are the LATEST step's;
                      shape_varies flags series that change shape)
          per_step:  [{step, t_ns, n_vars, raw, stored}]
          layout:    agg -> {chunks, bytes, end}   (subfile occupancy)
          minmax:    name -> (lo, hi) over ALL scanned steps, or None when
                     any block lacks finite stats

        `name_filter` (a predicate on variable names) restricts EVERY
        aggregate consistently — per-step totals, layout and minmax all
        cover exactly the filtered variables.
        """
        variables: dict[str, dict] = {}
        minmax: dict[str, Optional[tuple]] = {}
        layout: dict[int, dict] = {}
        per_step = []
        for step in (self.valid_steps() if steps is None else steps):
            step_raw = step_stored = 0
            names = self.var_names(step)
            if name_filter is not None:
                names = [n for n in names if name_filter(n)]
            for name in names:
                a = self._accum_var(step, name, layout)
                step_raw += a["raw"]
                step_stored += a["stored"]
                shape = tuple(a["info"]["shape"])
                v = variables.setdefault(name, {
                    "dtype": a["info"]["dtype"], "shape": shape,
                    "steps": [], "chunks_per_step": a["chunks"],
                    "shape_varies": False, "raw": 0, "stored": 0})
                if v["steps"] and v["shape"] != shape:
                    v["shape_varies"] = True
                v["shape"] = shape
                v["chunks_per_step"] = a["chunks"]
                v["steps"].append(step)
                v["raw"] += a["raw"]
                v["stored"] += a["stored"]
                if a["minmax"] is None:
                    minmax[name] = None
                elif name not in minmax:
                    minmax[name] = a["minmax"]
                elif minmax[name] is not None:
                    lo, hi = a["minmax"]
                    plo, phi = minmax[name]
                    minmax[name] = (min(plo, lo), max(phi, hi))
            per_step.append({"step": step,
                             "t_ns": self.idx_records[step]["t_ns"],
                             "n_vars": len(names), "raw": step_raw,
                             "stored": step_stored})
        return {"variables": variables, "per_step": per_step,
                "layout": layout, "minmax": minmax}

    def layout(self, steps=None) -> dict[int, dict]:
        """Per-aggregator subfile occupancy {agg: {chunks, bytes, end}},
        reconstructed from chunk tables — data.* files are never touched."""
        return self.scan(steps)["layout"]

    def variables(self, steps=None) -> dict[str, dict]:
        """Union of variables across `steps` (default: all valid steps):
        name -> {dtype, shape, steps, chunks_per_step, raw, stored}."""
        return self.scan(steps)["variables"]

    def _data_file(self, agg: int):
        """Cached per-aggregator payload handle (InstrumentedFile for plain
        subfiles, read-mode StripedFile for striped layouts) — a multi-chunk
        read_var no longer reopens data.<agg> once per chunk."""
        f = self._data_handles.get(agg)
        if f is not None:
            return f
        f = self._open_data(agg)
        self._data_handles[agg] = f
        return f

    def _open_data(self, agg: int):
        """Open a fresh payload handle for aggregator `agg` (plain subfile
        or striped layout)."""
        plain = self.path / f"data.{agg}"
        if plain.exists():
            f = open_file(plain, "rb")
        else:
            # striped layout: reconstruct via a read-mode StripedFile
            n_osts = len(sorted(self.path.glob("ost*")))
            objs = sorted(self.path.glob(f"ost*/data.{agg}.obj"))
            if not objs:
                raise FileNotFoundError(f"no data for aggregator {agg} "
                                        f"under {self.path}")
            # stripe params are discoverable from the writer config file; for
            # robustness store them alongside: meta sidecar
            side = self.path / f"data.{agg}.stripe.json"
            if side.exists():
                with open_file(side, "r") as sf:
                    cfgd = json.loads(sf.read())
            else:
                cfgd = {"stripe_count": len(objs),
                        "stripe_size": C.DEFAULT_BLOCK}
            pool = OstPool(self.path, n_osts)
            f = StripedFile(pool, f"data.{agg}",
                            StripeConfig(cfgd["stripe_count"],
                                         cfgd["stripe_size"]),
                            rank=0, mode="r")
        return f

    def _read_payload(self, agg: int, foff: int, nbytes: int) -> bytes:
        f = self._data_file(agg)
        if isinstance(f, StripedFile):
            return f.read(foff, nbytes)      # StripedFile locks internally
        with self._io_lock:
            f.seek(foff)
            return f.read(nbytes)

    def _read_payload_local(self, agg: int, foff: int, nbytes: int) -> bytes:
        """Payload read through a PER-THREAD handle — the ReaderPool path.
        No lock is taken around seek+read: every (worker thread, aggregator)
        pair owns its handle outright, which is the handle-affinity contract
        (affinity routing makes the common case one handle per subfile)."""
        cache = getattr(self._tls, "handles", None)
        if cache is None:
            cache = self._tls.handles = {}
        f = cache.get(agg)
        if f is None:
            f = cache[agg] = self._open_data(agg)
            with self._io_lock:
                self._side_handles.append(f)
        if isinstance(f, StripedFile):
            return f.read(foff, nbytes)
        f.seek(foff)
        return f.read(nbytes)

    def _get_pool(self, n: int) -> ReaderPool:
        """Lazily create (or grow, in place) the parallel-read plane.
        Creation is locked and growth never recreates the pool, so
        concurrent read_var callers share one plane safely."""
        with self._io_lock:
            if self._pool is None:
                self._pool = ReaderPool(n)
            elif self._pool.n_workers < n:
                self._pool.ensure(n)
            return self._pool

    def close(self):
        """Release the reader pool and every cached payload handle
        (metadata stays queryable; a later read reopens lazily)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()
        with self._io_lock:
            side, self._side_handles = self._side_handles, []
        self._tls = threading.local()
        handles, self._data_handles = self._data_handles, {}
        for f in list(handles.values()) + side:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _fetch_chunk(self, ch: ChunkMeta, dtype, local: bool) -> np.ndarray:
        """Uncached read+decompress of one stored chunk (`local=True` uses
        the per-thread handle — the ReaderPool path)."""
        read = self._read_payload_local if local else self._read_payload
        with TRACER.annotate("bp.read"):
            payload = read(ch.agg, ch.file_offset, ch.nbytes)
        t0 = time.perf_counter()
        with TRACER.span("decode", length=ch.nbytes):
            arr = C.payload_to_array(payload, dtype, ch.extent)
        MONITOR.record(0, str(self.path / f"data.{ch.agg}"),
                       CTR.DECOMPRESS_TIME, time.perf_counter() - t0)
        return arr

    def read_chunk(self, step: int, name: str, ch: ChunkMeta, *,
                   dtype=None, local: bool = False) -> np.ndarray:
        """Decompressed array of ONE stored chunk — the chunk-granular read
        entrypoint. When a `chunk_cache` is installed (the jbpd service
        plane) the chunk is looked up / fetched through it, keyed by
        (series, step, var, agg, file_offset): concurrent identical
        requests share one payload read + decompress, repeats are memory
        hits. Cached arrays are read-only; callers needing to mutate copy."""
        if dtype is None:
            dtype = np.dtype(self.var_info(step, name)["dtype"])
        if self.chunk_cache is None:
            return self._fetch_chunk(ch, dtype, local)
        key = (str(self.path), step, name, ch.agg, ch.file_offset)
        n = int(np.prod(ch.extent, dtype=np.int64)) * dtype.itemsize
        return self.chunk_cache.get_or_fetch(
            key, lambda: self._fetch_chunk(ch, dtype, local), n)

    def _scatter_chunk(self, out: np.ndarray, dtype, sel_off: tuple,
                       step: int, name: str, ch: ChunkMeta, box, local: bool):
        """Read one chunk (through `read_chunk`, so the service cache sees
        every read path), scatter its intersection into `out`. The unit of
        work of both read paths; `local=True` uses the per-thread handle
        (ReaderPool workers), else the shared locked handle."""
        lo, hi = box
        arr = self.read_chunk(step, name, ch, dtype=dtype, local=local)
        src = tuple(slice(l - o, h - o)
                    for l, o, h in zip(lo, ch.offset, hi))
        dst = tuple(slice(l - o, h - o)
                    for l, o, h in zip(lo, sel_off, hi))
        # a 0-d variable's chunk is stored with extent (1,)
        out[dst] = arr[src].reshape(np.shape(out[dst]))

    def read_var(self, step: int, name: str,
                 offset: Optional[tuple] = None,
                 extent: Optional[tuple] = None, *,
                 parallel: Optional[int] = None) -> np.ndarray:
        """Assemble a box selection (default: the full global array).

        `parallel=N` (default: the constructor's `parallel`) fans the
        chunk plan out over N ReaderPool workers keyed by aggregator id —
        bytes returned are identical to the serial path; chunks of a step
        cover disjoint boxes, so the scatters never race."""
        n = self.default_parallel if parallel is None else int(parallel)
        info = self.var_info(step, name)
        dtype = np.dtype(info["dtype"])
        gshape = tuple(info["shape"])
        sel_off = tuple(offset) if offset is not None else (0,) * len(gshape)
        sel_ext = tuple(extent) if extent is not None else gshape
        out = np.zeros(sel_ext, dtype=dtype)
        plan = []
        for ch in self.iter_chunks(step, name):
            box = _box_intersection(ch.offset, ch.extent, sel_off, sel_ext)
            if box is not None:
                plan.append((ch, box))
        if n > 1 and len(plan) > 1:
            pool = self._get_pool(min(n, len(plan)))
            # per-call batch: concurrent read_var callers on one reader
            # (e.g. restore_sharded fetchers) each wait on — and receive
            # the errors of — exactly their own chunk tasks
            batch = pool.batch()
            for ch, box in plan:
                pool.submit(ch.agg, self._scatter_chunk, out, dtype, sel_off,
                            step, name, ch, box, True, batch=batch)
            pool.drain_batch(batch)
        else:
            for ch, box in plan:
                self._scatter_chunk(out, dtype, sel_off, step, name, ch, box,
                                    False)
        return out
