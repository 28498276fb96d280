"""The metrics plane: fixed-log2-bucket latency/size histograms.

The Darshan counters (`repro_torch.core.darshan`) answer *how much* I/O ran and
the DXT traces (`repro_torch.core.dxt`) answer *when each op* ran — but neither
gives aggregated DISTRIBUTIONS over time, which is what actually exposes
stragglers and regressions (raw counters average the tail away; raw
traces are unbounded and post-hoc). `MetricsRegistry` is the third layer:

  * every observed op lands in a pair of FIXED log2-bucket histograms —
    latency (microsecond-resolution, `NB_LAT` buckets) and size (bytes,
    `NB_SIZE` buckets). Bucket `i` covers `(2^(i-1), 2^i]` units with
    bucket 0 = `<= 1` unit and the top bucket open-ended, so two
    processes' histograms merge by plain element-wise addition and
    percentiles are DETERMINISTIC functions of the counts (p50/p95/p99
    are the upper edge of the bucket holding that rank — identical
    whether computed live, from a shipped snapshot, or from a journal
    read back days later). `max`/`sum`/`count` are tracked exactly.
  * recording is LOCK-FREE per thread (the DxtTracer discipline): each
    thread owns a shard registered once under the lock; `observe()` is a
    tls lookup + dict bump. Disabled = one attribute load + branch per
    op — the hot paths check `METRICS.enabled` before touching anything
    (`bench_darshan_costs` holds the write path to the same <=5% budget
    as DXT with metrics recording ON).
  * `snapshot()`/`merge()` follow the same epoch-rebase discipline as
    `DarshanMonitor`: every cell stamps its first/last observation on the
    process-private perf_counter clock, and `snapshot()` rebases them to
    wall time via a paired (time.time, perf_counter) epoch — merged
    first/last times are comparable across processes. `snapshot(
    reset=True)` ships a per-step DELTA and retires it into a local
    cumulative, so the live `merged()` view never loses history to the
    journal (sum over journal frames == live totals, exactly — the
    jbpstat/jbpd parity contract).

On top of the registry:

  * `StepJournal` — the persistent `metrics.jsonl` sidecar (one JSON
    frame per committed step/save, next to `profiling.json`): counter
    deltas + per-step histogram cells + per-worker shards shipped home
    on the existing "prepared"/"finished" ack paths. `load_journal`
    reads it back; `repro.tools.jbpstat` analyzes it.
  * `straggler_report` / `RollingBaseline` — the anomaly detector: per
    key (subfile / OST path / worker) p99-vs-median-of-peers ratio, plus
    a rolling EWMA baseline per key so a *newly* slow key is flagged
    even when every peer degrades with it. Surfaced in `jbpd --watch`
    frames, `--io-report`, and the journal.
  * `to_prometheus` — Prometheus text-exposition (v0.0.4) rendering of
    the histograms + Darshan counters (`jbp_*` families), served by the
    jbpd `metrics` op and its `--metrics-port` HTTP shim so standard
    scrapers work.

Enable programmatically (`METRICS.enable()`) or via the environment
(`JBP_METRICS=1`, inherited by spawned writer workers).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterable, Optional

#: latency buckets: microseconds, log2 — bucket i covers (2^(i-1), 2^i] us,
#: bucket 0 is <=1us, bucket NB_LAT-1 is everything past ~2^30 us (~18 min)
NB_LAT = 32
#: size buckets: bytes, log2 — same scheme, top bucket past 2^38 B (256 GiB)
NB_SIZE = 40
LAT_UNIT_S = 1e-6                       # one latency bucket unit, in seconds

#: the observation vocabulary (mirrors the DXT span/POSIX ops that feed it);
#: free-form ops are accepted — this tuple is documentation + test surface
KNOWN_OPS = ("read", "write", "fsync", "compress", "seal", "transport",
             "prepare", "commit", "shm_write", "cache_fetch", "serve",
             "read_task", "device_shuffle")


def bucket_index(x: int, nb: int) -> int:
    """Log2 bucket of a non-negative integer quantity: 0 for x<=1, else
    bit_length(x-1) clamped to the top bucket — so bucket i's upper edge
    is exactly 2^i and edges are shared by every producer."""
    if x <= 1:
        return 0
    return min(nb - 1, (x - 1).bit_length())


def bucket_le(i: int) -> int:
    """Inclusive upper edge (in units) of bucket i: 2^i."""
    return 1 << i


def quantile_from_buckets(counts: Iterable[int], q: float) -> Optional[int]:
    """The upper edge (in units) of the bucket containing rank ceil(q*n) —
    the ONE deterministic percentile read every consumer (live registry,
    journal, jbpstat, Prometheus) shares. None when the histogram is
    empty."""
    counts = list(counts)
    total = sum(counts)
    if total <= 0:
        return None
    rank = max(1, int(q * total + 0.999999))     # ceil without float drama
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            return bucket_le(i)
    return bucket_le(len(counts) - 1)


# ----------------------------------------------------------------- cell math
def new_cell() -> dict:
    """One (op, key) histogram cell in its wire/JSON form."""
    return {"count": 0, "sum_s": 0.0, "max_s": 0.0, "sum_b": 0, "max_b": 0,
            "lat": [0] * NB_LAT, "size": [0] * NB_SIZE,
            "t0": None, "t1": None}


def merge_cell(dst: dict, src: dict):
    """Element-wise fold of one cell into another (both wire-form)."""
    dst["count"] += src.get("count", 0)
    dst["sum_s"] += src.get("sum_s", 0.0)
    dst["max_s"] = max(dst["max_s"], src.get("max_s", 0.0))
    dst["sum_b"] += src.get("sum_b", 0)
    dst["max_b"] = max(dst["max_b"], src.get("max_b", 0))
    for i, c in enumerate(src.get("lat", ())):
        dst["lat"][i] += c
    for i, c in enumerate(src.get("size", ())):
        dst["size"][i] += c
    for bound, pick in (("t0", min), ("t1", max)):
        s = src.get(bound)
        if s is not None:
            d = dst.get(bound)
            dst[bound] = s if d is None else pick(d, s)


def merge_cells(dst: dict, src: dict) -> dict:
    """Fold a whole `{"op|key": cell}` mapping into `dst` (mutated and
    returned) — the additive property every consumer leans on: summing
    per-step journal frames reproduces the live cumulative exactly."""
    for k, cell in src.items():
        d = dst.get(k)
        if d is None:
            dst[k] = d = new_cell()
        merge_cell(d, cell)
    return dst


def summarize_cell(cell: dict) -> dict:
    """p50/p95/p99 (deterministic, from buckets) + exact max/mean for one
    cell — seconds for latency, bytes for size."""
    n = cell.get("count", 0)
    out = {"count": n, "max_s": cell.get("max_s", 0.0),
           "sum_s": cell.get("sum_s", 0.0), "sum_b": cell.get("sum_b", 0)}
    for q, name in ((0.50, "p50_s"), (0.95, "p95_s"), (0.99, "p99_s")):
        u = quantile_from_buckets(cell.get("lat", ()), q)
        out[name] = None if u is None else u * LAT_UNIT_S
    out["mean_s"] = (out["sum_s"] / n) if n else None
    return out


def cell_key(op: str, key: str = "") -> str:
    return f"{op}|{key}"


def split_key(k: str) -> tuple[str, str]:
    op, _, key = k.partition("|")
    return op, key


# ------------------------------------------------------------------ registry
class _Shard:
    """One thread's cells. Appends are single-threaded (the owning
    thread); snapshots copy under the GIL — the _ThreadBuf discipline."""

    __slots__ = ("cells",)

    def __init__(self):
        self.cells: dict[str, dict] = {}


class _NullTimer:
    """The metrics-off timer: no clock reads, no record. One shared
    instance, like dxt's _NULL_SPAN."""

    __slots__ = ("nbytes",)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL_TIMER = _NullTimer()


class _Timer:
    """Context manager observing one op on exit; `nbytes` may be set
    inside the block."""

    __slots__ = ("_reg", "op", "key", "nbytes", "_t0")

    def __init__(self, reg: "MetricsRegistry", op: str, key: str,
                 nbytes: int):
        self._reg = reg
        self.op = op
        self.key = key
        self.nbytes = nbytes

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._reg.observe(self.op, time.perf_counter() - self._t0,
                          nbytes=self.nbytes, key=self.key)
        return False


class MetricsRegistry:
    """Process-wide latency/size histogram registry (see module doc).

    `observe()` is the one recording entry point; `timer()` wraps it for
    spans without their own clocks. `snapshot(reset=True)` ships a
    per-step delta (retired locally so `merged()` stays cumulative);
    `merge()` folds another process's snapshot in; `merged()` is the
    single combined `{"op|key": cell}` view every reporter reads."""

    def __init__(self):
        self.enabled = bool(int(os.environ.get("JBP_METRICS", "0") or 0))
        self.src = f"pid{os.getpid()}"
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._shards: list[_Shard] = []
        self._retired: dict[str, dict] = {}     # reset-snapshot deltas
        self._foreign: dict[str, dict] = {}     # merged from other processes
        self._stamp_epoch()

    def _stamp_epoch(self):
        # paired wall/monotonic sample (the DarshanMonitor/DxtTracer
        # discipline): cell t0/t1 are recorded on perf_counter and rebased
        # wall = perf + (epoch_wall - epoch_perf) at snapshot time
        self.epoch = (time.time(), time.perf_counter())

    # ---------------------------------------------------------------- control
    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        """Drop every recorded, retired and merged cell (other threads'
        shards included) and restamp the clock epoch."""
        with self._lock:
            for sh in self._shards:
                sh.cells.clear()
            self._retired = {}
            self._foreign = {}
            self.src = f"pid{os.getpid()}"
            self._stamp_epoch()

    # ----------------------------------------------------------------- record
    def _register(self) -> _Shard:
        sh = _Shard()
        with self._lock:
            self._shards.append(sh)
        self._tls.shard = sh
        return sh

    def observe(self, op: str, seconds: float, nbytes: int = 0,
                key: str = ""):
        """Record one observation into the calling thread's shard. Hot
        paths branch on `METRICS.enabled` before calling (observe() also
        guards, so cold paths may call unconditionally)."""
        if not self.enabled:
            return
        sh = getattr(self._tls, "shard", None)
        if sh is None:
            sh = self._register()
        ck = f"{op}|{key}"
        cell = sh.cells.get(ck)
        if cell is None:
            cell = sh.cells[ck] = new_cell()
        t = time.perf_counter()
        if seconds < 0:
            seconds = 0.0
        cell["count"] += 1
        cell["sum_s"] += seconds
        if seconds > cell["max_s"]:
            cell["max_s"] = seconds
        cell["lat"][bucket_index(int(seconds * 1e6), NB_LAT)] += 1
        if nbytes:
            cell["sum_b"] += nbytes
            if nbytes > cell["max_b"]:
                cell["max_b"] = nbytes
            cell["size"][bucket_index(int(nbytes), NB_SIZE)] += 1
        if cell["t0"] is None:
            cell["t0"] = t
        cell["t1"] = t

    def timer(self, op: str, key: str = "", nbytes: int = 0):
        """Timing context manager; a shared no-op when disabled (hot
        paths may also branch on `METRICS.enabled` themselves)."""
        if not self.enabled:
            return _NULL_TIMER
        return _Timer(self, op, key, nbytes)

    # ------------------------------------------------------- snapshot / merge
    def _rebase(self, cell: dict) -> dict:
        """Wire-form copy of a live cell with t0/t1 rebased onto the wall
        clock via this process's epoch."""
        shift = self.epoch[0] - self.epoch[1]
        out = {k: (list(v) if isinstance(v, list) else v)
               for k, v in cell.items()}
        for bound in ("t0", "t1"):
            if out.get(bound) is not None:
                out[bound] = out[bound] + shift
        return out

    def snapshot(self, reset: bool = False) -> dict:
        """Picklable dump of this process's OWN cells (live shards; not
        retired deltas, not foreign merges) — what a worker ships home on
        its ack. `reset=True` clears the shipped cells AND retires the
        delta into the local cumulative, so journaling per-step deltas
        never makes `merged()` forget."""
        with self._lock:
            shards = list(self._shards)
        own: dict[str, dict] = {}
        for sh in shards:
            for ck, cell in list(sh.cells.items()):  # copy under the GIL
                rb = self._rebase(cell)
                d = own.get(ck)
                if d is None:
                    own[ck] = rb
                else:
                    merge_cell(d, rb)
            if reset:
                sh.cells.clear()
        if reset and own:
            with self._lock:
                merge_cells(self._retired, own)
        return {"format": "jbp-metrics-1", "src": self.src,
                "epoch": list(self.epoch), "hists": own}

    def merge(self, snap: Optional[dict]):
        """Fold another process's `snapshot()` in. Cells arrive already
        wall-rebased (the shipper's epoch), so the fold is pure addition —
        the same "rebase at the source, add at the sink" contract as
        `DarshanMonitor.merge`."""
        if not snap:
            return
        hists = snap.get("hists") if "hists" in snap else snap
        if not isinstance(hists, dict) or not hists:
            return
        with self._lock:
            merge_cells(self._foreign, hists)

    def merged(self) -> dict:
        """The combined cumulative `{"op|key": cell}` view: live shards +
        retired deltas + every merged foreign snapshot."""
        out: dict[str, dict] = {}
        merge_cells(out, self.snapshot()["hists"])
        with self._lock:
            merge_cells(out, self._retired)
            merge_cells(out, self._foreign)
        return out

    def stats(self) -> dict:
        """Summary block for `jbpd --stats` / parser-style reports."""
        cells = self.merged()
        return {"enabled": self.enabled, "cells": len(cells),
                "observations": sum(c["count"] for c in cells.values())}


METRICS = MetricsRegistry()


# ---------------------------------------------------------------- stragglers
def straggler_report(cells: dict, *, ratio: float = 2.0,
                     min_count: int = 4) -> list[dict]:
    """Per-op peer comparison: within each op that has >= 2 keys, a key
    whose p99 is >= `ratio` x the median p99 of its peers is a straggler
    (per-OST and per-worker latencies surface as keys — subfile paths,
    `data.<w>`, `md.<w>.shard`). Sorted worst-first."""
    by_op: dict[str, list[tuple[str, dict]]] = {}
    for ck, cell in cells.items():
        op, key = split_key(ck)
        if cell.get("count", 0) >= min_count:
            by_op.setdefault(op, []).append((key, cell))
    out: list[dict] = []
    for op, members in by_op.items():
        if len(members) < 2:
            continue
        p99s = {key: quantile_from_buckets(cell["lat"], 0.99)
                for key, cell in members}
        vals = sorted(v for v in p99s.values() if v is not None)
        if not vals:
            continue
        median = vals[len(vals) // 2]
        for key, cell in members:
            p99 = p99s[key]
            if p99 is None or median <= 0:
                continue
            r = p99 / median
            if r >= ratio:
                out.append({"op": op, "key": key,
                            "p99_s": p99 * LAT_UNIT_S,
                            "median_p99_s": median * LAT_UNIT_S,
                            "ratio": r, "count": cell["count"]})
    out.sort(key=lambda e: -e["ratio"])
    return out


class RollingBaseline:
    """EWMA p99 per (op, key) across successive `update()` calls — the
    rolling baseline that catches a key turning slow against ITS OWN
    history even when every peer degrades together (peer-median alone is
    blind to that). `update(cells)` returns the combined report: the
    peer-ratio stragglers plus any key whose current p99 exceeds
    `baseline_ratio` x its EWMA."""

    def __init__(self, alpha: float = 0.3, ratio: float = 2.0,
                 baseline_ratio: float = 3.0, min_count: int = 4):
        self.alpha = float(alpha)
        self.ratio = float(ratio)
        self.baseline_ratio = float(baseline_ratio)
        self.min_count = int(min_count)
        self._ewma: dict[str, float] = {}

    def update(self, cells: dict) -> list[dict]:
        report = straggler_report(cells, ratio=self.ratio,
                                  min_count=self.min_count)
        flagged = {(e["op"], e["key"]) for e in report}
        for ck, cell in cells.items():
            if cell.get("count", 0) < self.min_count:
                continue
            p99u = quantile_from_buckets(cell["lat"], 0.99)
            if p99u is None:
                continue
            p99 = p99u * LAT_UNIT_S
            prev = self._ewma.get(ck)
            if prev is not None and prev > 0:
                vs = p99 / prev
                op, key = split_key(ck)
                if vs >= self.baseline_ratio and (op, key) not in flagged:
                    report.append({"op": op, "key": key, "p99_s": p99,
                                   "baseline_p99_s": prev,
                                   "ratio": vs, "vs_baseline": True,
                                   "count": cell["count"]})
            self._ewma[ck] = (p99 if prev is None
                              else prev + self.alpha * (p99 - prev))
        report.sort(key=lambda e: -e["ratio"])
        return report


# ------------------------------------------------------------------- journal
class StepJournal:
    """The `metrics.jsonl` sidecar: one JSON frame per committed step,
    appended and flushed AT the step (a crash keeps every frame already
    committed — it is a journal, not a close-time report). Frames carry
    the step's profiling numbers, Darshan counter DELTAS, this process's
    per-step histogram cells, per-worker shards shipped on the "prepared"
    acks, and the straggler report at that step."""

    def __init__(self, path):
        self.path = str(path)
        self._f = None
        self._prev_counters: dict[str, float] = {}
        self.baseline = RollingBaseline()
        self._cum: dict[str, dict] = {}

    def frame(self, step: int, prof: dict, counters: dict,
              hists: dict, workers: Optional[dict] = None) -> dict:
        """Build + append one frame. `counters` are ABSOLUTE totals (the
        journal stores the delta vs the previous frame); `hists` is this
        process's per-step delta (`snapshot(reset=True)["hists"]`);
        `workers` maps worker id -> its shipped per-step snapshot."""
        delta = {k: v - self._prev_counters.get(k, 0.0)
                 for k, v in counters.items()
                 if v - self._prev_counters.get(k, 0.0)}
        self._prev_counters = dict(counters)
        merge_cells(self._cum, hists)
        wcells: dict[str, dict] = {}
        for wid, wsnap in (workers or {}).items():
            wh = wsnap.get("hists", wsnap) if isinstance(wsnap, dict) else {}
            wcells[str(wid)] = wh
            merge_cells(self._cum, wh)
        doc = {"format": "jbp-metrics-journal-1", "step": step,
               "t": time.time(), "prof": prof, "counters": delta,
               "hists": hists, "workers": wcells,
               "stragglers": self.baseline.update(self._cum)}
        self._append(doc)
        return doc

    def _append(self, doc: dict):
        if self._f is None:
            # raw open on purpose: the journal is the metrics plane's OWN
            # output — routing it through InstrumentedFile would fold the
            # observer's writes into the very counter deltas it reports
            self._f = open(self.path, "w")   # jbplint: disable=JBP002
        self._f.write(json.dumps(doc) + "\n")
        self._f.flush()

    def close(self):
        f, self._f = self._f, None
        if f is not None:
            f.close()


def journal_path(series_path) -> str:
    return os.path.join(str(series_path), "metrics.jsonl")


def load_journal(path) -> list[dict]:
    """Read a metrics.jsonl back (series directory or the file itself):
    the list of frames, validated."""
    p = str(path)
    if os.path.isdir(p):
        p = os.path.join(p, "metrics.jsonl")
    # raw open on purpose: reading the journal through InstrumentedFile
    # would pollute the counters the journal is explaining
    with open(p) as f:   # jbplint: disable=JBP002
        frames = [json.loads(line) for line in f if line.strip()]
    for fr in frames:
        if fr.get("format") != "jbp-metrics-journal-1":
            raise ValueError(f"{p}: not a jbp metrics journal (format="
                             f"{fr.get('format')!r})")
    return frames


def sum_journal_hists(frames: Iterable[dict],
                      workers: bool = True) -> dict:
    """Fold every frame's per-step cells (own + per-worker) into one
    cumulative mapping — by the additive bucket property this reproduces
    the producer's live `merged()` exactly (the jbpstat parity test)."""
    out: dict[str, dict] = {}
    for fr in frames:
        merge_cells(out, fr.get("hists", {}))
        if workers:
            for wh in fr.get("workers", {}).values():
                merge_cells(out, wh)
    return out


# ---------------------------------------------------------------- prometheus
def _prom_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_float(v: float) -> str:
    return repr(float(v))


def to_prometheus(cells: dict, counters: Optional[dict] = None,
                  gauges: Optional[dict] = None) -> str:
    """Prometheus text exposition (format version 0.0.4) of the metrics
    plane: `jbp_counter_total{name=...}` for the Darshan counters,
    `jbp_<gauge>` gauges, and `jbp_latency_seconds` /
    `jbp_size_bytes` histogram families labelled {op, key} with the
    shared log2 bucket edges (cumulative, `+Inf`-terminated, `_sum` and
    `_count` per series — the grammar standard scrapers expect)."""
    lines: list[str] = []
    if counters:
        lines.append("# HELP jbp_counter_total Darshan counter totals "
                     "(repro_torch.core.darshan)")
        lines.append("# TYPE jbp_counter_total counter")
        for name in sorted(counters):
            lines.append(f'jbp_counter_total{{name="{_prom_label(name)}"}} '
                         f'{_prom_float(counters[name])}')
    for gname in sorted(gauges or {}):
        full = f"jbp_{gname}"
        lines.append(f"# HELP {full} jbpd gauge")
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full} {_prom_float(gauges[gname])}")
    if cells:
        lines.append("# HELP jbp_latency_seconds per-op latency "
                     "(fixed log2 buckets, repro_torch.core.metrics)")
        lines.append("# TYPE jbp_latency_seconds histogram")
        for ck in sorted(cells):
            op, key = split_key(ck)
            cell = cells[ck]
            lab = f'op="{_prom_label(op)}",key="{_prom_label(key)}"'
            cum = 0
            for i, c in enumerate(cell["lat"][:-1]):
                cum += c
                le = _prom_float(bucket_le(i) * LAT_UNIT_S)
                lines.append(f'jbp_latency_seconds_bucket{{{lab},'
                             f'le="{le}"}} {cum}')
            lines.append(f'jbp_latency_seconds_bucket{{{lab},le="+Inf"}} '
                         f'{cell["count"]}')
            lines.append(f'jbp_latency_seconds_sum{{{lab}}} '
                         f'{_prom_float(cell["sum_s"])}')
            lines.append(f'jbp_latency_seconds_count{{{lab}}} '
                         f'{cell["count"]}')
        sized = {ck: c for ck, c in cells.items() if sum(c["size"])}
        if sized:
            lines.append("# HELP jbp_size_bytes per-op transfer size "
                         "(fixed log2 buckets, repro_torch.core.metrics)")
            lines.append("# TYPE jbp_size_bytes histogram")
            for ck in sorted(sized):
                op, key = split_key(ck)
                cell = sized[ck]
                lab = f'op="{_prom_label(op)}",key="{_prom_label(key)}"'
                nsz = sum(cell["size"])
                cum = 0
                for i, c in enumerate(cell["size"][:-1]):
                    cum += c
                    lines.append(f'jbp_size_bytes_bucket{{{lab},'
                                 f'le="{_prom_float(bucket_le(i))}"}} {cum}')
                lines.append(f'jbp_size_bytes_bucket{{{lab},le="+Inf"}} '
                             f'{nsz}')
                lines.append(f'jbp_size_bytes_sum{{{lab}}} '
                             f'{_prom_float(cell["sum_b"])}')
                lines.append(f'jbp_size_bytes_count{{{lab}}} {nsz}')
    return "\n".join(lines) + "\n"
