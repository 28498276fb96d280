"""jbpd — the JBP series data service (the served read plane).

Until now every consumer of a series was its own process: it opened the
series, parsed the metadata, read + decompressed every payload byte it
wanted — and the next consumer did it all again (the exact cost the
Darshan instrumentation follow-up attributes to analysis pipelines that
re-open their inputs per tool). `jbpd` is the long-lived gateway in front
of `BpReader` that the ROADMAP's "millions of users" plane calls for:

    client                gateway (JbpDaemon)        server (SeriesServer)
    ------                -------------------        ---------------------
    SeriesClient  --sock-->  accept / framing  --->  one BpReader per series
      variables()            per-conn thread         one shared ReaderPool
      layout()               per-conn ShmRing        one ChunkCache (LRU +
      var_minmax()           (zero-copy responses)    request coalescing)
      iter_chunks()
      read_var()     <--shm-- response slot / socket frame fallback

The split mirrors the hyadmin gateway/server/admin layering (SNIPPETS §2):
the GATEWAY owns connections, framing and per-connection pre-provisioned
response rings; the SERVER owns the readers, the pool and the cache; the
ADMIN surface (`stats`, `ping`, `watch`, `shutdown`) is how operators and
the CLI observe and drive a running daemon — `watch` streams periodic
counter DELTAS (SERVICE_*/TRANSPORT_*/POSIX_* + cache + DXT stats) over
the same framed protocol, the live feed the ROADMAP's autotuning
controller reads next.

What the daemon adds over N independent readers:

  * open-once: each series' md.idx/md.0 is scanned and parsed once for
    every client that will ever ask,
  * `ChunkCache` — an LRU of DECOMPRESSED chunks keyed by
    (series, step, var, agg, file_offset) under a byte budget: a re-read
    is a memcpy, not a payload read + decompress,
  * request coalescing — concurrent clients asking for overlapping boxes
    need the same chunks; followers of an in-flight fetch wait on the
    leader's result instead of issuing N identical read+decompress passes
    (`SERVICE_COALESCED` counts every avoided fetch),
  * zero-copy handoff — a local client's `read_var` response is written
    once into the connection's `ShmRing` slot and the client maps it
    (`ShmRing.attach`, the non-child topology); oversized/ring-full
    responses and remote (TCP) clients fall back to socket framing. The
    transport degrades, it never fails.

Protocol: length-prefixed frames — `<II` (json_len, body_len), a JSON
header, then an optional binary body. One request at a time per
connection; `release` (slot free) and `hello` are one-way/handshake ops.
Every data-plane error (unknown variable, unregistered series, a
`CorruptPayloadError` from a bit-rotted chunk) maps to a clean
`{"ok": false, "error": {kind, msg}}` response — the connection survives.

Counters (`repro_torch.core.darshan.MONITOR`): SERVICE_CACHE_HIT/MISS,
SERVICE_COALESCED, SERVICE_SHM_BYTES, SERVICE_SOCKET_BYTES — the service
plane is observable exactly like the write plane, and `--io-report` on
the CLI prints them at exit.
"""
from __future__ import annotations

import json
import pathlib
import socket
import struct
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Optional, Union

import numpy as np

from repro_torch.core.bp_engine import BpReader
from repro_torch.core.compression import CorruptPayloadError
from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import (METRICS, RollingBaseline, summarize_cell,
                                      to_prometheus)
from repro_torch.core.shm_transport import (DEFAULT_RING_BYTES, ShmHeader,
                                            ShmRing, unlink_rings)

DEFAULT_CACHE_BYTES = 256 * 1024 ** 2
FRAME = struct.Struct("<II")             # json header bytes, binary body bytes

# the counter families `stats` reports and `watch` streams deltas of — one
# list, so a watch's begin + Σ(deltas) always reconciles against --stats
WATCH_COUNTERS = (CTR.SERVICE_CACHE_HIT, CTR.SERVICE_CACHE_MISS,
                  CTR.SERVICE_COALESCED, CTR.SERVICE_SHM_BYTES,
                  CTR.SERVICE_SOCKET_BYTES, CTR.TRANSPORT_SHM_BYTES,
                  CTR.TRANSPORT_PICKLE_FALLBACK_BYTES,
                  CTR.POSIX_READS, CTR.POSIX_WRITES,
                  CTR.POSIX_BYTES_READ, CTR.POSIX_BYTES_WRITTEN)


# ---------------------------------------------------------------------- errors
class JbpdRequestError(RuntimeError):
    """The daemon answered `{"ok": false}`: the request failed but the
    connection (and the daemon) are fine. `kind` is the machine-readable
    class — "not-found", "not-served", "corrupt-payload", "bad-request"."""

    def __init__(self, kind: str, msg: str):
        self.kind = kind
        super().__init__(f"[{kind}] {msg}")


class DaemonDisconnectedError(ConnectionError):
    """The daemon went away mid-conversation (restarted, crashed, or was
    shut down). The client drops its socket and shm attachments; the NEXT
    call transparently reconnects — callers that can retry, should."""


def _error_kind(e: BaseException) -> str:
    if isinstance(e, CorruptPayloadError):
        return "corrupt-payload"
    if isinstance(e, (KeyError, FileNotFoundError)):
        return "not-found"
    if isinstance(e, PermissionError):
        return "not-served"
    if isinstance(e, (ValueError, TypeError)):
        return "bad-request"
    return type(e).__name__


# --------------------------------------------------------------------- framing
def _json_default(o):
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    if isinstance(o, (tuple, set)):
        return list(o)
    raise TypeError(f"not JSON-serializable: {type(o)}")


def send_msg(sock: socket.socket, hdr: dict, body: bytes = b""):
    blob = json.dumps(hdr, default=_json_default).encode()
    sock.sendall(FRAME.pack(len(blob), len(body)) + blob)
    if body:
        sock.sendall(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None                        # orderly EOF
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> tuple[Optional[dict], bytes]:
    """(header, body); (None, b"") on EOF at a frame boundary. A torn frame
    (EOF mid-message) raises DaemonDisconnectedError — the peer died."""
    raw = _recv_exact(sock, FRAME.size)
    if raw is None:
        return None, b""
    hl, bl = FRAME.unpack(raw)
    blob = _recv_exact(sock, hl)
    if blob is None:
        raise DaemonDisconnectedError("peer closed mid-frame")
    body = _recv_exact(sock, bl) if bl else b""
    if bl and body is None:
        raise DaemonDisconnectedError("peer closed mid-frame")
    return json.loads(blob), body or b""


# ----------------------------------------------------------------- chunk cache
class _Fetch:
    """One in-flight chunk fetch: the leader resolves it, followers wait."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class ChunkCache:
    """LRU of decompressed chunk arrays under a byte budget, with request
    coalescing. Plugs into `BpReader(chunk_cache=...)` — see
    `BpReader.read_chunk` for the key contract. Thread-safe; the fetch
    itself runs OUTSIDE the lock (reads and decompression overlap across
    distinct chunks; identical chunks coalesce onto one leader)."""

    def __init__(self, budget_bytes: int = DEFAULT_CACHE_BYTES,
                 monitor=MONITOR):
        self.budget = int(budget_bytes)
        self.mon = monitor
        self._lock = threading.Lock()
        self._lru: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._inflight: dict[tuple, _Fetch] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.evictions = 0

    def get_or_fetch(self, key: tuple, fetch, nbytes: int) -> np.ndarray:
        series = str(key[0])
        while True:
            with self._lock:
                arr = self._lru.get(key)
                if arr is not None:
                    self._lru.move_to_end(key)
                    self.hits += 1
                    self.mon.record(0, series, CTR.SERVICE_CACHE_HIT)
                    return arr
                fl = self._inflight.get(key)
                if fl is None:
                    fl = self._inflight[key] = _Fetch()
                    leader = True
                else:
                    leader = False
                    self.coalesced += 1
                    self.mon.record(0, series, CTR.SERVICE_COALESCED)
            if not leader:
                fl.event.wait()
                if fl.error is not None:
                    raise fl.error
                return fl.result
            try:
                tf = time.perf_counter()
                with TRACER.span("cache_fetch", path=series) as sp:
                    arr = fetch()
                    sp.length = arr.nbytes
                if METRICS.enabled:
                    METRICS.observe("cache_fetch",
                                    time.perf_counter() - tf,
                                    nbytes=arr.nbytes, key=series)
                if arr.flags.writeable:        # cached objects are shared
                    arr = arr.copy()
                arr.flags.writeable = False
                fl.result = arr
            except BaseException as e:
                fl.error = e
                with self._lock:
                    self._inflight.pop(key, None)
                fl.event.set()
                raise
            with self._lock:
                self.misses += 1
                self.mon.record(0, series, CTR.SERVICE_CACHE_MISS)
                if arr.nbytes <= self.budget:  # oversized: serve, don't cache
                    self._lru[key] = arr
                    self.bytes += arr.nbytes
                    while self.bytes > self.budget:
                        _, old = self._lru.popitem(last=False)
                        self.bytes -= old.nbytes
                        self.evictions += 1
                self._inflight.pop(key, None)
            fl.event.set()
            return arr

    def invalidate(self, series: Optional[str] = None):
        """Drop cached chunks (of one series, or everything) — the admin
        hook for a series that was repacked/rewritten under the daemon."""
        with self._lock:
            if series is None:
                self._lru.clear()
                self.bytes = 0
                return
            s = str(series)
            for k in [k for k in self._lru if str(k[0]) == s]:
                self.bytes -= self._lru.pop(k).nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"budget_bytes": self.budget, "bytes": self.bytes,
                    "entries": len(self._lru), "hits": self.hits,
                    "misses": self.misses, "coalesced": self.coalesced,
                    "evictions": self.evictions}


# ---------------------------------------------------------------------- server
class SeriesServer:
    """The query-execution half: one `BpReader` per served series (opened
    once, shared by every connection), one `ChunkCache`, one ReaderPool
    fan-out setting. Knows nothing about sockets — `JbpDaemon` (or a test)
    drives it directly via `query()`."""

    def __init__(self, series=(), *, cache_bytes: int = DEFAULT_CACHE_BYTES,
                 parallel: int = 0, open_any: bool = False):
        # uptime is a DURATION: measured on the monotonic clock (jbplint
        # JBP006 — wall clock is for epoch stamps only, it can step)
        self.t0 = time.perf_counter()
        self.baseline = RollingBaseline()      # straggler EWMA per (op, key)
        self.cache = ChunkCache(cache_bytes)
        self.parallel = int(parallel)
        self.registered = {str(pathlib.Path(str(s)).resolve())
                           for s in series}
        # no pre-registered series -> serve whatever valid series is asked
        self.open_any = bool(open_any) or not self.registered
        self._readers: dict[str, BpReader] = {}
        self._lock = threading.Lock()
        for s in sorted(self.registered):      # pre-open: fail at startup,
            self.reader(s)                     # not on the first request

    def reader(self, series) -> BpReader:
        if series is None:
            raise ValueError("request names no series")
        key = str(pathlib.Path(str(series)).resolve())
        with self._lock:
            r = self._readers.get(key)
            if r is not None:
                return r
        if not self.open_any and key not in self.registered:
            raise PermissionError(
                f"series {key} is not served by this daemon "
                f"(serving: {sorted(self.registered)})")
        if not (pathlib.Path(key) / "md.idx").exists():
            raise FileNotFoundError(f"{key}: not a JBP series (no md.idx)")
        r = BpReader(key, parallel=self.parallel, chunk_cache=self.cache)
        with self._lock:
            # two threads may have opened concurrently; keep the first
            r = self._readers.setdefault(key, r)
        return r

    # ------------------------------------------------------------- dispatch
    def query(self, req: dict) -> Union[dict, np.ndarray]:
        """Execute one request. Returns a JSON-able dict, or an ndarray
        (read_var) that the gateway ships shm/framed. Raises on bad
        requests — the gateway maps exceptions to error responses."""
        op = req.get("op")
        if op == "ping":
            return {"pong": True}
        if op == "stats":
            return self.stats()
        if op == "metrics":
            return self.metrics()
        r = self.reader(req.get("series"))
        if op == "steps":
            return {"steps": r.valid_steps()}
        if op == "variables":
            return {"variables": r.variables(req.get("steps"))}
        if op == "layout":
            return {"layout": r.layout(req.get("steps"))}
        if op == "attributes":
            return {"attrs": r.attributes(int(req["step"]))}
        if op == "var_minmax":
            return {"minmax": r.var_minmax(int(req["step"]), req["name"])}
        if op == "iter_chunks":
            return {"chunks": [c.to_json() for c in
                               r.iter_chunks(int(req["step"]), req["name"])]}
        if op == "read_var":
            off = req.get("offset")
            ext = req.get("extent")
            return r.read_var(int(req["step"]), req["name"],
                              tuple(off) if off is not None else None,
                              tuple(ext) if ext is not None else None)
        raise ValueError(f"unknown op {op!r}")

    def counters(self) -> dict:
        """Absolute values of the watched counter families — the ONE
        source both `stats` and the `watch` delta stream read, so they
        can never disagree."""
        tot = MONITOR.report()["total"]
        return {k: tot.get(k, 0.0) for k in WATCH_COUNTERS}

    def stats(self) -> dict:
        with self._lock:
            series = sorted(self._readers)
        return {"series": series, "cache": self.cache.stats(),
                "parallel": self.parallel,
                "uptime_s": time.perf_counter() - self.t0,
                "dxt": TRACER.stats(),
                "metrics": METRICS.stats(),
                "counters": self.counters()}

    # -------------------------------------------------------- metrics plane
    def stragglers(self) -> list[dict]:
        """Current straggler/anomaly report over the live histogram cells
        (peer-median p99 ratio + rolling EWMA baseline). Serialized: the
        baseline's history is shared mutable state."""
        cells = METRICS.merged()
        with self._lock:
            return self.baseline.update(cells)

    def metrics(self) -> dict:
        """The `metrics` admin op: every consumer view of the histogram
        plane in one response — raw cells (additive, journal-compatible),
        deterministic percentile summaries (identical to what `jbpstat`
        derives from a journal of the same run), the straggler report,
        and the Prometheus text exposition the HTTP shim serves."""
        cells = METRICS.merged()
        with self._lock:
            stragglers = self.baseline.update(cells)
        return {"enabled": METRICS.enabled,
                "counters": MONITOR.report()["total"],
                "hists": cells,
                "percentiles": {ck: summarize_cell(c)
                                for ck, c in cells.items()},
                "stragglers": stragglers,
                "text": self.metrics_text(cells)}

    def metrics_text(self, cells: Optional[dict] = None) -> str:
        """Prometheus text-format exposition (0.0.4) of counters, service
        gauges and the latency/size histogram families."""
        if cells is None:
            cells = METRICS.merged()
        cs = self.cache.stats()
        gauges = {"uptime_seconds": time.perf_counter() - self.t0,
                  "cache_bytes": cs["bytes"],
                  "cache_entries": cs["entries"],
                  "metrics_enabled": 1 if METRICS.enabled else 0}
        return to_prometheus(cells, counters=MONITOR.report()["total"],
                             gauges=gauges)

    def close(self):
        with self._lock:
            readers, self._readers = list(self._readers.values()), {}
        for r in readers:
            r.close()


# --------------------------------------------------------------------- gateway
class JbpDaemon:
    """The connection half: listening socket (AF_UNIX path or TCP port),
    one thread per client, per-connection response rings. `serve_forever`
    blocks (the CLI); `start()` runs it on a daemon thread (tests,
    benchmarks, embedding)."""

    def __init__(self, server: SeriesServer, *,
                 socket_path=None, host: str = "127.0.0.1",
                 port: Optional[int] = None, shm: bool = True,
                 ring_bytes: int = DEFAULT_RING_BYTES):
        if (socket_path is None) == (port is None):
            raise ValueError("exactly one of socket_path / port required")
        self.server = server
        self.shm_enabled = bool(shm) and socket_path is not None
        self.ring_bytes = int(ring_bytes)
        if socket_path is not None:
            self.socket_path = str(socket_path)
            pathlib.Path(self.socket_path).unlink(missing_ok=True)
            self._listener = socket.socket(socket.AF_UNIX)
            self._listener.bind(self.socket_path)
            self.address: Any = self.socket_path
        else:
            self.socket_path = None
            self._listener = socket.socket(socket.AF_INET)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self.address = self._listener.getsockname()
        self._listener.listen(64)
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        self._conn_seq = 0                     # trace tid <-> connection
        self._conns: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._rings: list[ShmRing] = []
        self._accept_thread: Optional[threading.Thread] = None
        # abnormal exit must not leak /dev/shm — same discipline as the
        # write plane's ring owners
        self._finalizer = weakref.finalize(self, unlink_rings, self._rings)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "JbpDaemon":
        """Accept loop on a background thread; the listener is already
        bound+listening, so a client may connect the moment this returns."""
        t = threading.Thread(target=self.serve_forever, name="jbpd-accept",
                             daemon=True)
        self._accept_thread = t
        t.start()
        return self

    def serve_forever(self):
        while not self._stopping.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:                    # listener closed by stop()
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="jbpd-conn", daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def stop(self):
        """Close the listener and every live connection, join the workers,
        unlink the rings. Idempotent; callable from a connection thread
        (the `shutdown` op) or any other."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        # shutdown() BEFORE close(): on Linux, closing an fd another thread
        # is blocked in accept() on does not wake it — shutdown() does
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self.socket_path:
            pathlib.Path(self.socket_path).unlink(missing_ok=True)
        with self._lock:
            conns, self._conns = self._conns, []
            threads, self._threads = self._threads, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        me = threading.current_thread()
        for t in threads + ([self._accept_thread] if self._accept_thread
                            else []):
            if t is not me:
                t.join(timeout=2.0)
        unlink_rings(self._rings)
        self._rings.clear()
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.stop()

    # ----------------------------------------------------------- connection
    def _serve_conn(self, conn: socket.socket):
        ring: Optional[ShmRing] = None
        use_shm = False
        with self._lock:
            self._conn_seq += 1
            cid = self._conn_seq               # rank/tid of this connection
        try:
            while True:
                try:
                    hdr, _ = recv_msg(conn)
                except (DaemonDisconnectedError, OSError):
                    break
                if hdr is None:
                    break
                op = hdr.get("op")
                if op == "hello":
                    use_shm = bool(hdr.get("shm")) and self.shm_enabled
                    if use_shm and ring is None:
                        # pre-provision the connection's response ring NOW
                        # (hyadmin-style per-concurrency provisioning): the
                        # first read_var pays no setup, and ring creation
                        # failures surface at handshake time
                        ring = ShmRing(self.ring_bytes)
                        self._rings.append(ring)
                    send_msg(conn, {"ok": True, "server": "jbpd",
                                    "shm": use_shm,
                                    "ring": ring.name if use_shm else None})
                    continue
                if op == "release":
                    if ring is not None:
                        ring.free(int(hdr["offset"]))
                    continue
                if op == "shutdown":
                    send_msg(conn, {"ok": True, "stopping": True})
                    threading.Thread(target=self.stop, daemon=True).start()
                    break
                if op == "watch":
                    try:
                        self._serve_watch(conn, hdr)
                    except OSError:
                        break                  # client went away mid-stream
                    continue
                try:
                    tq = time.perf_counter()
                    with TRACER.span("serve", path=str(op), rank=cid):
                        res = self.server.query(hdr)
                    if METRICS.enabled:
                        METRICS.observe("serve", time.perf_counter() - tq,
                                        key=str(op))
                except BaseException as e:     # noqa: BLE001 — conn survives
                    send_msg(conn, {"ok": False,
                                    "error": {"kind": _error_kind(e),
                                              "msg": str(e)}})
                    continue
                if isinstance(res, np.ndarray):
                    self._send_array(conn, ring if use_shm else None, res,
                                     str(hdr.get("series")))
                else:
                    send_msg(conn, {"ok": True, "result": res})
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if ring is not None:
                ring.close()
                ring.unlink()
                with self._lock:
                    if ring in self._rings:
                        self._rings.remove(ring)

    def _serve_watch(self, conn: socket.socket, hdr: dict):
        """The live metrics stream: one "watch" request, many response
        frames on the same framed protocol. Frame sequence:

            {"ok": true, "watch": {"begin": <abs counters>, ...}}
            {"ok": true, "frame": {"seq", "t", "counters", "delta",
                                   "cache", "dxt", "stragglers"}}  x count
            {"ok": true, "done": true, "counters": <abs counters>}

        Invariant (the autotuning contract): begin + Σ(frame deltas) ==
        done counters == what `stats` reports at that moment — `counters`
        is the same `SeriesServer.counters()` everywhere."""
        interval = max(0.01, float(hdr.get("interval_s", 1.0)))
        count = max(1, min(int(hdr.get("count", 2)), 100000))
        prev = self.server.counters()
        send_msg(conn, {"ok": True, "watch": {"begin": prev,
                                              "interval_s": interval,
                                              "count": count}})
        for seq in range(count):
            if self._stopping.wait(interval):
                break                          # daemon stopping: end early
            cur = self.server.counters()
            send_msg(conn, {"ok": True, "frame": {
                "seq": seq, "t": time.time(), "counters": cur,
                "delta": {k: cur[k] - prev.get(k, 0.0) for k in cur},
                "cache": self.server.cache.stats(),
                "dxt": TRACER.stats(),
                "stragglers": self.server.stragglers()}})
            prev = cur
        send_msg(conn, {"ok": True, "done": True, "counters": prev})

    def _send_array(self, conn, ring: Optional[ShmRing], arr: np.ndarray,
                    series: str):
        """Zero-copy handoff when the connection has a ring with room;
        socket framing otherwise (remote client, oversized response, or a
        ring still full of unreleased slots)."""
        if ring is not None:
            shdr = ring.write_array(np.ascontiguousarray(arr))
            if shdr is not None:
                MONITOR.record(0, series, CTR.SERVICE_SHM_BYTES,
                               float(arr.nbytes))
                send_msg(conn, {"ok": True,
                                "shm": {"ring": ring.name,
                                        "offset": shdr.offset,
                                        "nbytes": shdr.nbytes,
                                        "dtype": shdr.dtype,
                                        "shape": list(shdr.shape)}})
                return
        MONITOR.record(0, series, CTR.SERVICE_SOCKET_BYTES, float(arr.nbytes))
        send_msg(conn, {"ok": True, "array": {"dtype": arr.dtype.str,
                                              "shape": list(arr.shape)}},
                 np.ascontiguousarray(arr).tobytes())


# ----------------------------------------------------------------- http shim
class MetricsHttpShim:
    """Minimal HTTP exposition endpoint for standard scrapers: GET `/` or
    `/metrics` returns `SeriesServer.metrics_text()` (Prometheus text
    format 0.0.4). Deliberately NOT a web framework — one handler, one
    content type, bound to loopback by default; the framed-socket
    `metrics` op remains the full-fidelity admin surface. `port=0` binds
    an ephemeral port (tests); `.port` is the bound port either way."""

    def __init__(self, server: SeriesServer, *, host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        srv = server

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):                  # noqa: N802 — stdlib API name
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404, "only /metrics is served")
                    return
                body = srv.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):         # scrapes are periodic noise
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="jbpd-metrics-http", daemon=True)

    def start(self) -> "MetricsHttpShim":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


# ---------------------------------------------------------------------- client
class SeriesClient:
    """One connection to a running jbpd. `address` is a unix-socket path
    (str/Path) or a (host, port) tuple. `series` fixes the series every
    query names (pass per-call to override).

    Local clients negotiate shm at hello: `read_var` responses arrive as a
    ring slot the client maps via `ShmRing.attach` — one copy out of
    shared pages instead of a socket stream. The client releases each slot
    right after copying (the FIFO free discipline needs nothing more,
    because the protocol is one request at a time per connection).

    If the daemon restarts, the NEXT call raises DaemonDisconnectedError
    (clear, not a bare EPIPE) and drops the dead socket + stale ring
    attachments; the call after that reconnects transparently."""

    def __init__(self, address, series=None, *, shm: Optional[bool] = None,
                 timeout: float = 30.0):
        self.address = (str(address) if isinstance(address, (str, pathlib.Path))
                        else tuple(address))
        self.series = str(series) if series is not None else None
        self.want_shm = (shm if shm is not None
                         else isinstance(self.address, str))
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._shm_ok = False
        self._rings: dict[str, ShmRing] = {}
        self._lock = threading.Lock()          # one request at a time

    # ----------------------------------------------------------- transport
    def _dial(self, *, shm: bool) -> tuple[socket.socket, bool]:
        """Open ONE handshaken connection to the daemon and return
        (socket, shm_granted). Owns nothing on self — `_connect` installs
        the result as the client's request connection; `watch()` dials its
        own so a long stream never starves concurrent `_call`s."""
        try:
            if isinstance(self.address, str):
                s = socket.socket(socket.AF_UNIX)
                s.settimeout(self.timeout)
                s.connect(self.address)
            else:
                s = socket.create_connection(self.address,
                                             timeout=self.timeout)
        except OSError as e:
            raise DaemonDisconnectedError(
                f"cannot reach jbpd at {self.address!r}: {e} "
                f"(daemon not running, or restarted on another address)"
            ) from e
        try:
            send_msg(s, {"op": "hello", "shm": shm})
            hdr, _ = recv_msg(s)
            if hdr is None:
                raise DaemonDisconnectedError(
                    f"jbpd at {self.address!r} closed the connection during "
                    f"handshake")
        except BaseException as e:
            # close on EVERY failed handshake. `except OSError` alone used
            # to leak the freshly dialed socket when the daemon died in a
            # way that didn't surface as an OSError — e.g. a garbage frame
            # from a half-dead peer raising JSONDecodeError inside
            # recv_msg. One socket per watch() retry loop adds up to fd
            # exhaustion in a long-lived client.
            try:
                s.close()
            except OSError:
                pass
            if isinstance(e, DaemonDisconnectedError):
                raise
            if isinstance(e, OSError):
                raise DaemonDisconnectedError(
                    f"jbpd at {self.address!r} dropped the connection "
                    f"during handshake") from e
            raise
        return s, bool(hdr.get("shm"))

    def _connect(self):
        self._sock, self._shm_ok = self._dial(shm=self.want_shm)

    def _drop(self):
        """Forget the dead connection and every shm attachment made through
        it (a restarted daemon owns brand-new rings)."""
        s, self._sock = self._sock, None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass
        rings, self._rings = self._rings, {}
        for r in rings.values():
            r.close()

    def _call(self, req: dict) -> tuple[dict, bytes]:
        with self._lock:
            if self._sock is None:
                self._connect()
            try:
                # blocking under _lock is this protocol's design: ONE
                # framed request in flight per connection, and the lock is
                # exactly that serialization (bounded by the socket
                # timeout). Streams (watch) dial their own connection.
                send_msg(self._sock, req)            # jbplint: disable=JBP004
                hdr, body = recv_msg(self._sock)     # jbplint: disable=JBP004
            except (OSError, DaemonDisconnectedError) as e:
                self._drop()
                raise DaemonDisconnectedError(
                    f"jbpd at {self.address!r} went away mid-request "
                    f"(restarted?) — the connection was dropped; the next "
                    f"call reconnects") from e
            if hdr is None:
                self._drop()
                raise DaemonDisconnectedError(
                    f"jbpd at {self.address!r} closed the connection "
                    f"(shut down or restarted); the next call reconnects")
            if not hdr.get("ok"):
                err = hdr.get("error", {})
                raise JbpdRequestError(err.get("kind", "error"),
                                       err.get("msg", "request failed"))
            if "shm" in hdr:
                return hdr, self._read_shm(hdr["shm"])
            return hdr, body

    def _read_shm(self, s: dict) -> bytes:
        """Copy the response out of the daemon's ring slot, then release
        it. Returns raw bytes (the caller reshapes)."""
        name = s["ring"]
        ring = self._rings.get(name)
        try:
            if ring is None:
                ring = self._rings[name] = ShmRing.attach(name)
            view = ring.view(ShmHeader(s["offset"], s["nbytes"], s["dtype"],
                                       tuple(s["shape"])))
            data = view.tobytes()
            del view
        finally:
            # release even on a failed attach/copy: the slot must not leak
            try:
                send_msg(self._sock, {"op": "release",
                                      "offset": s["offset"]})
            except OSError:
                pass
        return data

    # -------------------------------------------------------------- queries
    def _series(self, series) -> str:
        s = series if series is not None else self.series
        if s is None:
            raise ValueError("no series bound to this client and none given")
        return str(s)

    def ping(self) -> bool:
        hdr, _ = self._call({"op": "ping"})
        return bool(hdr["result"]["pong"])

    def stats(self) -> dict:
        hdr, _ = self._call({"op": "stats"})
        return hdr["result"]

    def metrics(self) -> dict:
        """The daemon's histogram plane: cells, percentile summaries,
        stragglers, Prometheus text (the `metrics` admin op)."""
        hdr, _ = self._call({"op": "metrics"})
        return hdr["result"]

    def watch(self, interval_s: float = 1.0, count: int = 2,
              on_frame=None) -> dict:
        """Stream `count` periodic counter-delta frames from the daemon
        (the `watch` op). Returns {"begin": <abs counters>, "frames":
        [frame, ...], "end": <abs counters>}; `on_frame(frame)` is called
        live per frame (the CLI prints from it). Blocking, but on a
        DEDICATED connection dialed for the stream — it never takes the
        client's request lock, so stats()/read() from other threads keep
        answering while a watch runs (a count*interval stream under
        `_lock` used to starve every concurrent call — jbplint JBP004)."""
        sock, _ = self._dial(shm=False)
        try:
            send_msg(sock, {"op": "watch",
                            "interval_s": float(interval_s),
                            "count": int(count)})
            frames: list[dict] = []
            begin = None
            while True:
                hdr, _ = recv_msg(sock)
                if hdr is None:
                    raise DaemonDisconnectedError(
                        f"jbpd at {self.address!r} closed the "
                        f"connection mid-watch")
                if not hdr.get("ok"):
                    err = hdr.get("error", {})
                    raise JbpdRequestError(err.get("kind", "error"),
                                           err.get("msg", "watch failed"))
                if "watch" in hdr:
                    begin = hdr["watch"]["begin"]
                    continue
                if hdr.get("done"):
                    return {"begin": begin, "frames": frames,
                            "end": hdr.get("counters")}
                frames.append(hdr["frame"])
                if on_frame is not None:
                    on_frame(hdr["frame"])
        except OSError as e:
            raise DaemonDisconnectedError(
                f"jbpd at {self.address!r} went away mid-watch") from e
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def shutdown(self):
        """Admin: ask the daemon to stop (the response races the daemon's
        own teardown; either way the daemon is going down)."""
        try:
            self._call({"op": "shutdown"})
        except DaemonDisconnectedError:
            pass
        self._drop()

    def steps(self, series=None) -> list[int]:
        hdr, _ = self._call({"op": "steps", "series": self._series(series)})
        return hdr["result"]["steps"]

    def variables(self, steps=None, *, series=None) -> dict:
        hdr, _ = self._call({"op": "variables", "steps": steps,
                             "series": self._series(series)})
        return hdr["result"]["variables"]

    def layout(self, steps=None, *, series=None) -> dict[int, dict]:
        hdr, _ = self._call({"op": "layout", "steps": steps,
                             "series": self._series(series)})
        return {int(k): v for k, v in hdr["result"]["layout"].items()}

    def attributes(self, step: int, *, series=None) -> dict:
        hdr, _ = self._call({"op": "attributes", "step": int(step),
                             "series": self._series(series)})
        return hdr["result"]["attrs"]

    def var_minmax(self, step: int, name: str, *,
                   series=None) -> Optional[tuple]:
        hdr, _ = self._call({"op": "var_minmax", "step": int(step),
                             "name": name, "series": self._series(series)})
        mm = hdr["result"]["minmax"]
        return tuple(mm) if mm is not None else None

    def iter_chunks(self, step: int, name: str, *, series=None) -> list[dict]:
        hdr, _ = self._call({"op": "iter_chunks", "step": int(step),
                             "name": name, "series": self._series(series)})
        return hdr["result"]["chunks"]

    def read_var(self, step: int, name: str, offset=None, extent=None, *,
                 series=None) -> np.ndarray:
        hdr, data = self._call({
            "op": "read_var", "step": int(step), "name": name,
            "offset": list(offset) if offset is not None else None,
            "extent": list(extent) if extent is not None else None,
            "series": self._series(series)})
        meta = hdr.get("shm") or hdr["array"]
        arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]))
        return arr.reshape(tuple(meta["shape"])).copy()

    # ------------------------------------------------------------ lifecycle
    def close(self):
        self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
