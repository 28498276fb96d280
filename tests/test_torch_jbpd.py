"""The port's series data service (`repro_torch.serve.jbpd`) against the
JAX package's: each case of `tests/test_jbpd.py` on the port's modules
(ChunkCache, daemon and client end to end, shm fallback, corrupt
payloads, restarts, the metrics plane, the `_dial` fd leak), then the
wire protocol across the packages: a port client against a JAX-package
daemon serving a port series, a JAX-package client against a port daemon
serving a JAX-package series, box reads bit-identical to both readers,
and the rings of two daemons in one process apart."""
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import promtext
import pytest

from repro_torch.core.bp_engine import BpReader, BpWriter, EngineConfig
from repro_torch.core.compression import CorruptPayloadError
from repro_torch.core.darshan import MONITOR
from repro_torch.core.dxt import TRACER
from repro_torch.core.metrics import METRICS
from repro_torch.serve.jbpd import (FRAME, ChunkCache,
                                    DaemonDisconnectedError, JbpDaemon,
                                    JbpdRequestError, MetricsHttpShim,
                                    SeriesClient, SeriesServer)

#: `sun_path` holds 108 bytes, the terminating NUL included
SUN_PATH_MAX = 107


def _short_enough(sock):
    if len(os.fsencode(str(sock))) > SUN_PATH_MAX:
        raise ValueError(f"unix socket path too long for sun_path: {sock}")


@pytest.fixture(autouse=True)
def fresh_port_singletons():
    """The port's MONITOR, METRICS and TRACER are process-wide and apart
    from the JAX package's (which `conftest.py` resets)."""
    MONITOR.reset()
    METRICS.reset()
    yield
    if TRACER.enabled:
        TRACER.disable()
        TRACER.reset()
    if METRICS.enabled:
        METRICS.disable()
    METRICS.reset()
    MONITOR.reset()


def _write(path, *, n_ranks=4, aggregators=2, codec="zlib", steps=2, cols=4):
    cfg = EngineConfig(aggregators=aggregators, codec=codec, workers=3)
    w = BpWriter(path, n_ranks, cfg)
    rng = np.random.default_rng(7)
    truth = {}
    rows = n_ranks * 16
    for s in range(steps):
        w.begin_step(s)
        g = rng.normal(size=(rows, cols)).astype(np.float32)
        truth[s] = g
        for r in range(n_ranks):
            w.put("var/x", g[r * 16:(r + 1) * 16],
                  global_shape=g.shape, offset=(r * 16, 0), rank=r)
        w.end_step()
    w.close()
    return truth


@pytest.fixture()
def series(tmpdir_path):
    truth = _write(tmpdir_path / "s.bp4")
    return tmpdir_path / "s.bp4", truth


def _daemon(series_path, sock, **kw):
    _short_enough(sock)
    server_kw = {k: kw.pop(k) for k in ("cache_bytes", "parallel", "open_any")
                 if k in kw}
    server = SeriesServer([series_path], **server_kw)
    return JbpDaemon(server, socket_path=sock, **kw).start()


# ------------------------------------------------------------------ ChunkCache
def test_cache_hit_miss_lru_eviction():
    cache = ChunkCache(budget_bytes=3000)
    fetches = []

    def mk(key, n):
        def fetch():
            fetches.append(key)
            return np.full(n // 4, key[1], np.float32)
        return fetch

    a = cache.get_or_fetch(("s", 1, "v", 0, 0), mk(("s", 1, "v", 0, 0), 1024),
                           1024)
    assert not a.flags.writeable            # shared objects are read-only
    # hit: same key, no new fetch
    cache.get_or_fetch(("s", 1, "v", 0, 0), mk(("s", 1, "v", 0, 0), 1024),
                       1024)
    assert cache.stats()["hits"] == 1 and len(fetches) == 1
    # two more 1 KiB entries blow the 3000-byte budget -> LRU (first) evicted
    cache.get_or_fetch(("s", 2, "v", 0, 0), mk(("s", 2, "v", 0, 0), 1024),
                       1024)
    cache.get_or_fetch(("s", 3, "v", 0, 0), mk(("s", 3, "v", 0, 0), 1024),
                       1024)
    assert cache.stats()["evictions"] == 1
    cache.get_or_fetch(("s", 1, "v", 0, 0), mk(("s", 1, "v", 0, 0), 1024),
                       1024)
    assert fetches.count(("s", 1, "v", 0, 0)) == 2   # re-fetched after evict


def test_cache_oversized_entry_served_not_cached():
    cache = ChunkCache(budget_bytes=100)
    arr = cache.get_or_fetch(("s", 0, "v", 0, 0),
                             lambda: np.zeros(1024, np.uint8), 1024)
    assert arr.nbytes == 1024
    st = cache.stats()
    assert st["entries"] == 0 and st["bytes"] == 0 and st["misses"] == 1


def test_cache_coalesces_concurrent_identical_fetches():
    cache = ChunkCache()
    fetches = []
    gate = threading.Event()

    def slow_fetch():
        fetches.append(1)
        gate.wait(5.0)
        return np.arange(8, dtype=np.float32)

    results = []
    ts = [threading.Thread(
        target=lambda: results.append(
            cache.get_or_fetch(("s", 0, "v", 0, 0), slow_fetch, 32)))
        for _ in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.2)              # all four are in: one leader, 3 followers
    gate.set()
    for t in ts:
        t.join(5.0)
    assert len(fetches) == 1, "coalescing must leave exactly one fetcher"
    assert cache.stats()["coalesced"] == 3
    for r in results:
        np.testing.assert_array_equal(r, results[0])


def test_cache_failed_fetch_propagates_and_does_not_poison():
    cache = ChunkCache()

    def boom():
        raise CorruptPayloadError("injected rot")

    with pytest.raises(CorruptPayloadError):
        cache.get_or_fetch(("s", 0, "v", 0, 0), boom, 32)
    # the key is not stuck in-flight: a healthy retry succeeds
    out = cache.get_or_fetch(("s", 0, "v", 0, 0),
                             lambda: np.ones(4, np.float32), 16)
    np.testing.assert_array_equal(out, np.ones(4, np.float32))


# ------------------------------------------------------------------ end-to-end
def test_metadata_queries_match_direct_reader(series, tmpdir_path):
    path, truth = series
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with BpReader(path) as r, SeriesClient(d.address, path) as c:
            assert c.steps() == r.valid_steps()
            v = c.variables()
            assert set(v) == {"var/x"}
            assert tuple(v["var/x"]["shape"]) == truth[0].shape
            assert c.layout() == r.layout()
            assert c.var_minmax(0, "var/x") == r.var_minmax(0, "var/x")
            chunks = c.iter_chunks(0, "var/x")
            assert len(chunks) == 4
            assert chunks == [ch.to_json() for ch in r.iter_chunks(0, "var/x")]


def test_concurrent_clients_overlapping_boxes_bit_identical(series,
                                                            tmpdir_path):
    """N concurrent SeriesClients reading OVERLAPPING boxes must each get
    bytes identical to a direct BpReader.read_var of the same box."""
    path, truth = series
    boxes = [((0, 0), (64, 4)), ((8, 1), (40, 2)),
             ((0, 0), (32, 4)), ((16, 0), (48, 3))]
    with BpReader(path) as r:
        direct = [r.read_var(1, "var/x", o, e).tobytes() for o, e in boxes]
    errs, done = [], []
    with _daemon(path, tmpdir_path / "d.sock", parallel=2) as d:
        def client(i):
            try:
                with SeriesClient(d.address, path) as c:
                    for _ in range(3):
                        o, e = boxes[i]
                        got = c.read_var(1, "var/x", o, e)
                        assert got.tobytes() == direct[i]
                    done.append(i)
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
        assert not errs, errs
        assert sorted(done) == [0, 1, 2, 3]
        st = SeriesClient(d.address, path).stats()
        assert st["counters"]["SERVICE_CACHE_HIT"] > 0


def test_cache_hit_path_parity_after_eviction(series, tmpdir_path):
    """A budget too small for one step's chunks forces evictions between
    reads; re-reads (miss -> refetch) and any surviving hits must stay
    bit-identical to the direct read."""
    path, truth = series
    # the series holds 8 chunks x 256 B; a 1 KiB budget fits only 4
    with _daemon(path, tmpdir_path / "d.sock", cache_bytes=1024) as d:
        with SeriesClient(d.address, path) as c:
            for _ in range(3):
                for s in truth:
                    got = c.read_var(s, "var/x")
                    np.testing.assert_array_equal(got, truth[s])
            st = c.stats()["cache"]
            assert st["evictions"] > 0, "budget never forced an eviction"
    # ample budget: second read is all hits, still bit-identical
    with _daemon(path, tmpdir_path / "d2.sock") as d:
        with SeriesClient(d.address, path) as c:
            a = c.read_var(0, "var/x")
            b = c.read_var(0, "var/x")
            assert a.tobytes() == b.tobytes() == truth[0].tobytes()
            st = c.stats()["cache"]
            assert st["hits"] >= 4 and st["evictions"] == 0


def test_coalescing_counter_under_concurrent_identical_reads(series,
                                                             tmpdir_path,
                                                             monkeypatch):
    """Concurrent clients issuing IDENTICAL cold reads must share one
    fetch per chunk — the coalescing counter ends >= 1. A slowed fetch
    makes the overlap deterministic."""
    path, truth = series
    real_fetch = BpReader._fetch_chunk

    def slow_fetch(self, ch, dtype, local):
        time.sleep(0.15)
        return real_fetch(self, ch, dtype, local)

    monkeypatch.setattr(BpReader, "_fetch_chunk", slow_fetch)
    errs = []
    with _daemon(path, tmpdir_path / "d.sock") as d:
        def client():
            try:
                with SeriesClient(d.address, path) as c:
                    got = c.read_var(0, "var/x")
                    assert got.tobytes() == truth[0].tobytes()
            except Exception as exc:  # noqa: BLE001
                errs.append(exc)

        ts = [threading.Thread(target=client) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30.0)
        assert not errs, errs
        st = SeriesClient(d.address, path).stats()
        assert st["counters"]["SERVICE_COALESCED"] >= 1
        assert st["cache"]["coalesced"] >= 1


def test_shm_handoff_falls_back_to_socket_framing(series, tmpdir_path):
    """A response bigger than the connection's ring must arrive framed
    down the socket instead — same bytes, degraded transport."""
    path, truth = series
    with _daemon(path, tmpdir_path / "d.sock", ring_bytes=4096) as d:
        with SeriesClient(d.address, path) as c:
            small = c.read_var(0, "var/x", (0, 0), (16, 4))   # 256 B: shm
            np.testing.assert_array_equal(small, truth[0][:16])
            st = c.stats()["counters"]
            assert st["SERVICE_SHM_BYTES"] > 0
            assert st["SERVICE_SOCKET_BYTES"] == 0
    # a response bigger than the whole ring (16 KiB > 4 KiB capacity)
    big = _write(tmpdir_path / "big.bp4", n_ranks=4, cols=64, steps=1)
    with _daemon(tmpdir_path / "big.bp4", tmpdir_path / "d2.sock",
                 ring_bytes=4096) as d:
        with SeriesClient(d.address, tmpdir_path / "big.bp4") as c:
            got = c.read_var(0, "var/x")
            np.testing.assert_array_equal(got, big[0])
            st = c.stats()["counters"]
            assert st["SERVICE_SOCKET_BYTES"] >= got.nbytes


def test_client_shm_disabled_and_tcp_daemon(series, tmpdir_path):
    path, truth = series
    # unix socket, client opts out of shm
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, path, shm=False) as c:
            np.testing.assert_array_equal(c.read_var(0, "var/x"), truth[0])
    # TCP daemon: shm never negotiated
    server = SeriesServer([path])
    with JbpDaemon(server, port=0) as d:
        d.start()
        with SeriesClient(d.address, path) as c:
            np.testing.assert_array_equal(c.read_var(1, "var/x"), truth[1])
            assert c.stats()["counters"]["SERVICE_SHM_BYTES"] == 0


def test_corrupt_payload_maps_to_clean_error_response(tmpdir_path):
    """A bit-rotted chunk must surface as a 'corrupt-payload' error
    response — the connection and the daemon survive, and healthy
    variables remain readable."""
    w = BpWriter(tmpdir_path / "s.bp4", 2,
                 EngineConfig(aggregators=2, codec="zlib"))
    rng = np.random.default_rng(3)
    w.begin_step(0)
    ga = rng.normal(size=(32,)).astype(np.float32)
    gb = rng.normal(size=(32,)).astype(np.float32)
    for r in range(2):
        w.put("a", ga[r * 16:(r + 1) * 16], global_shape=(32,),
              offset=(r * 16,), rank=r)
        w.put("b", gb[r * 16:(r + 1) * 16], global_shape=(32,),
              offset=(r * 16,), rank=r)
    w.end_step()
    w.close()
    with BpReader(tmpdir_path / "s.bp4") as r:
        ch = next(c for c in r.iter_chunks(0, "b") if c.agg == 1)
    data = tmpdir_path / "s.bp4" / "data.1"
    raw = bytearray(data.read_bytes())
    for i in range(ch.file_offset, ch.file_offset + ch.nbytes):
        raw[i] ^= 0xFF
    data.write_bytes(bytes(raw))
    with _daemon(tmpdir_path / "s.bp4", tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, tmpdir_path / "s.bp4") as c:
            with pytest.raises(JbpdRequestError) as ei:
                c.read_var(0, "b")
            assert ei.value.kind == "corrupt-payload"
            np.testing.assert_array_equal(c.read_var(0, "a"), ga)


def test_client_survives_daemon_restart_with_clear_error(series,
                                                         tmpdir_path):
    path, truth = series
    sock = tmpdir_path / "d.sock"
    d1 = _daemon(path, sock)
    c = SeriesClient(d1.address, path)
    np.testing.assert_array_equal(c.read_var(0, "var/x"), truth[0])
    d1.stop()
    with pytest.raises(DaemonDisconnectedError, match="reconnect"):
        c.read_var(0, "var/x")
    # no daemon at all: still the clear error, not a bare OSError
    with pytest.raises(DaemonDisconnectedError, match="cannot reach"):
        c.ping()
    d2 = _daemon(path, sock)
    try:
        np.testing.assert_array_equal(c.read_var(1, "var/x"), truth[1])
    finally:
        c.close()
        d2.stop()


def test_unregistered_series_rejected_unless_open_any(series, tmpdir_path):
    path, truth = series
    other = _write(tmpdir_path / "o.bp4", steps=1)
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, tmpdir_path / "o.bp4") as c:
            with pytest.raises(JbpdRequestError) as ei:
                c.steps()
            assert ei.value.kind == "not-served"
    with _daemon(path, tmpdir_path / "d2.sock", open_any=True) as d:
        with SeriesClient(d.address, tmpdir_path / "o.bp4") as c:
            np.testing.assert_array_equal(c.read_var(0, "var/x"), other[0])


def test_daemon_shutdown_op_stops_daemon(series, tmpdir_path):
    path, _ = series
    d = _daemon(path, tmpdir_path / "d.sock")
    c = SeriesClient(d.address, path)
    assert c.ping()
    c.shutdown()
    deadline = time.time() + 5.0
    while not d._stopping.is_set() and time.time() < deadline:
        time.sleep(0.02)
    assert d._stopping.is_set()
    # once the accept loop is gone, new connections must be refused
    d._accept_thread.join(5.0)
    assert not d._accept_thread.is_alive()
    with pytest.raises(DaemonDisconnectedError):
        SeriesClient(d.address, path).ping()


def test_parallel_served_reads_use_reader_pool(series, tmpdir_path):
    """parallel=N on the server fans chunk fetches over the shared
    ReaderPool; results stay bit-identical."""
    path, truth = series
    with _daemon(path, tmpdir_path / "d.sock", parallel=4) as d:
        with SeriesClient(d.address, path) as c:
            for s in truth:
                assert c.read_var(s, "var/x").tobytes() == \
                    truth[s].tobytes()


def test_watch_does_not_starve_concurrent_calls(series, tmpdir_path):
    """Regression (jbplint JBP004): watch() used to hold the client's
    request lock for the whole count*interval stream, so a concurrent
    stats() from another thread stalled until the stream finished. The
    stream now runs on its own dedicated connection: stats() must answer
    in a fraction of the stream's duration, while the stream itself still
    delivers every frame."""
    path, _ = series
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, path) as c:
            got = {}

            def stream():
                got["watch"] = c.watch(interval_s=0.25, count=4)

            t = threading.Thread(target=stream, daemon=True)
            t.start()
            time.sleep(0.3)            # stream is mid-flight by now
            t0 = time.perf_counter()
            st = c.stats()             # must NOT wait out the ~1s stream
            latency = time.perf_counter() - t0
            t.join(10.0)
            assert not t.is_alive()
            assert latency < 0.5, f"stats() stalled {latency:.2f}s " \
                                  f"behind the watch stream"
            assert "series" in st or st  # a real stats payload came back
            assert len(got["watch"]["frames"]) == 4
            assert got["watch"]["begin"] is not None


# --------------------------------------------------------------- metrics plane
def test_metrics_op_matches_live_registry(series, tmpdir_path):
    """The `metrics` admin op returns the SAME deterministic percentiles
    the registry computes locally — and the reads the daemon just served
    show up on the serve-plane cells."""
    path, truth = series
    METRICS.enable()
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, path, shm=False) as c:
            for s in truth:
                c.read_var(s, "var/x")
            m = c.metrics()
    assert m["enabled"]
    ops = {ck.split("|")[0] for ck in m["hists"]}
    assert {"cache_fetch", "serve"} <= ops
    # same process here, so op percentiles == live registry percentiles
    from repro_torch.core.metrics import summarize_cell
    live = {ck: summarize_cell(cell) for ck, cell in METRICS.merged().items()}
    for ck, s in m["percentiles"].items():
        assert s["count"] == live[ck]["count"], ck
        assert s["p99_s"] == live[ck]["p99_s"], ck
    # the op also carries the rendered exposition, and it parses
    promtext.validate(m["text"])
    assert isinstance(m["stragglers"], list)


def test_metrics_http_shim_serves_valid_exposition(series, tmpdir_path):
    path, truth = series
    METRICS.enable()
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, path, shm=False) as c:
            c.read_var(0, "var/x")
        with MetricsHttpShim(d.server, port=0) as shim:
            url = f"http://{shim.host}:{shim.port}/metrics"
            with urllib.request.urlopen(url) as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"].startswith("text/plain")
                text = resp.read().decode()
            samples, types = promtext.validate(text)
            assert types["jbp_latency_seconds"] == "histogram"
            assert types["jbp_counter_total"] == "counter"
            assert "jbp_uptime_seconds" in types
            names = {n for n, _, _ in samples}
            assert "jbp_latency_seconds_bucket" in names
            # anything but / or /metrics is a 404, not a traceback
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://{shim.host}:{shim.port}/other")
            assert ei.value.code == 404


def test_watch_frames_carry_stragglers_key(series, tmpdir_path):
    path, _ = series
    METRICS.enable()
    with _daemon(path, tmpdir_path / "d.sock") as d:
        with SeriesClient(d.address, path, shm=False) as c:
            res = c.watch(interval_s=0.05, count=2)
    for frame in res["frames"]:
        assert isinstance(frame["stragglers"], list)


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def test_dial_closes_socket_on_non_oserror_handshake_failure(tmpdir_path):
    """Regression: `_dial` only closed the fresh socket on OSError, so a
    daemon dying in a way that surfaced as a NON-OSError — e.g. a garbage
    frame making json.loads blow up inside recv_msg — leaked one fd per
    attempt (watch() retry loops ground through them). Every failed
    handshake must now close the socket."""
    sock_path = str(tmpdir_path / "fake.sock")
    srv = socket.socket(socket.AF_UNIX)
    srv.bind(sock_path)
    srv.listen(32)
    stop = threading.Event()

    def garbage_daemon():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            with conn:
                try:
                    conn.recv(65536)                    # swallow the hello
                    blob = b"\x00this is not json"      # framed garbage
                    conn.sendall(FRAME.pack(len(blob), 0) + blob)
                    conn.recv(1)          # linger until the client closes
                except OSError:
                    pass

    t = threading.Thread(target=garbage_daemon, daemon=True)
    t.start()
    try:
        c = SeriesClient(sock_path, shm=False)
        with pytest.raises((DaemonDisconnectedError, ValueError)):
            c.ping()                                    # warm-up attempt
        base = _fd_count()
        for _ in range(20):
            with pytest.raises((DaemonDisconnectedError, ValueError)):
                c.ping()
        leaked = _fd_count() - base
        assert leaked <= 1, f"{leaked} fds leaked across 20 failed dials"
    finally:
        stop.set()
        srv.close()
        t.join(5.0)




# ------------------------------------------------- across the two packages
def _jax_plane():
    from repro.core.bp_engine import BpReader as JBpReader
    from repro.core.bp_engine import BpWriter as JBpWriter
    from repro.core.bp_engine import EngineConfig as JEngineConfig
    from repro.serve import jbpd as jjbpd
    return JBpReader, JBpWriter, JEngineConfig, jjbpd


BOXES = [((0, 0), (64, 4)), ((8, 1), (40, 2)), ((0, 0), (32, 4)),
         ((16, 0), (48, 3))]


def _write_with(writer, cfg, path):
    """`_write`'s blosc series through either package's writer."""
    w = writer(path, 4, cfg(aggregators=2, codec="blosc", workers=3))
    rng = np.random.default_rng(7)
    for s in range(2):
        w.begin_step(s)
        g = np.cumsum(rng.normal(size=(64, 4)), axis=0).astype(np.float32)
        for r in range(4):
            w.put("var/x", g[r * 16:(r + 1) * 16], global_shape=g.shape,
                  offset=(r * 16, 0), rank=r)
        w.end_step()
    w.close()


def _clients_read_boxes(client_cls, address, path, readers, **kw):
    """4 concurrent clients, one box each, 3 reads a box; every read
    bit-identical to each reader's read_var of the same box."""
    want = []
    for o, e in BOXES:
        direct = set()
        for reader_cls in readers:
            with reader_cls(path) as r:
                direct.add(r.read_var(1, "var/x", o, e).tobytes())
        assert len(direct) == 1            # the two readers agree
        want.append(direct.pop())
    errs, done = [], []

    def client(i):
        try:
            with client_cls(address, path, **kw) as c:
                for _ in range(3):
                    got = c.read_var(1, "var/x", *BOXES[i])
                    if got.tobytes() != want[i]:
                        raise AssertionError(f"box {i} differs")
                done.append(i)
        except Exception as exc:  # noqa: BLE001
            errs.append(exc)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30.0)
    assert not errs, errs
    assert sorted(done) == [0, 1, 2, 3]
    with client_cls(address, path, **kw) as c:
        return c.stats()["counters"]


TRANSPORTS = ["unix-shm", "unix-socket", "tcp"]


def _serve(daemon_mod, path, tmpdir_path, transport):
    server = daemon_mod.SeriesServer([path])
    if transport == "tcp":
        return daemon_mod.JbpDaemon(server, port=0).start(), {}
    sock = tmpdir_path / "x.sock"
    _short_enough(sock)
    return (daemon_mod.JbpDaemon(server, socket_path=sock).start(),
            {"shm": transport == "unix-shm"})


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_port_client_against_a_reference_daemon_on_a_port_series(
        tmpdir_path, transport):
    JBpReader, _, _, jjbpd = _jax_plane()
    path = tmpdir_path / "s.bp4"
    _write_with(BpWriter, EngineConfig, path)
    d, kw = _serve(jjbpd, path, tmpdir_path, transport)
    with d:
        ctr = _clients_read_boxes(SeriesClient, d.address, path,
                                  (BpReader, JBpReader), **kw)
    assert (ctr["SERVICE_SHM_BYTES"] > 0) == (transport == "unix-shm")


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_reference_client_against_a_port_daemon_on_a_jax_series(
        tmpdir_path, transport):
    JBpReader, JBpWriter, JEngineConfig, jjbpd = _jax_plane()
    path = tmpdir_path / "s.bp4"
    _write_with(JBpWriter, JEngineConfig, path)
    server = SeriesServer([path])
    if transport == "tcp":
        d, kw = JbpDaemon(server, port=0).start(), {}
    else:
        sock = tmpdir_path / "x.sock"
        d = _daemon(path, sock)
        kw = {"shm": transport == "unix-shm"}
    with d:
        ctr = _clients_read_boxes(jjbpd.SeriesClient, d.address, path,
                                  (BpReader, JBpReader), **kw)
    assert (ctr["SERVICE_SHM_BYTES"] > 0) == (transport == "unix-shm")


def test_two_daemons_in_one_process_never_share_a_ring(tmpdir_path):
    """A port daemon and a JAX-package daemon side by side, 4 shm clients
    on each: every connection's ring has a name of its own."""
    _, _, _, jjbpd = _jax_plane()
    path = tmpdir_path / "s.bp4"
    _write_with(BpWriter, EngineConfig, path)
    names = []
    with _daemon(path, tmpdir_path / "p.sock") as dp, \
            jjbpd.JbpDaemon(jjbpd.SeriesServer([path]),
                            socket_path=tmpdir_path / "j.sock").start() as dj:
        clients = [cls(d.address, path) for d in (dp, dj)
                   for cls in (SeriesClient, jjbpd.SeriesClient,
                               SeriesClient, jjbpd.SeriesClient)]
        try:
            for c in clients:
                c.read_var(0, "var/x")
                names += list(c._rings)
        finally:
            for c in clients:
                c.close()
    assert len(names) == 8 and len(set(names)) == 8
