"""jbpd CLI — run (or administer) the JBP series data service.

Serve one or more series over a unix socket (local clients get zero-copy
shm responses) or a TCP port (remote clients, socket framing):

    PYTHONPATH=src python -m repro_torch.tools.jbpd SERIES [SERIES...]
        --socket /tmp/jbpd.sock [--cache-mb 256] [--parallel N]
        [--ring-mb 64] [--no-shm] [--open-any] [--io-report]
    PYTHONPATH=src python -m repro_torch.tools.jbpd SERIES --port 7454

The daemon pre-opens every listed series at startup (a bad path fails
fast, exit 2) and serves ONLY those unless `--open-any` lets clients name
arbitrary valid series. It runs until SIGINT/SIGTERM (or a client's
`shutdown` admin op), then prints its `--io-report` — the merged Darshan
counters including the service plane's SERVICE_CACHE_HIT/MISS,
SERVICE_COALESCED and SERVICE_SHM/SOCKET_BYTES.

With `--metrics-port PORT` the daemon also serves the Prometheus text
exposition of the metrics plane (`repro_torch.core.metrics`) over plain
HTTP — `curl :PORT/metrics` — and enables histogram recording for its own
process (cache_fetch/serve/read latencies) if it was not already on.

Admin mode (against a RUNNING daemon; `SERIES` args are not needed):

    python -m repro_torch.tools.jbpd --socket /tmp/jbpd.sock --stats
    python -m repro_torch.tools.jbpd --socket /tmp/jbpd.sock --metrics
    python -m repro_torch.tools.jbpd --socket /tmp/jbpd.sock --watch 5 \
        --interval 2
    python -m repro_torch.tools.jbpd --socket /tmp/jbpd.sock --shutdown

`--metrics` prints the `metrics` admin op's JSON (histogram cells,
percentile summaries, straggler report) — the same numbers the HTTP
exposition serves, over the framed socket protocol.

`--watch N` streams N live counter-DELTA frames from the daemon (the
`watch` op): each frame prints the non-zero deltas since the previous
frame plus cache occupancy — `watch`'s begin + the streamed deltas always
reconcile against a `--stats` taken at the same moment.

Shares the `repro_torch.tools._runner` conventions (exit codes, --io-report)
with jbpls, jbprepack and jbpfsck.
"""
from __future__ import annotations

import json
import signal
import sys

from repro_torch.core.metrics import METRICS
from repro_torch.core.shm_transport import DEFAULT_RING_BYTES
from repro_torch.serve.jbpd import (DEFAULT_CACHE_BYTES,
                                    DaemonDisconnectedError, JbpDaemon,
                                    MetricsHttpShim, SeriesClient, SeriesServer)
from repro_torch.tools import _runner as R

MiB = 1024 ** 2


def main(argv=None) -> int:
    ap = R.make_parser(
        "jbpd", "long-lived series data service: jbpls-style metadata "
        "queries + read_var box reads over a socket, with an LRU "
        "decompressed-chunk cache, request coalescing and zero-copy shm "
        "responses", parallel_flag=True)
    ap.add_argument("series", nargs="*",
                    help="series to serve (pre-opened at startup)")
    ap.add_argument("--socket", default=None, metavar="PATH",
                    help="unix socket to listen on (local clients; enables "
                         "shm handoff)")
    ap.add_argument("--port", type=int, default=None,
                    help="TCP port to listen on instead of a unix socket")
    ap.add_argument("--host", default="127.0.0.1",
                    help="TCP bind address (with --port)")
    ap.add_argument("--cache-mb", type=int,
                    default=DEFAULT_CACHE_BYTES // MiB, metavar="MB",
                    help="decompressed-chunk cache budget (MiB)")
    ap.add_argument("--ring-mb", type=int,
                    default=DEFAULT_RING_BYTES // MiB, metavar="MB",
                    help="per-connection shm response ring size (MiB)")
    ap.add_argument("--no-shm", action="store_true",
                    help="disable shm handoff (socket framing only)")
    ap.add_argument("--open-any", action="store_true",
                    help="also serve valid series NOT listed at startup")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="also serve the Prometheus text exposition over "
                         "HTTP on this port (0 = ephemeral; enables "
                         "histogram recording)")
    ap.add_argument("--stats", action="store_true",
                    help="admin: query a running daemon's stats and exit")
    ap.add_argument("--metrics", action="store_true",
                    help="admin: print a running daemon's metrics op "
                         "(histograms, percentiles, stragglers) and exit")
    ap.add_argument("--watch", type=int, default=None, metavar="N",
                    help="admin: stream N live counter-delta frames from "
                         "a running daemon and exit")
    ap.add_argument("--interval", type=float, default=1.0, metavar="S",
                    help="seconds between --watch frames (default 1.0)")
    ap.add_argument("--shutdown", action="store_true",
                    help="admin: stop a running daemon and exit")
    args = ap.parse_args(argv)

    if (args.socket is None) == (args.port is None):
        print("jbpd: exactly one of --socket / --port is required",
              file=sys.stderr)
        return R.EXIT_USAGE
    address = args.socket if args.socket else (args.host, args.port)

    # ------------------------------------------------------------ admin mode
    if (args.stats or args.metrics or args.shutdown
            or args.watch is not None):
        try:
            with SeriesClient(address, shm=False) as c:
                if args.stats:
                    print(json.dumps(c.stats(), indent=1))
                if args.metrics:
                    print(json.dumps(c.metrics(), indent=1))
                if args.watch is not None:
                    def show(frame):
                        deltas = {k: v for k, v in frame["delta"].items()
                                  if v}
                        cache = frame["cache"]
                        strag = frame.get("stragglers") or []
                        tail = ""
                        if strag:
                            worst = strag[0]
                            tail = (f" STRAGGLER {worst['op']}/"
                                    f"{worst['key']} x{worst['ratio']:.1f}"
                                    + (f" (+{len(strag) - 1} more)"
                                       if len(strag) > 1 else ""))
                        print(f"jbpd watch #{frame['seq']}: "
                              f"{json.dumps(deltas) if deltas else 'idle'} "
                              f"cache={cache['entries']}e/"
                              f"{cache['bytes']}B{tail}", flush=True)
                    res = c.watch(interval_s=args.interval,
                                  count=max(1, args.watch), on_frame=show)
                    print(f"jbpd watch: {len(res['frames'])} frame(s); "
                          f"end counters: "
                          f"{json.dumps(res['end'])}", file=sys.stderr)
                if args.shutdown:
                    c.shutdown()
                    print("jbpd: daemon stopping", file=sys.stderr)
        except DaemonDisconnectedError as e:
            print(f"jbpd: {e}", file=sys.stderr)
            return R.EXIT_ISSUES
        return R.EXIT_OK

    # ------------------------------------------------------------ serve mode
    for s in args.series:
        err = R.check_series(s)
        if err is not None:
            print(f"jbpd: {err}", file=sys.stderr)
            return R.EXIT_USAGE
    try:
        server = SeriesServer(args.series, cache_bytes=args.cache_mb * MiB,
                              parallel=args.parallel,
                              open_any=args.open_any)
    except (OSError, ValueError) as e:
        print(f"jbpd: {e}", file=sys.stderr)
        return R.EXIT_USAGE
    daemon = JbpDaemon(server, socket_path=args.socket,
                       host=args.host, port=args.port,
                       shm=not args.no_shm, ring_bytes=args.ring_mb * MiB)
    shim = None
    if args.metrics_port is not None:
        METRICS.enable()                # a scrape surface implies recording
        shim = MetricsHttpShim(server, host=args.host,
                               port=args.metrics_port).start()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *a: daemon.stop())
    served = ", ".join(args.series) if args.series else "<any>"
    mtxt = (f", metrics http://{shim.host}:{shim.port}/metrics"
            if shim is not None else "")
    print(f"jbpd: listening on {daemon.address!r} serving {served} "
          f"(cache {args.cache_mb} MiB, parallel={args.parallel}, "
          f"shm={'off' if args.no_shm else 'on'}{mtxt})", file=sys.stderr,
          flush=True)
    try:
        daemon.serve_forever()
    finally:
        daemon.stop()
        if shim is not None:
            shim.stop()
    if args.io_report:
        R.io_report("jbpd")
    return R.EXIT_OK


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
