"""jbpdxt CLI — analyze a DXT per-operation trace (`dxt.json` sidecar).

The counters-only view (`parser_dump`, `jbpls --io-report`) says how MUCH
I/O happened; the DXT trace says WHEN — which rank wrote which bytes to
which subfile, and what the step lifecycle (snapshot/compress/transport/
seal/commit) was doing around it. This tool is the darshan-parser
equivalent for our traces:

    PYTHONPATH=src python -m repro_torch.tools.jbpdxt SERIES_OR_TRACE
        [--bins N] [--chrome out.json] [--dxt out.txt] [--json]

  * timeline summary — event/span counts, busy time and byte totals per
    op, trace wall span, drop counter,
  * per-subfile straggler table — for every file touched by write/read
    ops: op count, byte total (exactly the file's Darshan
    POSIX_BYTES_WRITTEN/READ), busy time, effective bandwidth, and when
    the file FINISHED relative to the earliest finisher — the straggler
    column the paper reads off its DXT plots (an `ost<k>/` path component
    is surfaced as the OST column),
  * bandwidth-over-time — bytes moved per time bin (`--bins`, default
    20) with an ASCII sparkbar, the "did the commit stall the stream?"
    view,
  * exports — `--chrome out.json` (Perfetto / chrome://tracing loadable)
    and `--dxt out.txt` (darshan-parser DXT-style text).

Accepts a series directory (reads its `dxt.json`) or a trace file path.
Shares `repro_torch.tools._runner` conventions: exit 0 ok, 2 usage/not-a-trace.
"""
from __future__ import annotations

import json
import pathlib
import re
import sys
from collections import defaultdict

from repro_torch.core.darshan import open_file
from repro_torch.core.dxt import SPAN_OPS, load_trace, to_chrome, to_dxt_text
from repro_torch.tools import _runner as R

_OST_RE = re.compile(r"(?:^|/)ost(\d+)/")
_BAR = " .:-=+*#%@"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024
    return f"{n:.1f}GiB"


def summarize(events, dropped: int = 0) -> dict:
    """The machine-readable analysis (--json prints this verbatim):
    {"span_s", "ops": {op: {count, busy_s, bytes}}, "files": {path:
    {ops, bytes_written, bytes_read, busy_s, t_end, ost}}, "dropped"}."""
    ops: dict = defaultdict(lambda: {"count": 0, "busy_s": 0.0, "bytes": 0})
    files: dict = {}
    t_lo, t_hi = float("inf"), float("-inf")
    for src, rank, path, op, off, ln, t0, t1 in events:
        t_lo, t_hi = min(t_lo, t0), max(t_hi, t1)
        o = ops[op]
        o["count"] += 1
        o["busy_s"] += t1 - t0
        o["bytes"] += int(ln)
        if op in SPAN_OPS or op == "shm_write" or not path:
            continue
        f = files.setdefault(path, {"ops": 0, "bytes_written": 0,
                                    "bytes_read": 0, "busy_s": 0.0,
                                    "t_end": t1, "ost": None})
        f["ops"] += 1
        f["busy_s"] += t1 - t0
        f["t_end"] = max(f["t_end"], t1)
        if op == "write":
            f["bytes_written"] += int(ln)
        elif op == "read":
            f["bytes_read"] += int(ln)
        m = _OST_RE.search(path)
        if m:
            f["ost"] = int(m.group(1))
    return {"events": len(events), "dropped": int(dropped),
            "span_s": (t_hi - t_lo) if events else 0.0,
            "t0": t_lo if events else 0.0,
            "ops": {k: dict(v) for k, v in sorted(ops.items())},
            "files": files}


def bandwidth_bins(events, n_bins: int) -> list[tuple[float, int]]:
    """(bin_start_s_rel, bytes) per bin — write/read bytes attributed to
    the bin the op ENDED in (one op, one bin: totals stay exact)."""
    data = [(e[7], int(e[5])) for e in events if e[3] in ("write", "read")]
    if not data:
        return []
    t_lo = min(e[6] for e in events)
    t_hi = max(t for t, _ in data)
    width = max((t_hi - t_lo) / n_bins, 1e-9)
    bins = [0] * n_bins
    for t, nb in data:
        bins[min(int((t - t_lo) / width), n_bins - 1)] += nb
    return [(i * width, b) for i, b in enumerate(bins)]


def _print_report(summ: dict, bins: list, out=None):
    out = out if out is not None else sys.stdout
    p = lambda *a: print(*a, file=out)          # noqa: E731
    p(f"# jbpdxt: {summ['events']} events over {summ['span_s']:.3f}s "
      f"(dropped: {summ['dropped']})")
    p("#")
    p("# timeline summary")
    p(f"{'op':<12}{'count':>8}{'busy_s':>12}{'bytes':>12}")
    for op, o in summ["ops"].items():
        kind = "span" if op in SPAN_OPS else "posix"
        p(f"{op:<12}{o['count']:>8}{o['busy_s']:>12.6f}"
          f"{_fmt_bytes(o['bytes']):>12}  [{kind}]")
    files = summ["files"]
    if files:
        p("#")
        p("# per-subfile straggler table (straggler_s: finished this long "
          "after the first finisher)")
        first_end = min(f["t_end"] for f in files.values())
        p(f"{'file':<28}{'ost':>4}{'ops':>6}{'written':>12}{'read':>12}"
          f"{'busy_s':>10}{'MiB/s':>8}{'straggler_s':>12}")
        for path in sorted(files, key=lambda k: files[k]["t_end"]):
            f = files[path]
            nb = f["bytes_written"] + f["bytes_read"]
            bw = (nb / f["busy_s"] / 1024 ** 2) if f["busy_s"] > 0 else 0.0
            name = path if len(path) <= 27 else "…" + path[-26:]
            p(f"{name:<28}{f['ost'] if f['ost'] is not None else '-':>4}"
              f"{f['ops']:>6}{_fmt_bytes(f['bytes_written']):>12}"
              f"{_fmt_bytes(f['bytes_read']):>12}{f['busy_s']:>10.6f}"
              f"{bw:>8.1f}{f['t_end'] - first_end:>12.6f}")
    if bins:
        p("#")
        p("# bandwidth over time (write+read bytes per bin)")
        peak = max(b for _, b in bins) or 1
        for t, b in bins:
            bar = _BAR[min(int(b / peak * (len(_BAR) - 1)), len(_BAR) - 1)]
            p(f"  t+{t:9.4f}s {_fmt_bytes(b):>12} |{bar * 3}")


def main(argv=None) -> int:
    ap = R.make_parser(
        "jbpdxt", "analyze a DXT per-operation I/O trace: timeline "
        "summary, per-subfile straggler table, bandwidth-over-time, "
        "Chrome trace / DXT text export")
    ap.add_argument("trace",
                    help="series directory (containing dxt.json) or a "
                         "trace file written by TRACER.dump()")
    ap.add_argument("--bins", type=int, default=20, metavar="N",
                    help="bandwidth-over-time bin count (default 20)")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="write a Chrome trace-event JSON (load in "
                         "Perfetto / chrome://tracing)")
    ap.add_argument("--dxt", default=None, metavar="OUT.txt",
                    help="write darshan-parser DXT-style text")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the machine-readable summary instead of "
                         "the tables")
    args = ap.parse_args(argv)

    try:
        doc = load_trace(args.trace)
    except FileNotFoundError:
        print(f"jbpdxt: {args.trace}: no trace found (run with JBP_DXT=1 "
              f"or TRACER.enable() to produce a dxt.json sidecar)",
              file=sys.stderr)
        return R.EXIT_USAGE
    except (ValueError, json.JSONDecodeError) as e:
        print(f"jbpdxt: {e}", file=sys.stderr)
        return R.EXIT_USAGE
    events, dropped = doc["events"], doc.get("dropped", 0)

    if args.chrome:
        with open_file(args.chrome, "w") as f:
            json.dump(to_chrome(events, dropped), f)
        print(f"jbpdxt: wrote Chrome trace -> {args.chrome} "
              f"(open in https://ui.perfetto.dev)", file=sys.stderr)
    if args.dxt:
        with open_file(args.dxt, "w") as f:
            f.write(to_dxt_text(events, dropped))
        print(f"jbpdxt: wrote DXT text -> {args.dxt}", file=sys.stderr)

    summ = summarize(events, dropped)
    if args.as_json:
        print(json.dumps(summ, indent=1))
    else:
        _print_report(summ, bandwidth_bins(events, max(1, args.bins)))
    if args.io_report:
        R.io_report("jbpdxt")
    return R.EXIT_OK


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
