"""Shared runner for the `repro_torch.tools` CLIs (jbpls / jbprepack /
jbpfsck).

One place for the things every series tool needs: the series-path sanity
check (exit code 2, fsck-style, when the argument is not a JBP series), the
common flags (`--io-report`, `--parallel`), the Darshan self-report, and
the `python -m repro_torch.tools.<x>` entry-point guard.

Exit code convention (shared across the subsystem, fsck(8)-flavoured):

    0  clean / success
    1  issues found (fsck) or operation failed on a valid series
    2  usage error / not a JBP series

`--io-report` prints the tool's OWN merged Darshan counters to stderr at
exit — for jbpls that is the proof of the O(metadata) claim (zero data.*
reads); for jbprepack/jbpfsck it attributes the run's I/O to read/write/
meta time exactly like `parser_dump` does for the write plane. Counters
from ReaderPool worker threads land in the same process-wide MONITOR, so
the report always covers the whole read plane.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Optional

from repro_torch.core.bp_engine import BpReader
from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.core.metrics import METRICS, straggler_report, summarize_cell

EXIT_OK = 0
EXIT_ISSUES = 1
EXIT_USAGE = 2


def make_parser(prog: str, description: str, *,
                parallel_flag: bool = False) -> argparse.ArgumentParser:
    """ArgumentParser preloaded with the flags every tool shares."""
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("--io-report", action="store_true", dest="io_report",
                    help="print this run's own Darshan counters (reads/"
                         "writes/meta) to stderr on exit")
    if parallel_flag:
        ap.add_argument("--parallel", type=int, default=0, metavar="N",
                        help="fan chunk reads out over N ReaderPool workers "
                             "(0 = serial)")
    return ap


def check_series(path) -> Optional[str]:
    """None when `path` looks like a JBP series, else the complaint."""
    p = pathlib.Path(str(path))
    if not p.is_dir():
        return f"{p}: not a directory"
    if not (p / "md.idx").exists():
        return f"{p}: not a JBP series (no md.idx)"
    return None


def open_reader(path, *, parallel: int = 0, prog: str = "tool"):
    """BpReader on a validated series path, or None (after printing the
    complaint to stderr) — callers translate None to EXIT_USAGE."""
    err = check_series(path)
    if err is not None:
        print(f"{prog}: {err}", file=sys.stderr)
        return None
    return BpReader(path, parallel=parallel)


def io_report(prog: str):
    """The tool's own merged I/O counters, darshan-parser style, stderr."""
    rep = MONITOR.report()
    tot = rep["total"]
    print(f"# {prog} --io-report (merged, whole read/write plane)",
          file=sys.stderr)
    for k in (CTR.POSIX_OPENS, CTR.POSIX_READS, CTR.POSIX_BYTES_READ,
              CTR.POSIX_WRITES, CTR.POSIX_BYTES_WRITTEN, CTR.POSIX_SEEKS,
              CTR.POSIX_FLUSHES, CTR.POSIX_FSYNCS, CTR.POSIX_CLOSES):
        print(f"{prog}: {k} = {tot.get(k, 0.0):.0f}", file=sys.stderr)
    for k in (CTR.F_READ_TIME, CTR.F_WRITE_TIME, CTR.F_META_TIME):
        print(f"{prog}: {k} = {tot.get(k, 0.0):.6f}s", file=sys.stderr)
    # plane-specific counters (transport, served reads) print only when the
    # run exercised them — jbpls/jbpfsck output stays byte-stable
    for k in (CTR.TRANSPORT_SHM_BYTES, CTR.TRANSPORT_PICKLE_FALLBACK_BYTES,
              CTR.SERVICE_CACHE_HIT, CTR.SERVICE_CACHE_MISS,
              CTR.SERVICE_COALESCED, CTR.SERVICE_SHM_BYTES,
              CTR.SERVICE_SOCKET_BYTES):
        if tot.get(k, 0.0):
            print(f"{prog}: {k} = {tot[k]:.0f}", file=sys.stderr)
    # metrics plane (repro_torch.core.metrics): per-op latency percentiles and
    # the straggler report — printed only when histograms were recorded,
    # so tool output with JBP_METRICS unset stays byte-stable
    cells = METRICS.merged() if METRICS.enabled else {}
    if cells:
        for ck in sorted(cells):
            s = summarize_cell(cells[ck])
            if not s["count"]:
                continue
            print(f"{prog}: metric {ck} n={s['count']} "
                  f"p50={s['p50_s'] * 1e3:.3f}ms "
                  f"p99={s['p99_s'] * 1e3:.3f}ms "
                  f"max={s['max_s'] * 1e3:.3f}ms", file=sys.stderr)
        for e in straggler_report(cells):
            print(f"{prog}: STRAGGLER {e['op']}/{e['key']} "
                  f"p99={e['p99_s'] * 1e3:.3f}ms = "
                  f"{e['ratio']:.1f}x peer median", file=sys.stderr)


def run_tool(main_fn, argv=None) -> int:
    """Uniform entry point: returns main_fn's exit code, mapping argparse
    SystemExit(2) through unchanged (usage errors share EXIT_USAGE)."""
    try:
        return int(main_fn(argv))
    except SystemExit as e:                      # argparse error paths
        return int(e.code or 0)
