"""jbpstat — analyze a series' metrics journal (metrics.jsonl).

The journal is written by the engines when the metrics plane is on
(`JBP_METRICS=1` or `METRICS.enable()`): one JSON frame per committed
step with the step's profiling numbers, Darshan counter deltas, the
coordinator's per-step histogram cells and every worker's shipped shard
(see `repro_torch.core.metrics.StepJournal`). `jbpstat` reads it back:

    PYTHONPATH=src python -m repro_torch.tools.jbpstat SERIES[/metrics.jsonl]
        [--json] [--stragglers] [--per-worker]
    PYTHONPATH=src python -m repro_torch.tools.jbpstat --diff A B

Default report: the per-step throughput table (step, wall stamp, write
seconds, raw/stored MiB, MiB/s), then the cumulative per-op latency
percentiles (p50/p95/p99/max — DETERMINISTIC functions of the log2
buckets, so they are identical to what the live `jbpd` `metrics` op
reports for the same run), then the straggler report over the whole run.

`--diff A B` compares two journals (two runs of the same workload): per-
op p50/p95/p99 percentage deltas and the throughput delta — the
regression-bisection view.

Exit codes follow the `_runner` convention: 0 ok, 1 regressions found
with --diff (any op slower by >2x), 2 usage / no journal.
"""
from __future__ import annotations

import json
import sys

from repro_torch.core.metrics import (load_journal, merge_cells,
                                      straggler_report, sum_journal_hists,
                                      summarize_cell)
from repro_torch.tools import _runner as R

MiB = 1024.0 ** 2

#: --diff regression threshold: an op whose p99 grew past this ratio
#: flips the exit code to EXIT_ISSUES
DIFF_REGRESSION_RATIO = 2.0


def _fmt_ms(v) -> str:
    return "-" if v is None else f"{v * 1e3:.3f}"


def _pct(new, old) -> str:
    if old is None or new is None or old == 0:
        return "-"
    return f"{(new - old) / old * 100.0:+.1f}%"


def step_table(frames: list) -> list[dict]:
    """One row per committed step (the close-time residual frame, step -1,
    is excluded — it has no throughput)."""
    rows = []
    for fr in frames:
        if fr.get("step", -1) < 0:
            continue
        prof = fr.get("prof", {})
        w_s = prof.get("write_s", 0.0)
        raw = prof.get("bytes_raw", 0)
        rows.append({"step": fr["step"], "t": fr.get("t"),
                     "write_s": w_s, "bytes_raw": raw,
                     "bytes_stored": prof.get("bytes_stored", 0),
                     "mib_s": (raw / MiB / w_s) if w_s else 0.0})
    return rows


def summarize_journal(frames: list, *, per_worker: bool = False) -> dict:
    """The whole-run analysis document (what --json prints)."""
    cum = sum_journal_hists(frames)                # own + worker cells
    doc = {
        "frames": len(frames),
        "steps": step_table(frames),
        "ops": {ck: summarize_cell(c) for ck, c in sorted(cum.items())},
        "stragglers": straggler_report(cum),
        "counters": _sum_counters(frames),
    }
    if per_worker:
        per_w: dict[str, dict] = {}
        for fr in frames:
            for wid, cells in fr.get("workers", {}).items():
                merge_cells(per_w.setdefault(str(wid), {}), cells)
        doc["workers"] = {wid: {ck: summarize_cell(c)
                                for ck, c in sorted(cells.items())}
                          for wid, cells in sorted(per_w.items())}
    return doc


def _sum_counters(frames: list) -> dict:
    out: dict[str, float] = {}
    for fr in frames:
        for k, v in fr.get("counters", {}).items():
            out[k] = out.get(k, 0.0) + v
    return out


def print_report(doc: dict, *, stragglers_only: bool = False):
    if not stragglers_only:
        print("step        t(wall)     write_s    raw MiB  stored MiB"
              "     MiB/s")
        for row in doc["steps"]:
            print(f"{row['step']:>4}  {row['t']:>14.3f}  "
                  f"{row['write_s']:>9.4f}  {row['bytes_raw'] / MiB:>9.2f}"
                  f"  {row['bytes_stored'] / MiB:>10.2f}"
                  f"  {row['mib_s']:>8.1f}")
        print()
        print(f"{'op|key':<44} {'n':>7} {'p50 ms':>9} {'p95 ms':>9} "
              f"{'p99 ms':>9} {'max ms':>9}")
        for ck, s in doc["ops"].items():
            if not s["count"]:
                continue
            print(f"{ck:<44} {s['count']:>7} {_fmt_ms(s['p50_s']):>9} "
                  f"{_fmt_ms(s['p95_s']):>9} {_fmt_ms(s['p99_s']):>9} "
                  f"{_fmt_ms(s['max_s']):>9}")
        for wid, ops in doc.get("workers", {}).items():
            print(f"\nworker {wid}:")
            for ck, s in ops.items():
                if s["count"]:
                    print(f"  {ck:<42} {s['count']:>7} "
                          f"{_fmt_ms(s['p50_s']):>9} "
                          f"{_fmt_ms(s['p95_s']):>9} "
                          f"{_fmt_ms(s['p99_s']):>9} "
                          f"{_fmt_ms(s['max_s']):>9}")
        print()
    if doc["stragglers"]:
        print("stragglers (p99 vs peer-median p99):")
        for e in doc["stragglers"]:
            base = ("rolling baseline" if e.get("vs_baseline")
                    else "peer median")
            print(f"  {e['op']}/{e['key']}: p99 {_fmt_ms(e['p99_s'])}ms = "
                  f"{e['ratio']:.1f}x {base} (n={e['count']})")
    elif stragglers_only:
        print("no stragglers detected")


def diff_journals(a_frames: list, b_frames: list) -> tuple[dict, bool]:
    """Per-op percentile deltas B vs A; returns (doc, regressed)."""
    a = {ck: summarize_cell(c)
         for ck, c in sum_journal_hists(a_frames).items()}
    b = {ck: summarize_cell(c)
         for ck, c in sum_journal_hists(b_frames).items()}
    rows = []
    regressed = False
    for ck in sorted(set(a) | set(b)):
        sa, sb = a.get(ck), b.get(ck)
        row = {"op": ck,
               "a": sa, "b": sb,
               "p50_pct": _pct(sb and sb["p50_s"], sa and sa["p50_s"]),
               "p99_pct": _pct(sb and sb["p99_s"], sa and sa["p99_s"])}
        if (sa and sb and sa["p99_s"] and sb["p99_s"]
                and sb["p99_s"] / sa["p99_s"] >= DIFF_REGRESSION_RATIO):
            row["regression"] = True
            regressed = True
        rows.append(row)
    ta = step_table(a_frames)
    tb = step_table(b_frames)

    def thr(rows_):
        t = sum(r["write_s"] for r in rows_)
        raw = sum(r["bytes_raw"] for r in rows_)
        return (raw / MiB / t) if t else 0.0

    return {"ops": rows, "throughput_a_mib_s": thr(ta),
            "throughput_b_mib_s": thr(tb)}, regressed


def _load(path, prog: str):
    try:
        return load_journal(path)
    except FileNotFoundError:
        print(f"{prog}: {path}: no metrics journal (run with JBP_METRICS=1 "
              f"to record one)", file=sys.stderr)
        return None
    except ValueError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return None


def main(argv=None) -> int:
    ap = R.make_parser(
        "jbpstat", "analyze a series' metrics journal (metrics.jsonl): "
        "per-step throughput, per-op latency percentiles, straggler "
        "report, run-vs-run regression diff")
    ap.add_argument("journal", nargs="*",
                    help="series directory or metrics.jsonl path")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full analysis as JSON")
    ap.add_argument("--stragglers", action="store_true",
                    help="print only the straggler report")
    ap.add_argument("--per-worker", action="store_true", dest="per_worker",
                    help="also summarize each worker's shipped histograms")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                    help="compare two journals (exit 1 when any op's p99 "
                         f"regressed >= {DIFF_REGRESSION_RATIO}x)")
    args = ap.parse_args(argv)

    if args.diff is not None:
        a = _load(args.diff[0], "jbpstat")
        b = _load(args.diff[1], "jbpstat")
        if a is None or b is None:
            return R.EXIT_USAGE
        doc, regressed = diff_journals(a, b)
        if args.as_json:
            print(json.dumps(doc, indent=1))
        else:
            print(f"throughput: A {doc['throughput_a_mib_s']:.1f} MiB/s"
                  f" -> B {doc['throughput_b_mib_s']:.1f} MiB/s")
            print(f"{'op|key':<44} {'A p99 ms':>10} {'B p99 ms':>10} "
                  f"{'d p50':>8} {'d p99':>8}")
            for row in doc["ops"]:
                sa, sb = row["a"], row["b"]
                mark = "  << REGRESSION" if row.get("regression") else ""
                print(f"{row['op']:<44} "
                      f"{_fmt_ms(sa and sa['p99_s']):>10} "
                      f"{_fmt_ms(sb and sb['p99_s']):>10} "
                      f"{row['p50_pct']:>8} {row['p99_pct']:>8}{mark}")
        return R.EXIT_ISSUES if regressed else R.EXIT_OK

    if len(args.journal) != 1:
        print("jbpstat: exactly one journal (or --diff A B) required",
              file=sys.stderr)
        return R.EXIT_USAGE
    frames = _load(args.journal[0], "jbpstat")
    if frames is None:
        return R.EXIT_USAGE
    doc = summarize_journal(frames, per_worker=args.per_worker)
    if args.as_json:
        print(json.dumps(doc, indent=1))
    else:
        print_report(doc, stragglers_only=args.stragglers)
    if args.io_report:
        R.io_report("jbpstat")
    return R.EXIT_OK


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
