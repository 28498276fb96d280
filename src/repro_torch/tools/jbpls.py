"""jbpls — bpls for the JBP engine: list a BP4-style series from metadata.

Mirrors ADIOS2's `bpls`: variables with dtype/shape/chunk counts, per-step
tables, attributes, per-aggregator subfile layout, compression ratios and
(with -l) min/max — all answered from `md.idx`/`md.0` ONLY. The paper's
"rapid metadata extraction" claim, as a tool: listing a 10k-step series
costs two metadata file reads and ZERO `data.*` subfile I/O (held by
`DarshanMonitor` counters in tests/test_insitu.py). The one exception is
`--dump VAR`, which by definition reads payload bytes.

    PYTHONPATH=src python -m repro_torch.tools.jbpls <series.bp4> [options]

Options:
    -l            long listing: per-variable bytes (raw -> stored), ratio,
                  min/max from chunk statistics
    -s            per-step table (timestamp, #vars, raw/stored bytes)
    -A            series/step attributes
    -L            per-aggregator subfile layout (from chunk tables)
    --step N      restrict to one step
    --var SUBSTR  filter variables by substring
    --dump VAR    read and print a variable's values (touches data.*)
    --json        machine-readable output of everything listed
    --parallel N  ReaderPool workers for --dump reads
    --io-report   print this run's own Darshan counters to stderr

Shares the `repro_torch.tools._runner` conventions (exit codes, --io-report)
with jbprepack and jbpfsck.
"""
from __future__ import annotations

import datetime
import json
import pathlib
import sys
from typing import Optional

import numpy as np

from repro_torch.core.bp_engine import BpReader
from repro_torch.core.darshan import open_file
from repro_torch.tools import _runner as R


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _step_span(steps: list) -> str:
    if not steps:
        return "none"
    lo, hi = steps[0], steps[-1]
    return f"{len(steps)} ({lo}..{hi})"


def _engine_info(path: pathlib.Path) -> dict:
    """Engine/codec from profiling.json when present (a metadata file,
    not a subfile — reading it keeps the O(metadata) guarantee)."""
    p = path / "profiling.json"
    if not p.exists():
        return {}
    try:
        with open_file(p, "r") as f:
            doc = json.loads(f.read())
    except (OSError, ValueError):
        return {}
    return {k: doc[k] for k in ("engine", "aggregators", "codec")
            if k in doc}


def survey(reader: BpReader, *, step: Optional[int] = None,
           var_filter: Optional[str] = None) -> dict:
    """Everything jbpls prints, as one metadata-only dict — a single
    `BpReader.scan()` pass over the chunk tables plus the series-level
    header info (engine knobs, attributes)."""
    steps = reader.valid_steps() if step is None else [step]
    # the filter goes INTO the scan so per-step totals, layout and minmax
    # all consistently cover exactly the listed variables
    flt = (lambda n: var_filter in n) if var_filter else None
    sc = reader.scan(steps=steps, name_filter=flt)
    return {"path": str(reader.path), "engine": _engine_info(reader.path),
            "steps": steps, "variables": sc["variables"],
            "per_step": sc["per_step"], "minmax": sc["minmax"],
            "layout": sc["layout"],
            "attrs": reader.attributes(steps[-1]) if steps else {}}


def format_listing(sv: dict, *, long_listing: bool = False,
                   show_steps: bool = False, show_attrs: bool = False,
                   show_layout: bool = False) -> str:
    lines = []
    eng = sv["engine"]
    eng_s = (f"  engine {eng.get('engine', '?')} aggregators="
             f"{eng.get('aggregators', '?')} codec={eng.get('codec', '?')}"
             if eng else "")
    lines.append(f"jbpls: {sv['path']}")
    lines.append(f"  steps: {_step_span(sv['steps'])}{eng_s}")
    raw = sum(v["raw"] for v in sv["variables"].values())
    stored = sum(v["stored"] for v in sv["variables"].values())
    ratio = raw / stored if stored else 1.0
    lines.append(f"  payload: {_fmt_bytes(raw)} raw -> "
                 f"{_fmt_bytes(stored)} stored ({ratio:.2f}x)")
    for name in sorted(sv["variables"]):
        v = sv["variables"][name]
        shape = "{" + ", ".join(str(x) for x in v["shape"]) + "}"
        if v.get("shape_varies"):
            shape += "*"                 # latest step's shape; varies
        row = (f"  {v['dtype']:>8}  {name:<40} {shape:<16} "
               f"{len(v['steps'])} steps  {v['chunks_per_step']} chunks/step")
        if long_listing:
            r = v["raw"] / v["stored"] if v["stored"] else 1.0
            row += (f"  {_fmt_bytes(v['raw'])} -> "
                    f"{_fmt_bytes(v['stored'])} ({r:.2f}x)")
            mm = sv["minmax"].get(name)
            row += (f"  min/max = {mm[0]:.6g} / {mm[1]:.6g}" if mm
                    else "  min/max = n/a")
        lines.append(row)
    if show_steps:
        lines.append("  --- steps ---")
        for ps in sv["per_step"]:
            t = datetime.datetime.fromtimestamp(ps["t_ns"] / 1e9)
            lines.append(f"  step {ps['step']:>6}  {t.isoformat()}  "
                         f"{ps['n_vars']} vars  "
                         f"{_fmt_bytes(ps['raw'])} -> "
                         f"{_fmt_bytes(ps['stored'])}")
    if show_attrs:
        lines.append("  --- attributes ---")
        for k in sorted(sv["attrs"]):
            lines.append(f"  {k} = {sv['attrs'][k]!r}")
    if show_layout:
        lines.append("  --- aggregator layout (from chunk tables) ---")
        for agg in sorted(sv["layout"]):
            d = sv["layout"][agg]
            lines.append(f"  data.{agg}: {d['chunks']} chunks  "
                         f"{_fmt_bytes(d['bytes'])}  "
                         f"end @ {_fmt_bytes(d['end'])}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = R.make_parser(
        "jbpls", "bpls-style metadata listing of a JBP "
        "(BP4) series — O(metadata) I/O, no subfile reads",
        parallel_flag=True)
    ap.add_argument("series", help="path to the <name>.bp4 directory")
    ap.add_argument("-l", action="store_true", dest="long_listing",
                    help="long listing (bytes, ratio, min/max)")
    ap.add_argument("-s", action="store_true", dest="show_steps",
                    help="per-step table")
    ap.add_argument("-A", action="store_true", dest="show_attrs",
                    help="attributes")
    ap.add_argument("-L", action="store_true", dest="show_layout",
                    help="per-aggregator subfile layout")
    ap.add_argument("--step", type=int, default=None,
                    help="restrict to one step")
    ap.add_argument("--var", default=None, help="substring variable filter")
    ap.add_argument("--dump", default=None, metavar="VAR",
                    help="read and print VAR's values (touches data.*)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    path = pathlib.Path(args.series)
    reader = R.open_reader(path, parallel=args.parallel, prog="jbpls")
    if reader is None:
        return R.EXIT_USAGE
    with reader:
        if not reader.valid_steps():
            print(f"jbpls: {path}: no valid steps", file=sys.stderr)
            return R.EXIT_ISSUES
        if args.step is not None and args.step not in reader.idx_records:
            print(f"jbpls: {path}: no valid step {args.step} "
                  f"(have {_step_span(reader.valid_steps())})",
                  file=sys.stderr)
            return R.EXIT_ISSUES
        sv = survey(reader, step=args.step, var_filter=args.var)
        if args.as_json:
            print(json.dumps(sv, indent=1, default=_json_default))
        else:
            print(format_listing(sv, long_listing=args.long_listing,
                                 show_steps=args.show_steps,
                                 show_attrs=args.show_attrs,
                                 show_layout=args.show_layout))
        if args.dump:
            step = args.step if args.step is not None else sv["steps"][-1]
            try:
                arr = reader.read_var(step, args.dump)
            except KeyError:
                print(f"jbpls: no variable {args.dump!r} at step {step} "
                      f"(have {reader.var_names(step)})", file=sys.stderr)
                return R.EXIT_ISSUES
            print(f"  {args.dump} @ step {step}:")
            print(np.array2string(arr, threshold=64, precision=6))
    if args.io_report:
        R.io_report("jbpls")
    return R.EXIT_OK


def _json_default(o):
    if isinstance(o, (np.integer, np.floating)):
        return o.item()
    if isinstance(o, (tuple, set)):
        return list(o)
    raise TypeError(f"not JSON-serializable: {type(o)}")


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
