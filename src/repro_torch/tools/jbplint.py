"""jbplint — the project-invariant static analyzer (correctness plane).

Walks Python sources with `ast` and enforces the I/O-plane invariants the
repo has been burned by at review time (see `repro_torch.analysis.checkers`):

    JBP001  bare `assert` as runtime validation (stripped under python -O)
    JBP002  raw open()/os.open/Path read-write helpers on the data planes
            (invisible to Darshan counters and DXT traces)
    JBP003  Darshan counter names as free literals (a typo silently mints
            a new counter; use the frozen `CTR` registry)
    JBP004  blocking calls inside a `with <lock>:` body
    JBP005  lambdas / nested functions handed to spawn-started workers

Exit codes follow the subsystem convention (fsck-flavoured, shared with
jbpfsck/jbpdxt): 0 clean, 1 findings, 2 usage error.

    python -m repro_torch.tools.jbplint src/repro_torch
    python -m repro_torch.tools.jbplint --rules JBP004 src/repro_torch/serve
    python -m repro_torch.tools.jbplint --json src/repro_torch > findings.json
    python -m repro_torch.tools.jbplint --baseline jbplint-baseline.json \
        src/repro_torch
    python -m repro_torch.tools.jbplint --write-baseline \
        jbplint-baseline.json src

`--json` is what CI gates on (and uploads as an artifact); the baseline
flags park legacy findings so new code must come in clean.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis import (ALL_CHECKERS, analyze_paths, baseline_doc,
                                  load_baseline, render_json, render_text)
from repro_torch.tools import _runner as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="jbplint",
        description="static analyzer for the repo's I/O-plane invariants "
                    "(exit 0 clean / 1 findings / 2 usage)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to scan (e.g. src/repro_torch)")
    ap.add_argument("--rules", metavar="JBPxxx[,JBPxxx]",
                    help="run only these rules")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--baseline", metavar="FILE",
                    help="ignore findings recorded in this baseline file")
    ap.add_argument("--write-baseline", metavar="FILE", dest="write_baseline",
                    help="record the current findings as the new baseline "
                         "and exit 0")
    ap.add_argument("--list-rules", action="store_true", dest="list_rules",
                    help="describe every rule and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for c in ALL_CHECKERS:
            print(f"{c.rule} [{c.name}]")
            print(f"    {c.description}")
        return R.EXIT_OK
    if not args.paths:
        print("jbplint: no paths given (try: jbplint src/repro_torch)",
              file=sys.stderr)
        return R.EXIT_USAGE

    rules = None
    if args.rules:
        known = {c.rule for c in ALL_CHECKERS}
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        bad = sorted(rules - known)
        if bad:
            print(f"jbplint: unknown rules {bad} (known: {sorted(known)})",
                  file=sys.stderr)
            return R.EXIT_USAGE
    for p in args.paths:
        if not pathlib.Path(p).exists():
            print(f"jbplint: {p}: no such file or directory",
                  file=sys.stderr)
            return R.EXIT_USAGE

    baseline_keys = frozenset()
    if args.baseline:
        try:
            baseline_keys = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print(f"jbplint: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return R.EXIT_USAGE

    res = analyze_paths(args.paths, rules=rules, baseline_keys=baseline_keys)

    if args.write_baseline:
        doc = baseline_doc(res.findings)
        # the baseline is a lint artifact, not series data
        pathlib.Path(args.write_baseline).write_text(   # jbplint: disable=JBP002
            json.dumps(doc, indent=1) + "\n")
        print(f"jbplint: wrote baseline with {len(res.findings)} "
              f"finding(s) -> {args.write_baseline}", file=sys.stderr)
        return R.EXIT_OK

    if args.as_json:
        print(json.dumps(render_json(res), indent=1))
    else:
        print(render_text(res))
    return R.EXIT_ISSUES if res.findings else R.EXIT_OK


if __name__ == "__main__":
    raise SystemExit(R.run_tool(main))
