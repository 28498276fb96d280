"""jbplint — AST-based static analysis for the repo's I/O-plane invariants.

The paper's argument rests on I/O being observable and correct by
construction: Darshan counters that add up, instrumented file ops, and
crash-consistent multi-process commit protocols. Those invariants used to
live only in code review (`-O`-stripped asserts on decode paths and
un-instrumented flush/close were both fixed after the fact). Each checker
here turns one of them into a machine-checked rule that runs before the
code ever does — the same move Darshan makes for runtime I/O.

Layout:

    framework.py   Finding model, inline suppressions, baseline files,
                   the per-file AST driver and reporters
    checkers.py    the JBPxxx rules themselves
    repro_torch.tools.jbplint   the CLI (exit codes 0/1/2, like jbpfsck)

Suppress a single finding with a trailing comment on the offending line
(or on a comment-only line directly above it):

    self._f = open(self.path, mode)  # jbplint: disable=JBP002 (reason)

Legacy findings can be parked in a committed baseline (`--write-baseline`
/ `--baseline`); new code must come in clean.
"""
from repro_torch.analysis.checkers import ALL_CHECKERS
from repro_torch.analysis.framework import (AnalysisResult, Checker,
                                            FileContext, Finding,
                                            analyze_paths, baseline_doc,
                                            load_baseline, render_json,
                                            render_text)

__all__ = [
    "ALL_CHECKERS", "AnalysisResult", "Checker", "FileContext", "Finding",
    "analyze_paths", "baseline_doc", "load_baseline", "render_json",
    "render_text",
]
