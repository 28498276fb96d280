"""The jbplint core: findings, suppressions, baselines, the file driver.

Design notes:

  * A `Finding` is identified for BASELINE purposes by content, not line
    number (`Finding.key` hashes the stripped source line), so unrelated
    edits above a legacy finding don't churn the baseline.
  * Suppressions are per-line: a `# jbplint: disable=JBPxxx[,JBPyyy]`
    comment on the flagged line, or on a comment-only line directly above
    it. There is deliberately no file-level kill switch — a whole file
    that needs one should be carved out of the checker's scope instead.
  * Checkers scope themselves by directory COMPONENT of the absolute path
    (`path_includes` / `path_excludes`), so `core/` rules apply equally to
    the real tree and to test fixtures written under a `core/` tmp dir.
  * A file that does not parse is itself a finding (rule JBP000) — a
    syntax error must gate CI exactly like any other issue.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import pathlib
import re
from typing import Iterable, Optional, Sequence

_SUPPRESS_RE = re.compile(r"#\s*jbplint:\s*disable=([A-Z0-9,\s]+)")

PARSE_RULE = "JBP000"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # path as reported (cwd-relative when possible)
    line: int
    col: int
    message: str
    symbol: str = ""   # enclosing `Class.method` qualname, "" at module level
    snippet: str = ""  # stripped source line — the baseline-key input

    @property
    def key(self) -> str:
        """Stable identity for baselines: survives line drift from
        unrelated edits (keyed on the line's content, not its number)."""
        h = hashlib.sha1(self.snippet.encode()).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{self.symbol}:{h}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message, "key": self.key}

    def render(self) -> str:
        where = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{where} " \
               f"{self.message}"


def _parse_suppressions(lines: Sequence[str]) -> dict:
    """line number -> frozenset of suppressed rule ids. A directive on a
    comment-only line also covers the line below it."""
    out: dict[int, frozenset] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = frozenset(r.strip() for r in m.group(1).split(",")
                          if r.strip())
        out[i] = out.get(i, frozenset()) | rules
        if text.lstrip().startswith("#"):
            out[i + 1] = out.get(i + 1, frozenset()) | rules
    return out


class FileContext:
    """One parsed source file, shared by every checker that runs on it."""

    def __init__(self, path: pathlib.Path, relpath: str, source: str):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.suppressions = _parse_suppressions(self.lines)

    def line(self, n: int) -> str:
        return self.lines[n - 1].strip() if 1 <= n <= len(self.lines) else ""

    def suppressed(self, f: Finding) -> bool:
        return f.rule in self.suppressions.get(f.line, frozenset())


class Checker(ast.NodeVisitor):
    """One rule. Subclasses set `rule`/`name`/`description`, scope
    themselves with `path_includes`/`path_excludes` (directory components
    of the absolute path), and call `report(node, msg)` from visit_*."""

    rule = PARSE_RULE
    name = "base"
    description = ""
    path_includes: tuple = ()
    path_excludes: tuple = ()

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.findings: list[Finding] = []
        self._scope: list[str] = []

    @classmethod
    def applies_to(cls, abs_path: pathlib.Path) -> bool:
        parts = set(abs_path.parts)
        if any(seg in parts for seg in cls.path_excludes):
            return False
        return (not cls.path_includes
                or any(seg in parts for seg in cls.path_includes))

    # qualname bookkeeping — checkers overriding these must call _push
    def visit_ClassDef(self, node):
        self._push(node)

    def visit_FunctionDef(self, node):
        self._push(node)

    def visit_AsyncFunctionDef(self, node):
        self._push(node)

    def _push(self, node):
        self._scope.append(node.name)
        self.generic_visit(node)
        self._scope.pop()

    def report(self, node: ast.AST, message: str):
        line = getattr(node, "lineno", 1)
        self.findings.append(Finding(
            rule=self.rule, path=self.ctx.relpath, line=line,
            col=getattr(node, "col_offset", 0) + 1, message=message,
            symbol=".".join(self._scope), snippet=self.ctx.line(line)))


@dataclasses.dataclass
class AnalysisResult:
    findings: list          # gating: new, unsuppressed, unbaselined
    suppressed: int
    baselined: int
    files: int

    @property
    def clean(self) -> bool:
        return not self.findings


def _expand(paths: Iterable) -> list[pathlib.Path]:
    out: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(str(p))
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        else:
            out.append(p)
    return out


def _rel(p: pathlib.Path, cwd: pathlib.Path) -> str:
    try:
        return p.resolve().relative_to(cwd).as_posix()
    except ValueError:
        return p.resolve().as_posix()


def analyze_paths(paths: Iterable, *, rules: Optional[set] = None,
                  baseline_keys: frozenset = frozenset(),
                  checkers: Optional[Sequence] = None) -> AnalysisResult:
    """Run the (selected) checkers over every .py under `paths`."""
    if checkers is None:
        from repro_torch.analysis.checkers import ALL_CHECKERS
        checkers = ALL_CHECKERS
    selected = [c for c in checkers if rules is None or c.rule in rules]
    cwd = pathlib.Path.cwd()
    findings: list[Finding] = []
    suppressed = baselined = nfiles = 0
    for fp in _expand(paths):
        nfiles += 1
        rel = _rel(fp, cwd)
        try:
            ctx = FileContext(fp, rel, fp.read_text())
        except SyntaxError as e:
            findings.append(Finding(
                rule=PARSE_RULE, path=rel, line=e.lineno or 1,
                col=e.offset or 1, message=f"syntax error: {e.msg}"))
            continue
        seen = set()                      # nested-with double reports
        for cls in selected:
            if not cls.applies_to(fp.resolve()):
                continue
            ck = cls(ctx)
            ck.visit(ctx.tree)
            for f in ck.findings:
                ident = (f.rule, f.line, f.col, f.message)
                if ident in seen:
                    continue
                seen.add(ident)
                if ctx.suppressed(f):
                    suppressed += 1
                elif f.key in baseline_keys:
                    baselined += 1
                else:
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return AnalysisResult(findings=findings, suppressed=suppressed,
                          baselined=baselined, files=nfiles)


# ------------------------------------------------------------------- baseline
def load_baseline(path) -> frozenset:
    doc = json.loads(pathlib.Path(str(path)).read_text())
    return frozenset(e["key"] for e in doc.get("findings", []))


def baseline_doc(findings: Sequence[Finding]) -> dict:
    return {"version": 1, "tool": "jbplint",
            "findings": [f.to_json() for f in findings]}


# ------------------------------------------------------------------ reporters
def render_text(res: AnalysisResult) -> str:
    lines = [f.render() for f in res.findings]
    lines.append(f"jbplint: {len(res.findings)} finding(s) in {res.files} "
                 f"file(s) ({res.suppressed} suppressed, "
                 f"{res.baselined} baselined)")
    return "\n".join(lines)


def render_json(res: AnalysisResult) -> dict:
    return {"tool": "jbplint", "clean": res.clean,
            "findings": [f.to_json() for f in res.findings],
            "suppressed": res.suppressed, "baselined": res.baselined,
            "files": res.files}
