"""The JBPxxx rules — each one an invariant this repo was burned by.

JBP001  bare `assert` as runtime validation (once fixed after the fact on
        the decode path: `python -O` strips them, so the check vanishes in
        optimized production runs)
JBP002  raw file I/O on the data planes instead of `InstrumentedFile`
        (un-instrumented flush/close were fixed after the fact: every
        bypassed op is a Darshan/DXT blind spot that silently skews the
        paper's counter claims)
JBP003  Darshan counter names as free string literals: a typo silently
        mints a brand-new counter instead of failing; call sites must use
        the frozen `repro_torch.core.darshan.CTR` registry
JBP004  blocking calls while holding a `with <lock>:` — one slow socket /
        queue / sleep serializes every contender (the jbpd serve plane is
        lock-heavy; its cache had to move fetches outside the lock)
JBP005  lambdas / nested functions handed to spawn-started workers — the
        spawn start method pickles the target by reference, so these fail
        at `Process.start()`, far from where they were written
JBP006  `time.time()` used to measure a DURATION on the data planes (a
        subtraction operand or a deadline comparison) — the wall clock
        steps under NTP/suspend, so durations must come from
        `time.perf_counter()`/`time.monotonic()`; wall clock is only for
        epoch stamps (jbpd's uptime was fixed after the fact)

All rules are lexical/AST-level by design: no type inference, no data
flow. Heuristic receiver-name matching (lock-ish, queue-ish) is tuned to
this codebase's naming discipline and documented in the README.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.framework import Checker

# with-context names that mean mutual exclusion ... and the ones that mean
# coordination (Condition.wait releases the lock while waiting — flagging
# it would outlaw the reader-pool's notification protocol)
_LOCKISH = re.compile(r"lock", re.I)
_CONDISH = re.compile(r"cond|event|barrier", re.I)
# receivers that look like queues: `q`, `_q`, `task_q`, `result_q`, `jobs
# queue`, ... but not `self._lru` / `self._seq`
_QUEUEISH = re.compile(r"(^|[._])q\d*($|[._])|queue", re.I)


class BareAssertChecker(Checker):
    rule = "JBP001"
    name = "bare-assert"
    description = ("bare `assert` used for runtime validation — stripped "
                   "under `python -O`; raise ValueError/RuntimeError (or "
                   "CorruptPayloadError on decode paths) instead. "
                   "Test and kernel-reference code is exempt.")
    path_excludes = ("tests", "kernels", "benchmarks")

    def visit_Assert(self, node):
        self.report(node, "bare assert is stripped under python -O; raise "
                          "a real exception (ValueError / RuntimeError / "
                          "CorruptPayloadError) with a message instead")
        self.generic_visit(node)


class RawOpenChecker(Checker):
    rule = "JBP002"
    name = "raw-open"
    description = ("raw `open()` / `os.open` / pathlib read-write helpers "
                   "on the series data planes (core/, serve/, tools/) — "
                   "I/O that bypasses InstrumentedFile is invisible to "
                   "Darshan counters and DXT traces; use "
                   "repro_torch.core.darshan.open_file")
    path_includes = ("core", "serve", "tools")
    path_excludes = ("tests", "benchmarks")

    _PATH_IO = ("read_text", "write_text", "read_bytes", "write_bytes")
    _MODULES = ("os", "io")

    def visit_Call(self, node):
        f = node.func
        msg = None
        if isinstance(f, ast.Name) and f.id == "open":
            msg = "raw open() bypasses InstrumentedFile"
        elif isinstance(f, ast.Attribute):
            if (f.attr == "open" and isinstance(f.value, ast.Name)
                    and f.value.id in self._MODULES):
                msg = f"raw {f.value.id}.open() bypasses InstrumentedFile"
            elif f.attr in self._PATH_IO:
                msg = f"Path.{f.attr}() bypasses InstrumentedFile"
        if msg:
            self.report(node, f"{msg} — this I/O is invisible to Darshan "
                              f"counters and DXT traces; use "
                              f"repro_torch.core.darshan.open_file")
        self.generic_visit(node)


class CounterLiteralChecker(Checker):
    rule = "JBP003"
    name = "counter-literal"
    description = ("Darshan counter name passed to `record()` as a free "
                   "string literal — a typo silently mints a new counter; "
                   "use the frozen registry constants "
                   "(repro_torch.core.darshan.CTR.<NAME>)")
    path_excludes = ("tests", "benchmarks")

    _COUNTERISH = re.compile(r"^(POSIX|F|TRANSPORT|SERVICE)_[A-Z0-9_]+$")

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "record":
            suspects = []
            # record(rank, path, counter, inc, tkey, ...) — counter and
            # tkey are the name-valued slots, positionally or by keyword
            if len(node.args) > 2:
                suspects.append(node.args[2])
            if len(node.args) > 4:
                suspects.append(node.args[4])
            suspects += [kw.value for kw in node.keywords
                         if kw.arg in ("counter", "tkey")]
            for arg in suspects:
                if (isinstance(arg, ast.Constant)
                        and isinstance(arg.value, str)
                        and self._COUNTERISH.match(arg.value)):
                    self.report(arg, f"counter name {arg.value!r} as a "
                                     f"free literal; use repro_torch.core."
                                     f"darshan.CTR.{arg.value} "
                                     f"(registry-validated, typo-proof)")
        self.generic_visit(node)


class LockHeldBlockingChecker(Checker):
    rule = "JBP004"
    name = "lock-held-blocking"
    description = ("blocking call (socket recv/accept, queue get/put or "
                   "join/wait without a timeout, time.sleep, file opens, "
                   "fsync, framed send/recv) inside a `with <lock>:` body "
                   "— every contender stalls behind it; narrow the "
                   "critical section or add a timeout. Condition/Event "
                   "contexts are exempt (wait() releases the lock).")
    path_excludes = ("tests", "benchmarks")

    _NAME_CALLS = {"open", "open_file", "sleep", "send_msg", "recv_msg",
                   "InstrumentedFile"}
    _ATTR_CALLS = {"recv", "recvfrom", "recv_into", "accept", "connect",
                   "sendall", "fsync", "sleep", "send_msg", "recv_msg"}

    def visit_With(self, node):
        lockish = [ast.unparse(it.context_expr) for it in node.items
                   if _LOCKISH.search(ast.unparse(it.context_expr))
                   and not _CONDISH.search(ast.unparse(it.context_expr))]
        if lockish:
            for stmt in node.body:
                self._scan(stmt, lockish[0])
        self.generic_visit(node)

    def _scan(self, node, lockname):
        # deferred-execution bodies run later, NOT under this lock
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Call):
            self._check_call(node, lockname)
        for child in ast.iter_child_nodes(node):
            self._scan(child, lockname)

    def _check_call(self, node, lockname):
        f = node.func
        has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
        if isinstance(f, ast.Name):
            if f.id in self._NAME_CALLS:
                self._flag(node, f.id, lockname)
            return
        if not isinstance(f, ast.Attribute):
            return
        recv = ast.unparse(f.value)
        what = f"{recv}.{f.attr}"
        if f.attr in self._ATTR_CALLS:
            self._flag(node, what, lockname)
        elif f.attr in ("wait", "join") and not node.args and not has_timeout:
            self._flag(node, what, lockname)
        elif (f.attr in ("get", "put") and not has_timeout
                and _QUEUEISH.search(recv)):
            self._flag(node, what, lockname)

    def _flag(self, node, what, lockname):
        self.report(node, f"blocking call {what}(...) while holding "
                          f"{lockname} — every contender stalls behind it; "
                          f"narrow the critical section or use a timeout")


class SpawnSafetyChecker(Checker):
    rule = "JBP005"
    name = "spawn-unsafe"
    description = ("lambda / nested function handed to a spawn-started "
                   "worker (`Process(target=...)`, `spawn_io_workers` "
                   "target, or shipped through a worker task queue) — the "
                   "spawn start method pickles the target by reference, "
                   "so these fail at Process.start(), far from the code "
                   "that wrote them")
    path_excludes = ("tests", "benchmarks")

    def visit_Module(self, node):
        self._nested_defs = set()
        for fn in ast.walk(node):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(fn):
                    if sub is not fn and isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._nested_defs.add(sub.name)
        self.generic_visit(node)

    def _unsafe(self, v):
        if isinstance(v, ast.Lambda):
            return "a lambda"
        if isinstance(v, ast.Name) and v.id in self._nested_defs:
            return f"nested function {v.id!r}"
        return None

    def visit_Call(self, node):
        fname = ast.unparse(node.func)
        if fname == "Process" or fname.endswith(".Process"):
            for kw in node.keywords:
                if kw.arg == "target":
                    bad = self._unsafe(kw.value)
                    if bad:
                        self.report(kw.value,
                                    f"{bad} as Process target does not "
                                    f"pickle under the spawn start method "
                                    f"the I/O planes require — use a "
                                    f"module-level function")
        if fname.endswith("spawn_io_workers") and len(node.args) > 1:
            bad = self._unsafe(node.args[1])
            if bad:
                self.report(node.args[1],
                            f"{bad} as spawn_io_workers target does not "
                            f"pickle under spawn — use a module-level "
                            f"function")
        f = node.func
        if (isinstance(f, ast.Attribute) and f.attr in ("put", "put_nowait")
                and _QUEUEISH.search(ast.unparse(f.value))):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Lambda):
                    self.report(sub, "lambda shipped through a worker "
                                     "queue — task messages must pickle "
                                     "under the spawn start method; ship "
                                     "data + a module-level handler "
                                     "instead")
                    break
        self.generic_visit(node)


class WallClockDurationChecker(Checker):
    rule = "JBP006"
    name = "wall-clock-duration"
    description = ("`time.time()` used for duration measurement on the "
                   "data planes — the wall clock steps (NTP slew, "
                   "suspend), so elapsed time computed from it is wrong "
                   "exactly when the machine is busiest; use "
                   "time.perf_counter() (or time.monotonic() for "
                   "deadlines). Bare `time.time()` epoch STAMPS are fine "
                   "— only subtraction operands and comparisons are "
                   "flagged.")
    path_includes = ("core", "serve", "tools")
    path_excludes = ("tests", "benchmarks")

    @staticmethod
    def _is_wall_clock(node) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "time"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "time")

    def _flag(self, node, how: str):
        self.report(node, f"time.time() {how} measures a duration on the "
                          f"wall clock, which steps under NTP/suspend — "
                          f"use time.perf_counter() (durations) or "
                          f"time.monotonic() (deadlines); wall clock is "
                          f"only valid as an epoch stamp")

    def visit_BinOp(self, node):
        if isinstance(node.op, ast.Sub):
            for side in (node.left, node.right):
                if self._is_wall_clock(side):
                    self._flag(side, "in a subtraction")
        self.generic_visit(node)

    def visit_Compare(self, node):
        for side in [node.left] + list(node.comparators):
            if self._is_wall_clock(side):
                self._flag(side, "in a comparison (deadline check)")
        self.generic_visit(node)


ALL_CHECKERS = (BareAssertChecker, RawOpenChecker, CounterLiteralChecker,
                LockHeldBlockingChecker, SpawnSafetyChecker,
                WallClockDurationChecker)
