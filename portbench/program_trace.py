"""The program's own ranges in the chrome trace of the traced period, and
the device work each one launched: what `trace.reduce_chrome_trace`
leaves out.

The port opens a profiler range named `<layer>.<op>` for each of its
spans (`src/repro_torch/core/dxt.py`: `pic.spawn`, `bp.encode`,
`ckpt.h2d`, ...), a `record_function` range exported as a
`user_annotation` event. `reduce` keeps every
such range in the window that is not the benchmark's own (`trace.TRACED`,
`trace.SPAN_NAMES`), and puts each kernel, copy and set down to the
innermost such range open on the thread that launched it: the
`cuda_runtime` or `cuda_driver` event with the same `correlation`. Times
in microseconds from the window's start, as `trace.reduce_chrome_trace`
gives them."""
from __future__ import annotations

import json
import re

from portbench import trace

#: the profiler's categories of host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the category a program range comes as, and its name
RANGE_CAT = "user_annotation"
RANGE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")


def reduce(path) -> dict:
    """`ranges`: [name, start, duration] of each program range inside the
    window; `device`: [name, category, start, duration, range, launch] of
    each device operation inside it, `range` the innermost program range
    that held its launch ("" where none did, `launch` None where the
    trace has no launch for it)."""
    events = [e for e in json.loads(open(path).read())["traceEvents"]
              if e.get("ph") == "X"]
    wins = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == trace.TRACED]
    if not wins:
        return {}
    lo, dur = float(wins[0]["ts"]), float(wins[0]["dur"])
    hi = lo + dur
    ours = set(trace.SPAN_NAMES) | {trace.TRACED}

    def inside(e):
        return float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo

    progs = [e for e in events if e.get("cat") == RANGE_CAT
             and RANGE.match(e["name"]) and e["name"] not in ours]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    dev = [e for e in events
           if e.get("cat") in trace.DEVICE_CATS and inside(e)]
    at = [launches.get(e.get("args", {}).get("correlation")) for e in dev]
    holder = _innermost(progs, [(float(a["ts"]), a.get("tid"))
                                for a in at if a is not None])
    held = iter(holder)
    device = []
    for e, a in zip(dev, at):
        device.append([e["name"], e["cat"], float(e["ts"]) - lo,
                       float(e["dur"]),
                       next(held) if a is not None else "",
                       float(a["ts"]) - lo if a is not None else None])
    ranges = [[e["name"], float(e["ts"]) - lo, float(e["dur"])]
              for e in progs if inside(e)]
    return {"ranges": ranges, "device": device}


def _innermost(ranges: list, points: list) -> list:
    """For each (time, thread) point, the name of the innermost range on
    that thread holding it (start <= time < end), "" where none does: one
    sweep a thread over the ranges' starts and ends and the points."""
    sweep: dict = {}
    for e in ranges:
        s = float(e["ts"])
        row = sweep.setdefault(e.get("tid"), [])
        row.append((s + float(e["dur"]), 0, id(e), e["name"]))
        row.append((s, 1, id(e), e["name"]))
    for i, (t, tid) in enumerate(points):
        sweep.setdefault(tid, []).append((t, 2, i, None))
    out = [""] * len(points)
    for row in sweep.values():
        row.sort(key=lambda x: (x[0], x[1]))
        stack: list = []
        for _, kind, key, name in row:
            if kind == 0:
                for j in range(len(stack) - 1, -1, -1):
                    if stack[j][0] == key:
                        del stack[j]
                        break
            elif kind == 1:
                stack.append((key, name))
            elif stack:
                out[key] = stack[-1][1]
    return out


def program(run: dict):
    """The traced period's reduction (`traced["program"]`), or None."""
    return (run.get("traced") or {}).get("program") or None


def within(run: dict, name: str, span: str = "ckpt.save"):
    """(union, sum, length), in microseconds, of the program's `name`
    ranges clipped to the benchmark's `span` spans of the traced period:
    their union, their summed lengths (several threads count several
    times) and the spans' length. None without such spans or ranges."""
    prog = program(run)
    if prog is None:
        return None
    outer = [(s, d) for n, s, d in run["traced"]["spans"] if n == span]
    inner = [(s, d) for n, s, d in prog["ranges"] if n == name]
    if not outer or not inner:
        return None
    union = sum(b - a for s, d in outer
                for a, b in trace.merged(inner, s, s + d))
    total = sum(max(0.0, min(rs + rd, s + d) - max(rs, s))
                for s, d in outer for rs, rd in inner)
    return union, total, sum(d for _, d in outer)


def launched_in(run: dict, span: str = "pic.steps") -> dict:
    """Device microseconds by the program range that launched them, of
    the operations launched inside the benchmark's `span` spans ("" for
    those launched outside every program range). None without them."""
    prog = program(run)
    if prog is None:
        return None
    spans = [(s, s + d) for n, s, d in run["traced"]["spans"] if n == span]
    out: dict = {}
    for _, _, _, d, rng, at in prog["device"]:
        if at is not None and any(a <= at < b for a, b in spans):
            out[rng] = out.get(rng, 0.0) + d
    return out or None
