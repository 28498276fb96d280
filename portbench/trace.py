"""Spans the benchmark puts around its calls into the program's layers,
the profiler's start and stop around a traced stretch, and the reduction
of its `torch.profiler` trace to the device's work.

A span is recorded on the host clock (seconds from the window's start)
in every run and, as a `record_function` range, in the profiler's trace
when one is running, so device intervals can be matched to the span the
host was in. Every runner traces through `profile_start`,
`profile_stop` and `reduced`."""
from __future__ import annotations

import contextlib
import json
import time

#: the enclosing span of the traced window
TRACED = "bench.traced"
#: the benchmark's spans, in the order of the cycle
SPAN_NAMES = ("pic.steps", "diag.write", "ckpt.save", "ckpt.wait")
#: the profiler's categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    def __init__(self):
        self.t0 = time.perf_counter()
        self.items: list[list] = []

    def now(self) -> float:
        return time.perf_counter() - self.t0

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t = self.now()
        with torch.profiler.record_function(name):
            yield
        self.items.append([name, t, self.now()])

    def total(self, names) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.items if n in names)


def profile_start():
    """A profiler recording the CPU and, where there is a card, the
    device, with the `TRACED` range open: the traced stretch starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    span = record_function(TRACED)
    span.__enter__()
    return prof, span


def profile_stop(prof):
    """Closes the `TRACED` range and, once the device is done, the
    profiler."""
    import torch
    p, span = prof
    span.__exit__(None, None, None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    p.__exit__(None, None, None)


def reduced(prof, work) -> dict:
    """The stopped profiler's trace, exported to `work` as a chrome trace,
    reduced by `reduce_chrome_trace` and removed."""
    path = work / "trace.json"
    prof[0].export_chrome_trace(str(path))
    out = reduce_chrome_trace(path)
    path.unlink()
    return out


def reduce_chrome_trace(path) -> dict:
    """The traced window's device work and spans from an exported chrome
    trace: `window_us` its length; `device` [name, category, start,
    duration] of each device operation; `spans` [name, start, duration]
    of each benchmark span inside it; times in microseconds from the
    window's start."""
    events = [e for e in json.loads(open(path).read())["traceEvents"]
              if e.get("ph") == "X"]
    wins = [e for e in events
            if e.get("cat") == "user_annotation" and e["name"] == TRACED]
    if not wins:
        return {}
    lo, dur = float(wins[0]["ts"]), float(wins[0]["dur"])
    hi = lo + dur

    def inside(e):
        return float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo

    dev = [[e["name"], e["cat"], float(e["ts"]) - lo, float(e["dur"])]
           for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    spans = [[e["name"], float(e["ts"]) - lo, float(e["dur"])]
             for e in events if e.get("cat") == "user_annotation"
             and e["name"] in SPAN_NAMES and inside(e)]
    return {"window_us": dur, "device": dev, "spans": spans}


def merged(intervals, lo: float, hi: float) -> list:
    """Union of [start, start + duration) intervals clipped to [lo, hi),
    as sorted disjoint [start, end)."""
    out = []
    for s, d in sorted((s, d) for s, d in intervals):
        a, b = max(s, lo), min(s + d, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(prof: dict, lo: float = 0.0, hi=None) -> float:
    hi = prof["window_us"] if hi is None else hi
    return sum(b - a for a, b in merged(
        [(s, d) for _, _, s, d in prof["device"]], lo, hi))


def idle_gaps(prof: dict) -> dict:
    """Idle device time, in seconds, by the innermost benchmark span the
    host was in at each gap's middle ("outside spans" where none)."""
    busy = merged([(s, d) for _, _, s, d in prof["device"]], 0.0,
                  prof["window_us"])
    edges = [0.0] + [x for ab in busy for x in ab] + [prof["window_us"]]
    out: dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        holders = [(d, n) for n, s, d in prof["spans"] if s <= mid < s + d]
        name = min(holders)[1] if holders else "outside spans"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def device_ops(prof: dict) -> dict:
    """Device seconds by operation name."""
    out: dict[str, float] = {}
    for n, _, _, d in prof["device"]:
        out[n] = out.get(n, 0.0) + d / 1e6
    return out


def top(d: dict, n: int = 10) -> list:
    return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
