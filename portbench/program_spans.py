"""One traced run of a cell with the program's own spans read:

    python3 portbench/program_spans.py --workload bit1_q4.ckpt \
        --seed 12345 --seconds 51

from the root of a checkout, on a card. It runs the cell as `run.py
--trace 1` does and prints the same result line, with the metrics that
read the port's spans added under `metrics` (`PROGRAM_METRICS`, one
reader each in `layer_metrics/`), and under `program` the device seconds
by the program range that launched them and the seconds of each range.
The PIC runner (`runners/pic.py`) does not record what those readers
read, so this run adds it around the runner: `traced["program"]`
(`program_trace.reduce` of the same chrome trace), the program's ranges appended to `traced["spans"]`,
so that the breakdown puts each idle gap down to the innermost range,
the program's included, and `restore["decode_time"]`, the program's
`DECOMPRESS_TIME` over the restore. Its profiler follows every thread,
so the engine's writer-pool ranges (`bp.compress`, `bp.encode`,
`bp.append`) are seen; `run.py`'s follows the thread that starts it. A program without the spans
gives no program metrics and raises nothing.

For `run.py` to report these metrics, `runners/pic.py` has to record the
same three fields (in `_traced`, and `decode_time` in the restore
block), and `trace.profile_start` to follow every thread as `installed`
does; then each metric gets its entry in `BENCHMARK.json`."""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench.run import T0, forbidden_modules, result_line  # noqa: E402

#: readers of the program's spans, in `layer_metrics/`, by the cells in
#: which each finds something to read
PROGRAM_METRICS = {
    "ckpt_encode_share": ("bit1_q4.ckpt",),
    "ckpt_encode_threads": ("bit1_q4.ckpt",),
    "ckpt_fsync_share": ("bit1_q4.ckpt",),
    "restore_decode_s": ("bit1_q4.ckpt",),
    "spawn_device_share": ("bit1_q4.ckpt", "bit1_q4.steps",
                           "bit1_paper.steps"),
}


def _decompress_s():
    from repro_torch.core.darshan import CTR, MONITOR
    name = getattr(CTR, "DECOMPRESS_TIME", None)
    return None if name is None else MONITOR.report()["total"].get(name, 0.0)


@contextlib.contextmanager
def installed():
    """Wraps the trace reduction, the profiler's start and the
    checkpointers' restore as the module docstring says, until the block
    ends; yields the list each restore's decode seconds go to."""
    import torch

    from portbench import program, program_trace, trace
    saved = [(trace, "reduce_chrome_trace", trace.reduce_chrome_trace),
             (trace, "profile_start", trace.profile_start)]
    saved += [(cls, "restore", cls.restore)
              for cls in (program.InProcess, program.Plane)]
    reduce0 = trace.reduce_chrome_trace

    def reduce(path):
        out = reduce0(path)
        if out:
            prog = program_trace.reduce(path)
            out["program"] = prog
            out["spans"] = out["spans"] + prog.get("ranges", [])
        return out

    def profile_start():
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
        prof.__enter__()
        span = record_function(trace.TRACED)
        span.__enter__()
        return prof, span

    decodes: list = []

    def timed(restore0):
        def restore(self, like):
            d0 = _decompress_s()
            out = restore0(self, like)
            if d0 is not None:
                decodes.append(_decompress_s() - d0)
            return out
        return restore

    trace.reduce_chrome_trace = reduce
    trace.profile_start = profile_start
    for cls in (program.InProcess, program.Plane):
        cls.restore = timed(cls.__dict__["restore"])
    try:
        yield decodes
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def program_line(plan, res: dict, decodes: list) -> dict:
    """This cell's program metrics, and a `program` breakdown: device
    seconds by the range that launched them, over the traced period and
    inside `pic.steps`, each range's summed seconds, and every idle gap's
    seconds by the innermost span or range holding it."""
    from portbench import cells, program_trace, trace
    rec = res["record"]
    if decodes and "restore" in rec:
        rec["restore"]["decode_time"] = decodes[-1]
    metrics = {}
    for name, where in PROGRAM_METRICS.items():
        if plan.cell["name"] in where:
            mod = cells.load_reader("layer_metrics", name)
            v = mod.read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    out = {"metrics": metrics}
    prog = program_trace.program(rec)
    if prog is not None:
        dev: dict = {}
        for _, _, _, d, rng, _ in prog["device"]:
            dev[rng] = dev.get(rng, 0.0) + d / 1e6
        held: dict = {}
        for n, _, d in prog["ranges"]:
            held[n] = held.get(n, 0.0) + d / 1e6
        steps = program_trace.launched_in(rec) or {}
        out["program"] = {
            "device_s": trace.top(dev, 20),
            "steps_device_s": trace.top({k: v / 1e6
                                         for k, v in steps.items()}, 20),
            "range_s": trace.top(held, 30),
            "idle_s": trace.top(trace.idle_gaps(rec["traced"]), 40)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from portbench import cells
    plan = cells.plan(cells.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    with installed() as decodes:
        res = plan.runner.run(plan, args.seed, args.seconds, True,
                              device="cuda", process_start=T0)
    if forbidden_modules():
        print(f"program_spans: the run loaded {forbidden_modules()}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": plan.cell["chips"], "memory_peak_bytes": res["peak"]}
    line = result_line(plan, res, True, device)
    extra = program_line(plan, res, decodes)
    line["metrics"].update(extra["metrics"])
    if "program" in extra:
        line["program"] = extra["program"]
    rec = res["record"]
    line["window_s"], line["steps"] = rec["window_s"], rec["steps"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
