"""The program's own ranges: `program_trace.reduce` on a small synthetic
chrome trace (a kernel put down to the range that held its launch, the
innermost range winning, a range outside the window left out), the
readers of the program's spans on it, each reader with nothing to read,
the port's ranges apart from the benchmark's span names, a CPU run of
the checkpointing cell through `program_spans`, and on a card one traced
period of each cell."""
import dataclasses
import json

import pytest

from portbench import cells, program_spans, program_trace, trace
from portbench.runners import pic as runner

BENCH = cells.load_benchmark()
READERS = sorted(program_spans.PROGRAM_METRICS)
SMALL = dict(n_cells=256, capacity=8192, n_electrons=2000, n_ions=2000,
             n_neutrals=2000)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


#: window [1000, 2000); main thread 1 runs the steps then the save; the
#: writer thread 2 encodes inside the save
EVENTS = [
    _x(trace.TRACED, "user_annotation", 1000, 1000),
    _x("pic.steps", "user_annotation", 1000, 400),
    _x("pic.ionize", "user_annotation", 1100, 200),
    _x("pic.spawn", "user_annotation", 1150, 50),
    _x("aten::sort", "cpu_op", 1155, 10),          # an op, no range
    _x("ckpt.save", "user_annotation", 1500, 400),
    _x("bp.encode", "user_annotation", 1550, 100, tid=2),
    _x("bp.encode", "user_annotation", 1600, 100, tid=3),
    _x("bp.fsync", "user_annotation", 1800, 20),
    _x("pic.deposit", "user_annotation", 500, 100),     # before the window
    # launches (thread, time) and their device work
    _x("cudaLaunchKernel", "cuda_runtime", 1160, 5, correlation=1),
    _x("spawn_k", "kernel", 1170, 30, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 1120, 5, correlation=2),
    _x("ionize_k", "kernel", 1210, 10, correlation=2),
    _x("cuMemcpyAsync", "cuda_driver", 1050, 5, correlation=3),
    _x("Memcpy DtoH", "gpu_memcpy", 1060, 60, correlation=3),
    # launched by thread 2 while thread 1 is inside pic.spawn's time
    _x("cudaLaunchKernel", "cuda_runtime", 1160, 2, tid=2, correlation=4),
    _x("other_k", "kernel", 1300, 5, correlation=4),
    _x("lost_k", "kernel", 1400, 5, correlation=99),
    _x("cudaLaunchKernel", "cuda_runtime", 560, 5, correlation=5),
    _x("early_k", "kernel", 570, 5, correlation=5),     # before the window
]


@pytest.fixture
def reduced(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    return program_trace.reduce(p)


def test_reduce_puts_device_work_down_to_its_launch(reduced):
    got = {n: (rng, at) for n, _, _, _, rng, at in reduced["device"]}
    assert got == {"spawn_k": ("pic.spawn", 160.0),      # innermost wins
                   "ionize_k": ("pic.ionize", 120.0),
                   "Memcpy DtoH": ("", 50.0),             # no range open
                   "other_k": ("", 160.0),                # another thread
                   "lost_k": ("", None)}                  # no launch seen


def test_reduce_keeps_the_program_ranges_of_the_window(reduced):
    assert reduced["ranges"] == [["pic.ionize", 100.0, 200.0],
                                 ["pic.spawn", 150.0, 50.0],
                                 ["bp.encode", 550.0, 100.0],
                                 ["bp.encode", 600.0, 100.0],
                                 ["bp.fsync", 800.0, 20.0]]


def test_reduce_without_a_window_gives_nothing(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS[1:]}))
    assert program_trace.reduce(p) == {}


def _record(reduced) -> dict:
    """A run's record as the runner would leave it with the program's
    ranges recorded: the benchmark's spans, then the program's."""
    spans = [["pic.steps", 0.0, 400.0], ["ckpt.save", 500.0, 400.0]]
    return {"traced": {"window_us": 1000.0, "spans": spans
                       + reduced["ranges"], "program": reduced},
            "restore": {"s": 2.0, "read_time": 0.1, "decode_time": 1.25}}


#: encode [550, 700) on two threads: union 150, summed 200, of a 400-us save
WORKED = {"ckpt_encode_share": 100.0 * 150 / 400,
          "ckpt_encode_threads": 200 / 150,
          "ckpt_fsync_share": 100.0 * 20 / 400,
          "restore_decode_s": 1.25,
          # launched inside pic.steps: spawn 30, ionize 10, memcpy 60,
          # other 5 (lost_k has no launch)
          "spawn_device_share": 100.0 * 30 / 105}


@pytest.mark.parametrize("name", READERS)
def test_program_reader(reduced, name):
    got = cells.load_reader("layer_metrics", name).read(_record(reduced))
    assert got == pytest.approx(WORKED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_program_reader_without_its_data_gives_nothing(reduced, name):
    reader = cells.load_reader("layer_metrics", name)
    rec = _record(reduced)
    bare = {"traced": {k: v for k, v in rec["traced"].items()
                       if k != "program"},
            "restore": {k: v for k, v in rec["restore"].items()
                        if k != "decode_time"}}
    assert reader.read(bare) is None
    assert reader.read({}) is None
    # the traced period without the ranges a reader reads
    empty = {"ranges": [], "device": []}
    assert reader.read({"traced": {**rec["traced"], "program": empty}}) \
        is None


def test_breakdown_puts_idle_gaps_down_to_program_ranges(reduced):
    # the device idle over [540, 720) and [790, 830)
    busy = [["k", "kernel", 0.0, 540.0], ["k", "kernel", 720.0, 70.0],
            ["k", "kernel", 830.0, 170.0]]
    t = {**_record(reduced)["traced"], "device": busy}
    assert trace.idle_gaps(t) == pytest.approx({"bp.encode": 180e-6,
                                                "bp.fsync": 40e-6})
    bench = {**t, "spans": t["spans"][:2]}
    assert trace.idle_gaps(bench) == pytest.approx({"ckpt.save": 220e-6})


def test_program_ranges_bear_no_benchmark_span_name(tmp_path):
    """Every range a CPU step, save and restore open is the program's:
    none takes a name the benchmark's spans use."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.core import EngineConfig
    from repro_torch.pic import simulation as sim
    cfg = sim.PicConfig(n_cells=64, capacity=1024, n_electrons=300,
                        n_ions=300, n_neutrals=300, rate_R=0.5, dt=1e-2)
    state = sim.init_sim(cfg, 3, device="cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        state = sim.pic_step(state, cfg)
        CK.save_checkpoint(tmp_path / "ck", state._asdict(), 1,
                           engine_config=EngineConfig(codec="blosc"),
                           device_compress=True)
        CK.restore_checkpoint(tmp_path / "ck", state._asdict())
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]
        if e.get("cat") == program_trace.RANGE_CAT
        and program_trace.RANGE.match(e["name"])}
    assert {"pic.spawn", "bp.encode", "bp.fsync", "bp.decode",
            "ckpt.publish", "ckpt.h2d"} <= names
    assert not names & (set(trace.SPAN_NAMES) | {trace.TRACED})
    assert torch.is_tensor(state.key)


def _small(cell: str):
    plan = cells.plan(BENCH, cell)
    return dataclasses.replace(
        plan, config={**plan.config, **SMALL},
        mix={**plan.mix, "steps_per_diag": 5, "diags_per_period": 3})


def test_a_cpu_run_through_program_spans_reads_the_save(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(runner, "SHM", tmp_path)
    plan = _small("bit1_q4.ckpt")
    with program_spans.installed() as decodes:
        res = runner.run(plan, 2**31 + 977, 0.0, True, device="cpu")
    assert res["correct"], res["checks"]
    line = program_spans.program_line(plan, res, decodes)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    # the CPU has no device work, so no spawn share
    assert set(got) == set(READERS) - {"spawn_device_share"}
    assert 0 < got["ckpt_encode_share"] <= 100
    assert got["ckpt_encode_threads"] >= 1.0
    assert 0 < got["ckpt_fsync_share"] < 100
    assert got["restore_decode_s"] > 0
    assert dict(line["program"]["range_s"])["pic.spawn"] > 0
    # the wrappers are gone once the block ends
    assert trace.profile_start.__module__ == "portbench.trace"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bit1_q4.steps", "bit1_q4.ckpt"])
def test_a_traced_period_on_the_card_finds_the_program_ranges(cuda, cell):
    plan = dataclasses.replace(_small(cell), mix={**_small(cell).mix,
                                                  "steps_per_diag": 10})
    with program_spans.installed() as decodes:
        res = runner.run(plan, 2**33 + 1, 0.0, True, device=cuda)
    assert res["correct"], res["checks"]
    prog = res["record"]["traced"]["program"]
    names = {n for n, *_ in prog["ranges"]}
    assert {"pic.deposit", "pic.key", "pic.ionize", "pic.spawn",
            "pic.push"} <= names
    line = program_spans.program_line(plan, res, decodes)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == {n for n, where in program_spans.PROGRAM_METRICS
                        .items() if cell in where}
    assert 0 < got["spawn_device_share"] <= 100
    if cell == "bit1_q4.ckpt":
        assert {"bp.device_shuffle", "bp.d2h_wait", "bp.encode",
                "bp.fsync", "ckpt.publish"} <= names
