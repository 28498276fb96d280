"""The port's spans on the profiler's clock (`core/dxt.py`'s sink): a PIC
step, a checkpoint save, a restore and a train step under
`torch.profiler` each show their `<layer>.<op>` ranges in the exported
trace, nested where the work nests; with no profiler, the ring off and
no metrics asked for, a span is the shared no-op span and reads no
clock; `core.dxt` loads without torch;
the restore's decode is counted in `DECOMPRESS_TIME`; and the encode's
overlap counts only blocks whose successor was still in flight."""
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import get_config, reduce_for_smoke
from repro_torch.core import EngineConfig
from repro_torch.core import compression as C
from repro_torch.core import dxt
from repro_torch.core.darshan import CTR, MONITOR
from repro_torch.core.dxt import _NULL_SPAN, SPAN_OPS, TRACER
from repro_torch.core.metrics import METRICS
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.pic import simulation as sim
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step

CFG = sim.PicConfig(n_cells=64, capacity=1024, n_electrons=512, n_ions=512,
                    n_neutrals=512, rate_R=0.5, dt=1e-2)
ENGINE = EngineConfig(aggregators=2, codec="blosc", workers=2)
#: the chunks a device-compressed save at 4 I/O ranks shuffles on the
#: device, one a row chunk of each tensor leaf of rank >= 1: x, v, w and
#: alive of three species in 4, and the key (2 rows) in 2
DEVICE_CHUNKS = 12 * 4 + 2
RANGE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")


@pytest.fixture(autouse=True)
def fresh_planes():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    MONITOR.reset()
    METRICS.reset()
    yield
    if TRACER.enabled:
        TRACER.disable()
        TRACER.reset()
    if METRICS.enabled:
        METRICS.disable()
    METRICS.reset()
    MONITOR.reset()
    torch.set_num_threads(n)


def _all_threads():
    """A CPU profiler that follows every thread (the engine's compress
    jobs run on its writer pool)."""
    from torch._C._profiler import _ExperimentalConfig
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _ranges(prof, tmp) -> list:
    """(name, start, end, tid) of each program range in the trace: a
    `<layer>.<op>` `user_annotation` event."""
    path = tmp / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["tid"]) for e in ev
            if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and RANGE.match(e["name"])]


def _named(ranges, name) -> list:
    return [r for r in ranges if r[0] == name]


def _inside(inner, outer) -> bool:
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2])


def _each_inside_one(ranges, inner: str, outer: str) -> bool:
    outs = _named(ranges, outer)
    return all(any(_inside(r, o) for o in outs)
               for r in _named(ranges, inner))


def test_pic_step_ranges_nest_as_the_step_runs(tmpdir_path):
    state = sim.init_sim(CFG, 7, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.pic_step(state, CFG)
    r = _ranges(prof, tmpdir_path)
    counts = {n: len(_named(r, n)) for n in
              ("pic.deposit", "pic.key", "pic.ionize", "pic.spawn",
               "pic.push")}
    assert counts == {"pic.deposit": 1, "pic.key": 1, "pic.ionize": 1,
                      "pic.spawn": 2, "pic.push": 1}
    assert _each_inside_one(r, "pic.spawn", "pic.ionize")
    order = [n for n, *_ in sorted(r, key=lambda x: x[1])
             if n != "pic.spawn"]
    assert order == ["pic.deposit", "pic.key", "pic.ionize", "pic.push"]


@pytest.mark.parametrize("device_compress", [False, True])
def test_save_ranges_nest_as_the_save_runs(tmpdir_path, device_compress):
    state = sim.init_sim(CFG, 7, device="cpu")
    with _all_threads() as prof:
        ckpt.save_checkpoint(tmpdir_path / "ck", state._asdict(), 5,
                             n_io_ranks=4, engine_config=ENGINE,
                             device_compress=device_compress)
    r = _ranges(prof, tmpdir_path)
    assert _named(r, "bp.encode")
    assert _each_inside_one(r, "bp.encode", "bp.compress")
    assert len(_named(r, "bp.append")) == len(_named(r, "bp.compress"))
    assert len(_named(r, "bp.seal")) == 1
    # the seal's two fsyncs (md.0, md.idx), then each subfile's at close
    fsyncs = _named(r, "bp.fsync")
    assert sum(_inside(f, _named(r, "bp.seal")[0]) for f in fsyncs) == 2
    assert len(fsyncs) == 2 + ENGINE.aggregators
    (publish,) = _named(r, "ckpt.publish")
    assert publish[1] >= max(f[2] for f in fsyncs)
    shuffles = _named(r, "bp.device_shuffle")
    if device_compress:
        assert len(shuffles) == DEVICE_CHUNKS
        assert _each_inside_one(r, "bp.device_shuffle", "bp.compress")
        # no encode inside a shuffle: the stage is the shuffle alone
        assert not any(_inside(e, s) for e in _named(r, "bp.encode")
                       for s in shuffles)
    else:
        assert shuffles == []


def test_restore_ranges_and_decode_counter(tmpdir_path):
    state = sim.init_sim(CFG, 7, device="cpu")
    ckpt.save_checkpoint(tmpdir_path / "ck", state._asdict(), 5,
                         n_io_ranks=4, engine_config=ENGINE,
                         device_compress=True)
    before = MONITOR.report()["total"].get(CTR.DECOMPRESS_TIME, 0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        back, step = ckpt.restore_checkpoint(tmpdir_path / "ck",
                                             state._asdict())
    after = MONITOR.report()["total"][CTR.DECOMPRESS_TIME]
    assert step == 5 and after > before
    assert torch.equal(back["electrons"].x, state.electrons.x)
    r = _ranges(prof, tmpdir_path)
    reads, decodes = _named(r, "bp.read"), _named(r, "bp.decode")
    assert reads and len(reads) == len(decodes)
    assert all(a[2] <= b[1] for a, b in zip(sorted(reads), sorted(decodes)))
    n_tensors = sum(isinstance(v, torch.Tensor)
                    for v in ckpt.flatten_state(state._asdict()).values())
    assert len(_named(r, "ckpt.h2d")) == n_tensors


def test_spans_register_their_ops_and_feed_the_ring_and_metrics(tmpdir_path):
    """With the ring and the metrics plane on, each interval is one ring
    event under a span op and one METRICS observation under the op and
    key the engine observed before (`jbpstat`, `jbpd` read them)."""
    TRACER.enable()
    METRICS.enable()
    state = sim.pic_step(sim.init_sim(CFG, 7, device="cpu"), CFG)
    ckpt.save_checkpoint(tmpdir_path / "ck", state._asdict(), 5,
                         n_io_ranks=4, engine_config=ENGINE,
                         device_compress=True)
    ops = {e[3] for e in TRACER.events()}
    for op in ("deposit", "key", "ionize", "spawn", "push", "compress",
               "device_shuffle", "encode", "append", "seal", "publish",
               "snapshot"):
        assert op in ops and op in SPAN_OPS, op
    assert "fsync" in ops and "fsync" not in SPAN_OPS    # a POSIX op
    cells = {k: c["count"] for k, c in METRICS.merged().items()}
    assert cells["compress|data.0"] == 1
    assert cells["device_shuffle|"] == DEVICE_CHUNKS
    assert sum(v for k, v in cells.items() if k.startswith("seal|")) == 1
    assert not any(k.startswith(("encode|", "append|", "deposit|"))
                   for k in cells)


def test_span_off_is_the_null_span_and_reads_no_clock(monkeypatch):
    assert not TRACER.enabled and not METRICS.enabled
    assert TRACER.span("encode") is _NULL_SPAN
    assert TRACER.span("seal", observe=True) is _NULL_SPAN
    assert TRACER.span("spawn", layer="pic") is _NULL_SPAN
    assert TRACER.annotate("bp.fsync") is _NULL_SPAN

    def no_clock():
        raise AssertionError("a span read the clock")

    monkeypatch.setattr(dxt, "time", types.SimpleNamespace(
        perf_counter=no_clock))
    state = sim.init_sim(CFG, 7, device="cpu")
    sim.pic_step(state, CFG)
    C.device_array_payload(torch.arange(3000, dtype=torch.float32), "blosc",
                           block=4096)


def test_span_opens_a_range_only_while_the_profiler_records(tmpdir_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = TRACER.span("encode")
        with sp:
            pass
    assert sp is not _NULL_SPAN
    assert TRACER.span("encode") is _NULL_SPAN
    assert [n for n, *_ in _ranges(prof, tmpdir_path)] == ["bp.encode"]


def test_dxt_imports_without_torch():
    code = ("import sys; import repro_torch.core.dxt as d; "
            "print('torch' in sys.modules, d.TRACER.span('x') is d._NULL_SPAN)")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, check=True,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.stdout.split() == ["False", "True"]


class _Event:
    def __init__(self, landed: bool):
        self.landed = landed

    def synchronize(self):
        pass

    def query(self) -> bool:
        return self.landed


def test_overlap_counts_blocks_whose_successor_was_in_flight(monkeypatch):
    """Block 0's successor is in flight when its LZ starts, block 1's has
    landed and block 2 has none: only block 0's LZ seconds count."""
    data = np.arange(3 * 1024, dtype=np.float32)
    host = data.view(np.uint8)
    blocks = [(0, 4096, None, True), (4096, 8192, _Event(False), True),
              (8192, 12288, _Event(True), True)]
    monkeypatch.setattr(C, "_device_shuffled_blocks",
                        lambda t, block, itemsize: (host, blocks, 12288,
                                                    None))
    ticks = iter(range(100))
    monkeypatch.setattr(C, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    _, stats = C.device_array_payload(torch.from_numpy(data), "blosc",
                                      block=4096)
    assert stats.overlap_s == 1.0
    assert stats.device_bytes == 12288


#: zamba2-2.7b at the smoke size: 4 Mamba2 layers in 2 units of 2
TRAIN_CFG = reduce_for_smoke(get_config("zamba2-2.7b"))


def _train_step():
    """A remat'd train step of the hybrid at the smoke size, its state
    and a batch of 2 x 32 tokens, on the CPU."""
    step_fn = make_train_step(TRAIN_CFG, AdamWConfig(), q_chunk=32,
                              kv_chunk=32, ssd_chunk=16)
    state = init_train_state(TRAIN_CFG, 3, device="cpu")
    batch = SyntheticTokens(TRAIN_CFG.padded_vocab, 32, 2, seed=3).batch_at(0)
    return step_fn, state, {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_step_ranges_nest_as_the_step_runs(tmpdir_path):
    """`train.step` holds `train.fwd_bwd` and then `train.adamw`; each
    layer's SSD backward (`ssm.ssd_bwd`) and each unit's flash backward
    (`attn.flash_bwd`) run inside `train.fwd_bwd` (on the CPU the
    backward runs on the calling thread)."""
    step_fn, state, batch = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_fn(state, batch)
    r = _ranges(prof, tmpdir_path)
    units = TRAIN_CFG.n_layers // TRAIN_CFG.shared_attn_interval
    counts = {n: len(_named(r, n)) for n in
              ("train.step", "train.fwd_bwd", "train.adamw", "ssm.ssd_bwd",
               "attn.flash_bwd")}
    assert counts == {"train.step": 1, "train.fwd_bwd": 1, "train.adamw": 1,
                      "ssm.ssd_bwd": TRAIN_CFG.n_layers,
                      "attn.flash_bwd": units}
    assert _each_inside_one(r, "train.fwd_bwd", "train.step")
    assert _each_inside_one(r, "train.adamw", "train.step")
    assert _each_inside_one(r, "ssm.ssd_bwd", "train.fwd_bwd")
    assert _each_inside_one(r, "attn.flash_bwd", "train.fwd_bwd")
    (fb,), (ad,) = _named(r, "train.fwd_bwd"), _named(r, "train.adamw")
    assert fb[2] <= ad[1]


def test_train_step_with_tracing_off_opens_no_range(monkeypatch):
    """No profiler, the ring off, no metrics: every span of the step is
    the shared no-op span and no program range is opened."""
    assert not TRACER.enabled and not METRICS.enabled
    opened = []
    real_rf = torch.autograd.profiler.record_function

    class Recorded(real_rf):
        def __init__(self, name, *a, **kw):
            opened.append(name)
            super().__init__(name, *a, **kw)

    spans = []
    real_span = TRACER.span

    def span(*a, **kw):
        spans.append((a, real_span(*a, **kw)))
        return spans[-1][1]

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Recorded)
    monkeypatch.setattr(TRACER, "span", span)
    step_fn, state, batch = _train_step()
    step_fn(state, batch)
    units = TRAIN_CFG.n_layers // TRAIN_CFG.shared_attn_interval
    assert sorted(a[0] for a, _ in spans) == sorted(
        ["step", "fwd_bwd", "adamw"] + ["ssd_bwd"] * TRAIN_CFG.n_layers
        + ["flash_bwd"] * units)
    assert all(sp is _NULL_SPAN for _, sp in spans)
    assert not [n for n in opened if RANGE.match(n)]
