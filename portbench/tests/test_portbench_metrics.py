"""Each metric reader on a small recorded run, against values worked by
hand; and a reader with nothing to read returns nothing."""
import json
import pathlib

import pytest

from portbench import cells, trace

RECORD = json.loads((pathlib.Path(__file__).parent / "data"
                     / "record_small.json").read_text())

# device busy: [10, 12], [15, 25], [30, 100], [600, 700] us of 1,000
LAYER = {
    "io_blocked_share": 50.0,              # 1 + 3 + 1 s of 10
    "device_idle_share": 100.0 * (1 - 182 / 1000),
    # 18,088 B at 3.35 TB/s over 82 us of device time in 10 steps
    "pic_step_mfu": 100.0 * (18088 / 3.35e12) / 8.2e-6,
    "deposit_roofline": 100.0 * (12544 / 3.35e12) / 3e-6,
    "posix_write_share": 100.0 * 1.6 / 16,
    "plane_writer_skew": (1.6 / 0.5 + 2.0 / 0.5) / 2,
    "posix_read_share": 25.0,
}
END_TO_END = {"setup_s": 12.5, "step_ms": 10.0,
              "ckpt_GBps": 2 * 73736 / 4.0 / 1e9, "restore_s": 2.0}


@pytest.mark.parametrize("name", sorted(LAYER))
def test_layer_metric(name):
    got = cells.load_reader("layer_metrics", name).read(RECORD)
    assert got == pytest.approx(LAYER[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(END_TO_END))
def test_end_to_end_metric(name):
    got = cells.load_reader("end_to_end", name).read(RECORD)
    assert got == pytest.approx(END_TO_END[name], rel=1e-12)


@pytest.mark.parametrize("name", ["device_idle_share", "pic_step_mfu",
                                  "deposit_roofline",
                                  "plane_writer_skew", "posix_read_share"])
def test_nothing_to_read_gives_nothing(name):
    bare = {k: v for k, v in RECORD.items() if k not in ("traced", "restore")}
    bare["checkpoints"] = [{**c, "engine": {}} for c in RECORD["checkpoints"]]
    assert cells.load_reader("layer_metrics", name).read(bare) is None


def test_breakdown():
    t = RECORD["traced"]
    assert trace.busy_us(t) == 182.0
    assert trace.idle_gaps(t) == pytest.approx(
        {"pic.steps": 518e-6, "ckpt.save": 300e-6})
    top = trace.top(trace.device_ops(t))
    assert top[0][1] == pytest.approx(100e-6) and "shuffle_kernel" in top[0][0]
    assert len(top) == 4


def test_reduce_chrome_trace(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.TRACED,
           "ts": 1000, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "pic.steps",
           "ts": 1000, "dur": 60},
          {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 1000,
           "dur": 60},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 1010, "dur": 5},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 2000, "dur": 5},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1010,
           "dur": 5}]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    got = trace.reduce_chrome_trace(p)
    assert got == {"window_us": 100.0, "device": [["k", "kernel", 10.0, 5.0]],
                   "spans": [["pic.steps", 0.0, 60.0]]}
