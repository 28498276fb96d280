"""The counts the roofline shares divide, against numbers worked by hand
for a small configuration (64 cells, 1,024 slots a species)."""
import pytest

from portbench import counts


def test_checkpoint_bytes():
    # 3 species x (x 4 + v 12 + w 4 + alive 4) bytes a slot + the key
    assert counts.checkpoint_bytes(1024) == 3 * 24 * 1024 + 8 == 73736


def test_deposit():
    c = counts.deposit(1024, 64)
    assert c["bytes"] == 12 * 1024 + 4 * 64 == 12544
    assert c["flops"] == 7 * 1024


def test_pic_step():
    live = {"e": 300, "D_plus": 200, "D": 100}
    c = counts.pic_step(live, events=10, n_cells=64)
    # 600 live: 24 B read + 4 B written each; 10 events: 4 B + 2 x 24 B;
    # 3 grids of 64 cells
    assert c["bytes"] == 600 * 24 + 600 * 4 + 10 * 52 + 3 * 4 * 64 == 18088
    assert c["flops"] == 3 * 600 + 7 * 500 + 6 * 100 == 5900


def test_least_seconds_takes_the_larger_bound_at_each_precision():
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(989e12, 0, "bf16") == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
    assert set(counts.PEAK_FLOPS) == {"fp32", "tf32", "bf16", "fp8"}
