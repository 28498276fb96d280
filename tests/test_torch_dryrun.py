"""The port's dry-run (`repro_torch.launch.dryrun`), mirroring
`tests/test_dryrun_cells.py`: the shape table and the skip rules, and one
production cell a mesh traced on a fake process group of 256 or 512
ranks in a subprocess with its own time limit (no GPU: fake tensors)."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.base import get_config
from repro_torch.launch.shapes import SHAPE_TABLE, applicable

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_shape_table_is_the_assignment():
    assert SHAPE_TABLE["train_4k"].seq == 4096
    assert SHAPE_TABLE["train_4k"].batch == 256
    assert SHAPE_TABLE["prefill_32k"].seq == 32768
    assert SHAPE_TABLE["prefill_32k"].batch == 32
    assert SHAPE_TABLE["decode_32k"].batch == 128
    assert SHAPE_TABLE["long_500k"].seq == 524288
    assert SHAPE_TABLE["long_500k"].batch == 1


def test_long_context_skip_rules():
    ok, _ = applicable(get_config("mamba2-2.7b"), "long_500k")
    assert ok
    ok, _ = applicable(get_config("zamba2-2.7b"), "long_500k")
    assert ok
    for arch in ("phi3-mini-3.8b", "qwen3-4b", "arctic-480b",
                 "llama-3.2-vision-90b", "musicgen-large"):
        ok, why = applicable(get_config(arch), "long_500k")
        assert not ok and "full-attention" in why


def test_a_skipped_cell_reports_its_reason():
    from repro_torch.launch.dryrun import run_cell
    out = run_cell("qwen3-4b", "long_500k", "single", verbose=False)
    assert out["status"] == "skipped" and "full-attention" in out["reason"]


_CELL = textwrap.dedent("""
    import sys
    from repro_torch.launch.dryrun import run_cell
    out = run_cell("qwen1.5-0.5b", "decode_32k", sys.argv[1], verbose=False)
    assert out["status"] == "ok", out
    r = out["roofline"]
    assert r["flops_per_device"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert out["memory_analysis"]["argument_bytes"] > 0
    assert out["mesh_info"]["n_devices"] == int(sys.argv[2])
    # the memory term's lower bound (inputs and outputs once) beside the
    # unfused one
    assert 0 < r["io_bytes_per_device"] <= r["hbm_bytes_per_device"]
    assert r["memory_lower_s"] == r["io_bytes_per_device"] / 3.35e12
    # every group of a production mesh spans nodes (16-wide axes)
    cross = r["collective_cross_node_bytes_per_device"]
    assert cross == r["collective_bytes_per_device"] > 0
    # the report rebuilt from the stored counts, with the split and
    # without it (a cell stored before the split: all of it crosses)
    from repro_torch.launch.dryrun import rereport
    assert rereport(out)["roofline"] == r
    old = {k: v for k, v in r.items()
           if k != "collective_cross_node_bytes_per_device"}
    assert rereport({**out, "roofline": old})["roofline"] == r
    print("CELL_OK", r["dominant"])
""")


@pytest.mark.parametrize("mesh,n", [("single", 256), ("multi", 512)])
def test_one_cell_traces_on_the_production_mesh(mesh, n):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", _CELL, mesh, str(n)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert "CELL_OK" in r.stdout, (r.stdout[-500:], r.stderr[-2000:])
