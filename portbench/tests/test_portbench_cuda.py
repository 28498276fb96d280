"""On a card: a short traced run of each cell at a small size is
correct, and reads the port's kernels from the profiler."""
import dataclasses

import pytest

from portbench import cells
from portbench.run import result_line

BENCH = cells.load_benchmark()
SMALL = dict(n_cells=4096, capacity=1 << 18, n_electrons=1 << 16,
             n_ions=1 << 16, n_neutrals=1 << 16)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_small_traced_run_on_the_card(cuda, cell):
    plan = cells.plan(BENCH, cell)
    plan = dataclasses.replace(plan, config={**plan.config, **SMALL},
                               mix={**plan.mix, "steps_per_diag": 10})
    res = plan.runner.run(plan, 2**33 + 1, 0.0, True, device=cuda)
    assert res["correct"], res["checks"]
    line = result_line(plan, res, True, {"platform": "gpu"})
    assert set(line["metrics"]) == {m["name"] for m, _ in plan.per_layer}
    for name, m in line["metrics"].items():
        if name.endswith(("_roofline", "_mfu")):
            assert 0 < m["value"] <= 105, name
    assert line["device"]["busy_s"] > 0
