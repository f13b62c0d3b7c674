"""On the card: a whole run of each cell at 2^16 rows, untraced and
traced, is correct and reads every metric it names."""
import time

import pytest

from portbench import run

CELLS = ["chain_gl_2e23x8.serial", "plookup_gl_2e22.serial"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_small_run_on_the_card(cell, traced, cuda_device):
    bench = run.load_benchmark()
    c = run.cell_of(bench, cell)
    res = run.run(bench, c, 2**31 + 99, 2.0, traced, cuda_device,
                  time.perf_counter(), nbits=16)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in run.metrics_of(bench, traced)}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        assert m["value"] > 0, name
        if name.endswith("_roofline"):
            assert m["value"] <= 100, name
    if traced:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
