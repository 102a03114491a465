"""Every cell's loop, run small on the CPU through the port's plain
versions, agrees with the reference; and a cell runs on the card."""

import pytest
from conftest import CELLS, run_small, small_cell


@pytest.mark.parametrize("name", CELLS)
def test_cell_loop_agrees_with_the_reference_on_the_cpu(name):
    out = run_small(small_cell(name, steps=3), batch=4)
    assert out["correct"], out["lines"]
    assert out["failed"] == 0
    assert all(v == 0 for v in out["values"].values()), out["values"]
    assert out["attempted"] == 4


@pytest.mark.parametrize("name", ["tablev-fused.flash", "tablev-fabric.flash"])
def test_thirty_step_streams_spike_at_the_output(name):
    cell = small_cell(name)
    out = run_small(cell, batch=4)
    assert out["correct"], out["lines"]
    assert out["record"]["steps"] == 30
    system = cell.driver().System(cell.config, cell.mix, cell.spec, "cpu", batch=4)
    outcome = system.reference(7, 0, system.reference_network())
    assert (outcome.counts.sum(1) > 0).all()  # every stream's output population fires


def test_traced_run_reads_every_per_layer_metric_it_can_on_the_cpu():
    from perfbench import harness

    cell = small_cell("tablev-fused.flash", steps=3)
    out = run_small(cell, batch=2, traced=True)
    line = harness.result_line(cell, out, True, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert {"host_enqueue_ms_per_step", "idle_share"} <= set(line["metrics"])
    # no device trace on the CPU: no share of a peak or a roofline
    assert not {"step_mfu", "fused_deliver_roofline"} & set(line["metrics"])
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card_and_agrees(name, cuda_device):
    import time

    from perfbench import harness

    cell = small_cell(name)
    out = harness.measure(cell, 2**31 + 17, 0.0, True, cuda_device, time.perf_counter(),
                          batch=64)
    assert out["correct"], out["lines"]
    line = harness.result_line(cell, out, True, {"platform": "gpu", "kind": "", "count": 1})
    assert line["device"]["busy_s"] > 0
