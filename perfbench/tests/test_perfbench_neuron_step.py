"""The neuron kernel's readers: its bytes and operations at the cells'
shapes, and what the two metrics read from a traced window."""

import pytest
from conftest import CELLS, ROOT

from perfbench import harness
from perfbench.reference import counts_neuron_step
from perfbench.reference.counts_step import NEURON_OPS

KERNEL = "void (anonymous namespace)::neuron_step_kernel(float const*, ...)"


def _metric(name):
    return harness.Cell(ROOT, CELLS[0]).reader(name)


@pytest.mark.parametrize("name", CELLS)
def test_bytes_and_operations_at_the_cells_shapes(name):
    cell = harness.Cell(ROOT, name)
    shape = cell.driver().System(cell.config, cell.mix, cell.spec, "cpu").shape()
    assert (shape["batch"], shape["neurons"]) == (8192, 1536)
    t = counts_neuron_step.terms(shape, {})
    # state 56 B, drive 16 B and spikes 4 B a neuron: 0.956 GB a step
    assert sum(t["bytes"].values()) == 76 * 8192 * 1536 == 956_301_312
    assert sum(t["ops"].values()) == NEURON_OPS * 8192 * 1536


def test_an_external_current_adds_its_read():
    base = {"batch": 3, "neurons": 5}
    plain = sum(counts_neuron_step.terms(base, {})["bytes"].values())
    with_ext = sum(counts_neuron_step.terms(dict(base, i_ext=True), {})["bytes"].values())
    assert with_ext - plain == 4 * 3 * 5


def _record(by_name: dict, calls: dict, steps: float = 30.0) -> dict:
    trace = {"by_name": by_name, "calls": calls, "busy_s": 1.0,
             "work": {"steps": steps, "events": 0.0, "entries": 0.0}}
    return {"trace": trace, "shape": {"batch": 8192, "neurons": 1536}}


def test_the_readers_read_the_kernel_by_name():
    least = 956_301_312 / 3.35e12
    record = _record({KERNEL: 30 * least / 0.9, "void at::native::vectorized_elementwise_kernel": 1.0},
                     {KERNEL: 30, "void at::native::vectorized_elementwise_kernel": 900})
    assert _metric("neuron_step_ms_per_step").read(record) == pytest.approx(1e3 * least / 0.9)
    assert _metric("neuron_step_roofline").read(record) == pytest.approx(90.0)


def test_the_readers_read_nothing_without_the_kernel():
    """The eager neuron step launches no kernel of that name: both metrics
    fall silent rather than raise."""
    record = _record({"void at::native::vectorized_elementwise_kernel": 1.0},
                     {"void at::native::vectorized_elementwise_kernel": 900})
    assert _metric("neuron_step_ms_per_step").read(record) is None
    assert _metric("neuron_step_roofline").read(record) is None

