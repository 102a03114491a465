"""``perfbench/spans.py``: device time charged to the program's spans by the
profiler's correlation, the spans' calls and host self time, and the idle
gaps' labels; on synthetic events, then on a small cell's real trace."""

from types import SimpleNamespace

import pytest
import torch
from conftest import small_cell

from perfbench import spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _ev(name, start, end, device=CPU, id=0, thread=1):
    return SimpleNamespace(name=name, device_type=device, id=id, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


# one engine step on the host (us), and what it put on the device; a device
# event's id is its runtime call's
HOST = [
    _ev("perfbench.batch", 0, 120),
    _ev("perfbench.engine_run", 0, 100),
    _ev("repro_torch.run", 1, 99, id=1),
    _ev("repro_torch.step", 2, 50, id=2),
    _ev("repro_torch.deliver", 3, 20, id=3),
    _ev("repro_torch.deliver.queue", 4, 10, id=4),
    _ev("aten::cumsum", 5, 6, id=90),  # PyTorch's ids may equal a runtime call's
    _ev("cudaLaunchKernel", 5.2, 5.8, id=90),
    # the delivery kernel, launched by the port with no operation open
    _ev("cudaLaunchKernelExC", 12, 13, id=91),
    _ev("repro_torch.neuron", 21, 40, id=6),
    _ev("aten::add", 22, 23, id=7),
    _ev("cudaLaunchKernel", 22.1, 22.5, id=92),
    _ev("perfbench.readout", 100, 110),
    _ev("aten::sum", 101, 102, id=8),
    _ev("cudaLaunchKernel", 101.1, 101.5, id=93),
]
DEVICE = [
    _ev("cumsum_kernel", 10, 12, CUDA, id=90),
    _ev("repro_torch.deliver", 10, 15, CUDA, id=3),  # the device's mirror of the span
    _ev("fused_deliver_kernel", 13, 16, CUDA, id=91),
    _ev("add_kernel", 30, 35, CUDA, id=92),
    _ev("sum_kernel", 103, 104, CUDA, id=93),  # outside every program span
    _ev("unlaunched_kernel", 50, 51, CUDA, id=94),  # no runtime call seen: no span
]
EVENTS = HOST + DEVICE


def test_a_kernel_counts_to_every_program_span_open_at_its_launch():
    got = spans.read(EVENTS, 0, 120)
    us = {name: round(e["device_s"] * 1e6, 6) for name, e in got.items()}
    # add_kernel to the neuron step only; cumsum_kernel to the queue and the
    # delivery; the mirror to nothing; sum_kernel to no program span
    assert us == {"repro_torch.run": 10.0, "repro_torch.step": 10.0,
                  "repro_torch.deliver": 5.0, "repro_torch.deliver.queue": 2.0,
                  "repro_torch.neuron": 5.0}
    assert set(got["repro_torch.deliver"]["by_name"]) == {"cumsum_kernel", "fused_deliver_kernel"}
    assert set(got["repro_torch.neuron"]["by_name"]) == {"add_kernel"}


def test_calls_and_host_self_time():
    got = spans.read(EVENTS, 0, 120)
    assert {name: e["calls"] for name, e in got.items()} == dict.fromkeys(got, 1)
    self_us = {name: round(e["host_self_s"] * 1e6, 6) for name, e in got.items()}
    assert self_us == {"repro_torch.run": 98 - 48, "repro_torch.step": 48 - 17 - 19,
                       "repro_torch.deliver": 17 - 6, "repro_torch.deliver.queue": 6,
                       "repro_torch.neuron": 19}


def test_the_window_clips_device_time_and_counts_calls_that_start_in_it():
    got = spans.read(EVENTS, 11, 120)
    assert round(got["repro_torch.deliver.queue"]["device_s"] * 1e6, 6) == 1.0
    assert got["repro_torch.neuron"]["calls"] == 1 and got["repro_torch.step"]["calls"] == 0


def test_a_span_on_another_thread_takes_nothing():
    other = [_ev("repro_torch.neuron", 0, 120, id=50, thread=2)]
    got = spans.read(EVENTS + other, 0, 120)
    assert round(got["repro_torch.neuron"]["device_s"] * 1e6, 6) == 5.0


@pytest.mark.parametrize("at, want", [
    (45, "perfbench.engine_run > repro_torch.step"),
    (5.1, "perfbench.engine_run > repro_torch.deliver.queue > aten::cumsum"),
    (5.5, "perfbench.engine_run > repro_torch.deliver.queue > cudaLaunchKernel"),
    (60, "perfbench.engine_run > repro_torch.run"),
    (101.5, "perfbench.readout > aten::sum"),
    (115, "between batches"),
])
def test_a_gap_is_labelled_with_the_innermost_program_span(at, want):
    assert spans.label(EVENTS, at) == want


def test_split_per_step():
    got = spans.read(EVENTS, 0, 120)
    trace = {"busy_s": 15e-6, "by_name": {"fused_deliver_kernel": 3e-6},
             "calls": {"fused_deliver_kernel": 1}}
    ms = spans.split(got, trace, steps=1)
    assert ms == pytest.approx({"neuron_ms_per_step": 5e-3, "delivery_glue_ms_per_step": 2e-3,
                                "queue_ms_per_step": 2e-3, "other_device_ms_per_step": 12e-3,
                                "outside_ms_per_step": 5e-3})
    assert spans.split({}, trace, steps=1)["neuron_ms_per_step"] is None


def test_a_small_cell_shows_every_span_on_the_cpu():
    """The profiler's own events carry what :func:`spans.read` reads; on the
    CPU no device operation runs, so nothing is charged."""
    cell = small_cell("tablev-fabric.flash", steps=3)
    system = cell.driver().System(cell.config, cell.mix, cell.spec, "cpu", batch=2)
    system.build()
    traced = spans.profiled(system, 2**31 + 5, 0, 1)
    got = spans.read(traced["events"], traced["w0"], traced["w1"])
    assert {name: e["calls"] for name, e in got.items()} == {
        "repro_torch.run": 1, "repro_torch.step": 3, "repro_torch.deliver": 3,
        "repro_torch.deliver.queue": 3, "repro_torch.neuron": 3}
    assert all(e["device_s"] == 0 and e["host_self_s"] > 0 for e in got.values())
    assert len(traced["batches"]) == 1


@pytest.mark.cuda
def test_spans_split_the_step_on_the_card(cuda_device):
    """One cell on the card: the traced run reads every per-layer metric its
    cell lists, and the spans split ``other_device_ms_per_step`` into the
    neuron step, the delivery's glue and the queue, with no more left over
    than the input building, readout and stacking."""
    import time

    from perfbench import harness
    from perfbench import trace as tracing

    cell = small_cell("tablev-fused.flash")
    out = harness.measure(cell, 2**31 + 19, 0.0, True, cuda_device, time.perf_counter(),
                          batch=256)
    line = harness.result_line(cell, out, True, {"platform": "gpu", "kind": "", "count": 1})
    assert {m["name"] for m in cell.metrics("per_layer")} == set(line["metrics"])
    system = cell.driver().System(cell.config, cell.mix, cell.spec, cuda_device, batch=256)
    system.build()
    system.warm_up(7)
    traced = spans.profiled(system, 7, 0, 2)
    got = spans.read(traced["events"], traced["w0"], traced["w1"])
    figures = tracing.read(traced["events"])
    ms = spans.split(got, figures, steps=2 * system.steps)
    assert None not in ms.values(), ms
    assert 0 < ms["queue_ms_per_step"] <= ms["delivery_glue_ms_per_step"]
    inside = ms["neuron_ms_per_step"] + ms["delivery_glue_ms_per_step"]
    assert inside <= ms["other_device_ms_per_step"] + 1e-9
    assert got["repro_torch.deliver"]["by_name"], "the delivery kernel is charged to the delivery"
    assert any("fused_deliver" in k for k in got["repro_torch.deliver"]["by_name"])

