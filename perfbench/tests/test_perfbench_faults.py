"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and each fault a cell can have, planted
in the program underneath a whole run on the CPU."""

import dataclasses

import pytest
import torch
from conftest import CELLS, run_small, small_cell

from perfbench.reference.compare import numbers, verdict

B = 4


def _state_unchanged(monkeypatch):
    from repro_torch.core import neuron

    monkeypatch.setattr(neuron, "neuron_step",
                        lambda state, drive, params, i_ext=None: (state, torch.zeros_like(state.v)))


def _half_batch(monkeypatch):
    from repro_torch.core.event_engine import EventEngine

    run = EventEngine.run

    def half(self, carry, inputs, i_ext=None):
        h = inputs.shape[1] // 2
        state, *rest = carry
        cut = dataclasses.replace(state, **{f.name: getattr(state, f.name)[:h]
                                            for f in dataclasses.fields(state)})
        kept, (spikes, stats) = run(self, (cut, *(t[:h] if t.ndim else t for t in rest)),
                                    inputs[:, :h])
        return _pad(carry, kept, spikes, stats, h)

    monkeypatch.setattr(EventEngine, "run", half)


def _pad(full, kept, spikes, stats, h):
    """The left-out half of the batch comes back silent and at rest."""
    state = dataclasses.replace(full[0], **{
        f.name: torch.cat([getattr(kept[0], f.name), getattr(full[0], f.name)[h:]])
        for f in dataclasses.fields(full[0])})
    spikes = torch.cat([spikes, torch.zeros_like(spikes)], 1)
    stats = dataclasses.replace(stats, **{
        f.name: torch.cat([getattr(stats, f.name), torch.zeros_like(getattr(stats, f.name))], 1)
        for f in dataclasses.fields(stats) if getattr(stats, f.name) is not None})
    return (state, *full[1:]), (spikes, stats)


def _no_chip_exchange(monkeypatch):
    from repro_torch.kernels.fabric_deliver import ops

    ring = ops.fabric_deliver_ring

    def local_only(spikes, entries, *args, **kwargs):
        entries = dataclasses.replace(entries, valid=entries.valid & ~entries.cross)
        return ring(spikes, entries, *args, **kwargs)

    monkeypatch.setattr(ops, "fabric_deliver_ring", local_only)


def _answer_altered(monkeypatch):
    from repro_torch.core.event_engine import EventEngine

    run = EventEngine.run

    def altered(self, carry, inputs, i_ext=None):
        carry, (spikes, stats) = run(self, carry, inputs, i_ext)
        spikes = spikes.clone()
        spikes[-1, 0, -256:] = 1.0 - spikes[-1, 0, -256:]  # stream 0's output, last step
        return carry, (spikes, stats)

    monkeypatch.setattr(EventEngine, "run", altered)


FAULTS = {
    "state_unchanged": (_state_unchanged, CELLS),
    "half_batch_left_out": (_half_batch, CELLS),
    "chip_exchange_left_out": (_no_chip_exchange, [c for c in CELLS if "fabric" in c]),
    "answer_altered": (_answer_altered, CELLS),
}


@pytest.mark.parametrize("fault,name", [(f, c) for f, (_, cells) in FAULTS.items()
                                        for c in cells])
def test_planted_fault_makes_the_run_not_correct(fault, name, monkeypatch):
    FAULTS[fault][0](monkeypatch)
    out = run_small(small_cell(name), batch=B)
    assert not out["correct"], out["lines"]


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_is_not_correct(name):
    cell = small_cell(name)
    driver = cell.driver()
    system = driver.System(cell.config, cell.mix, cell.spec, "cpu", batch=B)
    seed = 2**31 + 5
    picks = driver.checked_batches(seed, cell.spec)
    control = system.reference_answers(seed, picks, torch.bfloat16)
    values, _ = system.check(seed, control)
    ok, lines = verdict(values, cell.spec["limits"])
    assert not ok, lines


def test_sound_answers_read_zero():
    """The reference held to itself reads nought on every number."""
    cell = small_cell("tablev-fabric.flash")
    driver = cell.driver()
    system = driver.System(cell.config, cell.mix, cell.spec, "cpu", batch=B)
    answers = system.reference_answers(5, [0], torch.float32)
    net = system.reference_network()
    values, differ = numbers(list(answers.values()), [system.reference(5, 0, net)], True)
    assert differ == 0 and all(v == 0 for v in values.values())
