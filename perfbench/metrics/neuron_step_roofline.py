"""Percent of its roofline a ``neuron_step`` kernel call reaches: the least
time of the bytes and operations one neuron step needs at the cell's shapes
(``reference/counts_neuron_step.py``, at the H100's peaks), over its device
time per call; nothing where the program runs no such kernel."""

from perfbench.readings import roofline
from perfbench.reference import counts_neuron_step


def read(record: dict) -> float | None:
    return roofline(record, "neuron_step", counts_neuron_step)
