"""Percent of the chip's peak the whole step reaches: the least time of one
step's bytes and operations at the cell's shapes and traced fill
(``reference/counts_step.py``, at the H100's peaks), over the device's busy
time per step in the traced window (the inputs' and the readout's device
work included, the idle gaps left out: ``idle_share`` reads those);
nothing where no operation ran on the device."""

from perfbench.readings import per_step, traced_steps
from perfbench.reference import counts_step
from perfbench.reference.peaks import least_seconds


def read(record: dict) -> float | None:
    trace = record["trace"]
    if trace["busy_s"] <= 0:
        return None
    t = counts_step.terms(record["shape"], per_step(trace))
    least, _ = least_seconds(sum(t["bytes"].values()), sum(t["ops"].values()))
    return 100.0 * least / (trace["busy_s"] / traced_steps(trace))
