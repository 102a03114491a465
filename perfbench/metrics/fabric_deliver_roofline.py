"""Percent of its roofline a ``fabric_deliver`` call reaches: the least time of
the bytes and operations it needs at the cell's shapes and traced fill
(``reference/counts_fabric_deliver.py``, at the H100's peaks), over its device
time per call; nothing where the cell does not launch it."""

from perfbench.readings import roofline
from perfbench.reference import counts_fabric_deliver


def read(record: dict) -> float | None:
    return roofline(record, "fabric_deliver", counts_fabric_deliver)
