"""Percent of its roofline a ``fused_deliver`` call reaches: the least time of
the bytes and operations it needs at the cell's shapes and traced fill
(``reference/counts_fused_deliver.py``, at the H100's peaks), over its device
time per call; nothing where the cell does not launch it."""

from perfbench.readings import roofline
from perfbench.reference import counts_fused_deliver


def read(record: dict) -> float | None:
    return roofline(record, "fused_deliver", counts_fused_deliver)
