"""Percent of the chip's bfloat16 peak a whole prefill batch reaches: the
least time of its bytes and operations at the cell's shapes
(``reference/counts_prefill.py``: the linear layers with the active experts,
causal attention and the last position's unembedding), over the device's
busy time a batch in the traced window (the idle gaps left out:
``idle_share`` would read those); nothing where no operation ran on the
device."""

from perfbench.reference import counts_prefill
from perfbench.reference.peaks_bf16 import least_seconds


def read(record: dict) -> float | None:
    trace = record["trace"]
    if trace["busy_s"] <= 0:
        return None
    t = counts_prefill.terms(record["shape"])
    least, _ = least_seconds(sum(t["bytes"].values()), sum(t["ops"].values()))
    return 100.0 * least / (trace["busy_s"] / len(trace["indices"]))
