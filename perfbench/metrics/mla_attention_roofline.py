"""Percent of its roofline the ``mla_attention`` kernel reaches: the least
time of a prefill batch's causal attention, its bytes and operations at the
cell's shapes (``reference/counts_mla_attention.py``, at the H100's bfloat16
peaks), over the kernel's device time a batch in the traced window; nothing
where the program runs no such kernel."""

from perfbench.readings import kernel
from perfbench.reference import counts_mla_attention
from perfbench.reference.peaks_bf16 import least_seconds


def read(record: dict) -> float | None:
    trace = record["trace"]
    if "by_name" not in trace:  # a trace that kept no device operations by name
        return None
    secs, calls = kernel(trace, "mla_attention")
    if calls == 0:
        return None
    t = counts_mla_attention.terms(record["shape"])
    least, _ = least_seconds(sum(t["bytes"].values()), sum(t["ops"].values()))
    return 100.0 * least / (secs / len(trace["indices"]))
