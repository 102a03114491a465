"""Percent of its roofline the routed experts' FFN reaches: the least time
of its bytes and operations over the traced batches' assignments
(``reference/counts_moe_experts.py``, at the H100's bfloat16 peaks), over the
device time launched inside ``repro_torch.moe.experts``; nothing where the
program opens no such span or no device operation ran."""

from perfbench.reference import counts_moe_experts
from perfbench.reference.peaks_bf16 import least_seconds


def read(record: dict) -> float | None:
    work = record["trace"]["work"]
    secs = work.get("expert_ffn_s", 0.0)
    if secs <= 0:
        return None
    t = counts_moe_experts.terms(record["shape"], work)
    least, _ = least_seconds(sum(t["bytes"].values()), sum(t["ops"].values()))
    return 100.0 * least / secs
