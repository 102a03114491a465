"""Bytes and operations of the routed experts' FFN in a MoE prefill,
whatever implements it: the least work behind ``expert_ffn_roofline``.

Each assigned row (a token's choice of an expert) goes through its
expert's gated FFN: ``6 * d * f`` operations (the gate, up and down
products, two a multiply-add). Each expert's three weights are read once a
layer, each row read once and its output written once, in bfloat16. The
elementwise gate is left out of the operations (``3 * f`` a row, under
0.2%)."""

from __future__ import annotations

BYTES = 2  # bfloat16


def terms(shape: dict, work: dict) -> dict[str, dict[str, float]]:
    """``shape``: ``d_model``, ``moe_d_ff``, ``n_experts``, ``moe_layers``;
    ``work``: the traced batches' ``prefills`` and ``expert_rows`` (every
    MoE layer's assignments, summed)."""
    d, f = shape["d_model"], shape["moe_d_ff"]
    rows, prefills = work["expert_rows"], work["prefills"]
    weights = shape["moe_layers"] * shape["n_experts"] * 3 * d * f * BYTES
    return {
        "bytes": {"weights": weights * prefills, "rows": 2 * rows * d * BYTES},
        "ops": {"gated_ffn": 6 * d * f * rows},
    }
