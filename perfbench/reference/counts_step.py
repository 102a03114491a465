"""Bytes and operations one engine step of a batch needs, whatever
implements it: the least work behind ``step_mfu``.

Neuron state (``v``, ``w``, ``refrac`` and four DPI currents), the step's
tag activity and the spikes are each read once and written once; the
routing tables are read once per step; on a board, the delay ring is read
once and written once. Operations: the AdExp/DPI update of every neuron,
and the delivery's adds (one per SRAM entry of a routed event, one per
activity cell, one per CAM word per stream).
"""

from __future__ import annotations

STATE_FLOATS = 3 + 4  # v, w, refrac and the four DPI currents
# float operations of one neuron's exponential-Euler step: the DPI decay and
# injection (12), the synaptic sums (5), the clipped exponential (6), the
# membrane and adaptation updates (15), the refractory and spike logic (12)
NEURON_OPS = 50


def terms(shape: dict, per_call: dict) -> dict[str, dict[str, float]]:
    """``shape`` as for the delivery kernels (``ring_slots`` 0 off a board);
    ``per_call``: ``entries`` routed in one step."""
    b, n = shape["batch"], shape["neurons"]
    cells = b * shape["clusters"] * shape["k_tags"]
    return {
        "bytes": {
            "state": 2 * 4 * STATE_FLOATS * b * n,
            "activity": 2 * 4 * cells,
            "spikes": 2 * 4 * b * n,
            "tables": 2 * 4 * n * (shape["sram_entries"] + shape["cam_words"]),
            "ring": 2 * 4 * cells * shape["ring_slots"],
        },
        "ops": {
            "neuron": NEURON_OPS * b * n,
            "delivery_adds": per_call["entries"] + cells + b * shape["cam_words_used"],
        },
    }
