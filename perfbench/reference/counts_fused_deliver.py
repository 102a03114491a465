"""Bytes and operations one ``fused_deliver`` call needs: the stage-1 scatter
of one step's AER queue and the stage-2 CAM match, at a cell's shapes and
its traced queue fill.

Each input byte is counted once and each output byte once. Of the queue,
only the live slots count (a source id and a weight each); the padding
after them is not needed. Operations are adds: one per SRAM entry of a
queued event, one per external activity cell, one per CAM word per stream.
"""

from __future__ import annotations


def terms(shape: dict, per_call: dict) -> dict[str, dict[str, float]]:
    """``shape``: ``batch``, ``neurons``, ``clusters``, ``k_tags``,
    ``sram_entries`` and ``cam_words`` per neuron, ``cam_words_used``;
    ``per_call``: ``events`` and ``entries`` routed by one call."""
    b, n = shape["batch"], shape["neurons"]
    cells = b * shape["clusters"] * shape["k_tags"]
    return {
        "bytes": {
            "queue_live_slots": 8 * per_call["events"],
            "sram_tables": 2 * 4 * n * shape["sram_entries"],
            "external_activity": 4 * cells,
            "cam_tables": 2 * 4 * n * shape["cam_words"],
            "drive_written": 4 * 4 * b * n,
        },
        "ops": {
            "stage1_adds": per_call["entries"],
            "external_adds": cells,
            "cam_adds": b * shape["cam_words_used"],
        },
    }
