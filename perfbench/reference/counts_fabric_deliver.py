"""Bytes and operations one ``fabric_deliver`` call needs: the time-wheel
ring update, the pop of the arrival slot with the external activity, and
the CAM match, at a cell's shapes and its traced fill.

Each input byte is counted once and each output byte once. The ring comes
in whole and goes out whole (the call writes a new ring). The per-entry
weights are one dense row per stream, which the call reads whole: an
entry's weight is what says whether it carries an event. Operations are
adds: one per entry carrying an event, one per arrival cell (the slot plus
the external activity), one per CAM word per stream.
"""

from __future__ import annotations


def terms(shape: dict, per_call: dict) -> dict[str, dict[str, float]]:
    """``shape`` as for ``fused_deliver``, plus ``table_entries`` (the SRAM
    entries the network programs) and ``ring_slots``; ``per_call``:
    ``entries`` routed by one call."""
    b, n, m = shape["batch"], shape["neurons"], shape["table_entries"]
    cells = b * shape["clusters"] * shape["k_tags"]
    return {
        "bytes": {
            "entry_table": 4 * (3 * m + shape["clusters"] + 1),
            "entry_weights": 4 * b * m,
            "ring_read": 4 * cells * shape["ring_slots"],
            "ring_written": 4 * cells * shape["ring_slots"],
            "cursor": 4,
            "external_activity": 4 * cells,
            "cam_tables": 2 * 4 * n * shape["cam_words"],
            "drive_written": 4 * 4 * b * n,
        },
        "ops": {
            "ring_adds": per_call["entries"],
            "arrival_adds": cells,
            "cam_adds": b * shape["cam_words_used"],
        },
    }
