"""Bytes and operations one neuron step needs, whatever implements it: the
AdExp/DPI update of every stream's neurons, at a cell's shapes.

Each input byte is counted once and each output byte once: the state (``v``,
``w``, ``refrac`` and the four DPI currents) read and written, the step's
drive ``[B, N, 4]`` read, the spikes written, and an external current read
only where the cell passes one (``shape["i_ext"]``; no cell does).
Operations: ``counts_step.NEURON_OPS`` a neuron.
"""

from __future__ import annotations

from perfbench.reference.counts_step import NEURON_OPS, STATE_FLOATS


def terms(shape: dict, per_call: dict) -> dict[str, dict[str, float]]:
    """``shape``: ``batch`` and ``neurons`` (and ``i_ext``, when true); the
    step's work does not depend on its events, so ``per_call`` is unused."""
    b, n = shape["batch"], shape["neurons"]
    return {
        "bytes": {
            "state": 2 * 4 * STATE_FLOATS * b * n,
            "drive": 4 * 4 * b * n,
            "spikes": 4 * b * n,
            "i_ext": 4 * b * n if shape.get("i_ext") else 0,
        },
        "ops": {"neuron": NEURON_OPS * b * n},
    }
