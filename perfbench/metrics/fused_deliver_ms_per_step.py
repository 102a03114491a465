"""Device milliseconds of the ``fused_deliver`` kernel per engine step, from
the traced window; nothing where the cell does not launch it."""

from perfbench.readings import kernel, traced_steps


def read(record: dict) -> float | None:
    trace = record["trace"]
    secs, calls = kernel(trace, "fused_deliver")
    return None if calls == 0 else 1e3 * secs / traced_steps(trace)
