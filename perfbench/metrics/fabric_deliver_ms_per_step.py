"""Device milliseconds of the ``fabric_deliver`` kernel per engine step, from
the traced window; nothing where the cell does not launch it."""

from perfbench.readings import kernel, traced_steps


def read(record: dict) -> float | None:
    trace = record["trace"]
    secs, calls = kernel(trace, "fabric_deliver")
    return None if calls == 0 else 1e3 * secs / traced_steps(trace)
