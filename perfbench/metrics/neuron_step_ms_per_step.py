"""Device milliseconds of the ``neuron_step`` kernel per engine step, from
the traced window; nothing where the program runs no such kernel (the
eager neuron step)."""

from perfbench.readings import kernel, traced_steps


def read(record: dict) -> float | None:
    trace = record["trace"]
    secs, calls = kernel(trace, "neuron_step")
    return None if calls == 0 else 1e3 * secs / traced_steps(trace)
