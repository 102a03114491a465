"""Device operations in the traced window per engine step, the input
building and the readout included."""

from perfbench.readings import traced_steps


def read(record: dict) -> float:
    trace = record["trace"]
    return trace["ops"] / traced_steps(trace)
