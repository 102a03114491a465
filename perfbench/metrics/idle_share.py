"""Percent of the traced window in which no operation ran on the device."""


def read(record: dict) -> float:
    trace = record["trace"]
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
