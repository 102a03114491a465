"""The 90th percentile over the window's batches of the time from handing a
batch over to having its answers on the host."""

import statistics


def read(record: dict) -> float | None:
    lat = [b.latency_s * 1e3 for b in record["batches"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
