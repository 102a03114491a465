"""Device operations in the traced window per prefill batch, the token
drawing, the cache's set-up and the readout included."""


def read(record: dict) -> float:
    trace = record["trace"]
    return trace["ops"] / len(trace["indices"])
