"""Stream-steps completed per second: batch x steps x batches completed,
over the whole window, input building and readout included."""


def read(record: dict) -> float:
    return record["batch"] * record["steps"] * len(record["batches"]) / record["window_s"]
