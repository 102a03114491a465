"""Seconds from the process's start to the window's: imports, the CUDA
context, building or loading the kernels, the tables, the engine, and one
whole batch at the cell's sizes."""


def read(record: dict) -> float:
    return record["setup_s"]
