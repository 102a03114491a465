"""The busiest expert's assignments over the mean expert's, averaged over
the MoE layers and the traced batches: the imbalance a dropless dispatch
absorbs (1 is even), from the program's per-layer expert loads."""


def read(record: dict) -> float | None:
    work = record["trace"]["work"]
    if "load_max_over_mean" not in work:
        return None
    return work["load_max_over_mean"] / work["prefills"]
