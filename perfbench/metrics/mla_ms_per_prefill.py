"""Device milliseconds a prefill batch launches inside the program's span
``repro_torch.mla`` (the latent attention of every layer: projections,
rope, the decompressed keys and values, attention, the output projection),
from the traced batches rerun under the profiler; nothing where the
program opens no such span or no device operation ran."""


def read(record: dict) -> float | None:
    work = record["trace"]["work"]
    secs = work.get("mla_s", 0.0)
    return 1e3 * secs / work["prefills"] if secs > 0 else None
