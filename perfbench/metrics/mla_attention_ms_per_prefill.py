"""Device milliseconds of the ``mla_attention`` kernel (the latent
attention's causal attention, one launch a layer) per prefill batch, from
the traced window; nothing where the program runs no such kernel (the plain
``attention_core``)."""

from perfbench.readings import kernel


def read(record: dict) -> float | None:
    trace = record["trace"]
    if "by_name" not in trace:  # a trace that kept no device operations by name
        return None
    secs, calls = kernel(trace, "mla_attention")
    return None if calls == 0 else 1e3 * secs / len(trace["indices"])
