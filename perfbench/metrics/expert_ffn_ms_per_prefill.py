"""Device milliseconds a prefill batch launches inside the program's span
``repro_torch.moe.experts`` (every MoE layer's routed experts' gated FFN);
nothing where the program opens no such span or no device operation ran."""


def read(record: dict) -> float | None:
    work = record["trace"]["work"]
    secs = work.get("expert_ffn_s", 0.0)
    return 1e3 * secs / work["prefills"] if secs > 0 else None
