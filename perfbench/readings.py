"""What the per-layer metrics' readers share: a kernel's device time and
calls in the traced window, the traced work per step, and the shapes the
byte and operation counts take."""

from __future__ import annotations


def kernel(trace: dict, name: str) -> tuple[float, int]:
    """Device seconds and launches of the operations whose name holds ``name``."""
    secs = sum(v for k, v in trace["by_name"].items() if name in k)
    calls = sum(v for k, v in trace["calls"].items() if name in k)
    return secs, calls


def traced_steps(trace: dict) -> float:
    return trace["work"]["steps"]


def per_step(trace: dict) -> dict[str, float]:
    """Events and SRAM entries routed per step, over the traced batches."""
    work = trace["work"]
    return {k: work[k] / work["steps"] for k in ("events", "entries")}


def roofline(record: dict, name: str, counts) -> float | None:
    """Percent of its roofline that kernel ``name`` reaches in the traced
    window, by the byte and operation ``counts`` module at the cell's shapes."""
    from perfbench.reference.peaks import least_seconds

    trace = record["trace"]
    secs, calls = kernel(trace, name)
    if calls == 0:
        return None
    t = counts.terms(record["shape"], per_step(trace))
    least, _ = least_seconds(sum(t["bytes"].values()), sum(t["ops"].values()))
    return 100.0 * least / (secs / calls)
