"""The traced window: a few batches under ``torch.profiler``, read into the
device's busy time, its operations by name and its idle gaps.

The profiler's first step only warms it up; the batches after it are kept.
Busy time is the union of the device operations' intervals inside the
window, which runs from the first kept batch's hand-over to the last one's
answers. A gap between device operations is labelled with what the host
was doing when it began: the harness's span (``perfbench.*``) and the
innermost operation inside it.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

TOP = 10


def _device_intervals(events) -> list[tuple[float, float, str]]:
    """The device's kernels, copies and fills. The profiler mirrors each host
    span (``record_function``, ``ProfilerStep``) onto the device's timeline
    under the same name; those ranges are not operations."""
    host_names = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in host_names
    )


def _host_label(events, at: float) -> str:
    """The harness span and innermost host operation open at ``at`` (us)."""
    span, inner = None, None
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if not e.time_range.start <= at < e.time_range.end:
            continue
        dur = e.time_range.end - e.time_range.start
        if e.name.startswith("perfbench.") and e.name != "perfbench.batch":
            span = e.name
        elif (not e.name.startswith(("perfbench.", "ProfilerStep"))
              and (inner is None or dur < inner[1])):
            inner = (e.name, dur)
    parts = [p for p in (span, inner and inner[0]) if p]
    return " > ".join(parts) or "between batches"


def read(events) -> dict:
    """Busy seconds, window seconds, device operations, and the breakdown."""
    batches = [e for e in events if e.name == "perfbench.batch"
               and e.device_type == torch.autograd.DeviceType.CPU]
    w0 = min(e.time_range.start for e in batches)
    w1 = max(e.time_range.end for e in batches)
    ops = [(max(a, w0), min(b, w1), n) for a, b, n in _device_intervals(events) if b > w0 and a < w1]
    by_name: dict[str, float] = {}
    calls: dict[str, int] = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        calls[n] = calls.get(n, 0) + 1
    merged: list[list[float]] = []
    for a, b, _ in ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0, *(x for ab in merged for x in ab), w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "busy_s": busy * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "ops": len(ops),
        "by_name": by_name,
        "calls": calls,
        "breakdown": {
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": [[_host_label(events, a), (b - a) * 1e-6] for a, b in longest],
        },
    }


def trace(system, seed: int, first_index: int, n_batches: int) -> dict:
    """Run ``n_batches`` batches (after one that warms the profiler up)
    under the profiler; returns :func:`read`'s figures and the traced
    batches' indices."""
    kept = []
    sched = schedule(wait=0, warmup=1, active=n_batches, repeat=1)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, schedule=sched) as prof:
        for i in range(n_batches + 1):
            with record_function("perfbench.batch"):
                system.run_batch(seed, first_index + i)
            if i > 0:
                kept.append(first_index + i)
            prof.step()
    out = read(prof.events())
    out["indices"] = kept
    return out
