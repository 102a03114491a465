"""The program's spans in a traced window: the device time each launched,
and the labels of the idle gaps that open inside them.

The port opens profiler spans named ``repro_torch.*`` inside its engine
step (``repro_torch/core/tracing.py``). Each device operation is charged
to the CUDA call that launched it, which the profiler's correlation gives:
a device event's ``id`` is the correlation id of its runtime call
(``cudaLaunchKernel``, ``cudaLaunchKernelExC``, ``cudaMemcpyAsync``, a
host event of the same ``id``), whether a PyTorch operation made the call or
one of the port's own kernels was launched directly. It is then charged to
every program span open on that host thread when the call began. The
profiler's device-side mirrors of host spans are not operations and are
skipped, as ``perfbench/trace.py`` skips them.

:func:`split` turns the charges into milliseconds a step: the neuron step,
the delivery's glue (the delivery less its kernel), the AER queue, and
what ran outside both the neuron step and the delivery. :func:`profiled`
runs batches under the profiler as ``perfbench/trace.py`` does and keeps
the events, which that module reads and lets go.
"""

from __future__ import annotations

import bisect

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from perfbench.readings import kernel

PROGRAM = "repro_torch."
# the CUDA runtime and driver calls that launch device work; PyTorch numbers
# its own operations apart, so only these share ids with device events
RUNTIME = "cu"
# the delivery kernels, as perfbench/metrics/other_device_ms_per_step.py names them
DELIVERY_KERNELS = ("fused_deliver", "fabric_deliver", "cam_match")
_CPU = torch.autograd.DeviceType.CPU
_CUDA = torch.autograd.DeviceType.CUDA


def _host(events) -> list:
    return [e for e in events if e.device_type == _CPU]


def _program_spans(events) -> list:
    return sorted((e for e in _host(events) if e.name.startswith(PROGRAM)),
                  key=lambda e: (e.thread, e.time_range.start, -e.time_range.end))


def _self_seconds(spans) -> list[float]:
    """Each span's duration less its direct child spans' (``spans`` sorted
    by thread, start, and longest first)."""
    own = [(s.time_range.end - s.time_range.start) * 1e-6 for s in spans]
    stack: list[int] = []
    for i, s in enumerate(spans):
        while stack and (spans[stack[-1]].thread != s.thread
                         or spans[stack[-1]].time_range.end <= s.time_range.start):
            stack.pop()
        if stack:
            own[stack[-1]] -= (s.time_range.end - s.time_range.start) * 1e-6
        stack.append(i)
    return own


def _open_at(spans):
    """``open_at(thread, t)``: the names of the spans open at ``t`` on
    ``thread``. Spans of one name never nest in themselves, so on a thread
    the one that began last before ``t`` is the only candidate."""
    starts: dict[tuple, list[float]] = {}
    ends: dict[tuple, list[float]] = {}
    for s in spans:  # sorted by thread and start
        starts.setdefault((s.thread, s.name), []).append(s.time_range.start)
        ends.setdefault((s.thread, s.name), []).append(s.time_range.end)

    def open_at(thread, t):
        names = []
        for key, first in starts.items():
            if key[0] != thread:
                continue
            i = bisect.bisect_right(first, t) - 1
            if i >= 0 and t < ends[key][i]:
                names.append(key[1])
        return names

    return open_at


def read(events, w0: float, w1: float) -> dict[str, dict]:
    """For each program span seen in the window ``[w0, w1)`` (profiler
    microseconds): the device seconds it launched (``device_s``) and by
    operation name (``by_name``), its calls, and its host self seconds."""
    host = _host(events)
    names = {e.name for e in host}
    launches = {e.id: e for e in host if e.name.startswith(RUNTIME)}
    spans = _program_spans(events)
    open_at = _open_at(spans)
    out: dict[str, dict] = {}

    def entry(name):
        return out.setdefault(name, {"device_s": 0.0, "by_name": {}, "calls": 0,
                                     "host_self_s": 0.0})

    for s, own in zip(spans, _self_seconds(spans)):
        if w0 <= s.time_range.start < w1:
            e = entry(s.name)
            e["calls"] += 1
            e["host_self_s"] += own
    for op in events:
        if op.device_type != _CUDA or op.name in names:
            continue
        a, b = max(op.time_range.start, w0), min(op.time_range.end, w1)
        launch = launches.get(op.id)
        if b <= a or launch is None:
            continue
        for name in open_at(launch.thread, launch.time_range.start):
            e = entry(name)
            e["device_s"] += (b - a) * 1e-6
            e["by_name"][op.name] = e["by_name"].get(op.name, 0.0) + (b - a) * 1e-6
    return out


def label(events, at: float) -> str:
    """The harness span, the innermost program span and the innermost
    other host operation open at ``at`` (us), as ``perfbench/trace.py``
    labels a gap with the program span put between the first and the last."""
    harness, program, inner = None, None, None
    for e in _host(events):
        if not e.time_range.start <= at < e.time_range.end:
            continue
        dur = e.time_range.end - e.time_range.start
        if e.name.startswith("perfbench.") and e.name != "perfbench.batch":
            harness = e.name
        elif e.name.startswith(PROGRAM):
            if program is None or dur < program[1]:
                program = (e.name, dur)
        elif (not e.name.startswith(("perfbench.", "ProfilerStep"))
              and (inner is None or dur < inner[1])):
            inner = (e.name, dur)
    parts = [p for p in (harness, program and program[0], inner and inner[0]) if p]
    return " > ".join(parts) or "between batches"


def split(spans: dict[str, dict], trace: dict, steps: float) -> dict[str, float | None]:
    """Milliseconds a step of ``spans`` (:func:`read`) over ``steps`` engine
    steps of the traced window ``trace`` (``perfbench/trace.py``'s figures):
    the neuron step, the delivery's glue, the queue, the device time other
    than the delivery kernels (``other_device_ms_per_step``'s reading) and,
    of it, what the neuron step and the delivery's glue leave (input
    building, readout, stacking). ``None`` where a span launched nothing."""

    def ms(name, less=()):
        e = spans.get(name)
        if e is None or e["device_s"] == 0:
            return None
        kernels = sum(v for k, v in e["by_name"].items() if any(n in k for n in less))
        return 1e3 * (e["device_s"] - kernels) / steps

    delivery = sum(kernel(trace, name)[0] for name in DELIVERY_KERNELS)
    out = {
        "neuron_ms_per_step": ms(PROGRAM + "neuron"),
        "delivery_glue_ms_per_step": ms(PROGRAM + "deliver", DELIVERY_KERNELS),
        "queue_ms_per_step": ms(PROGRAM + "deliver.queue"),
        "other_device_ms_per_step": 1e3 * (trace["busy_s"] - delivery) / steps,
    }
    inside = [out["neuron_ms_per_step"], out["delivery_glue_ms_per_step"]]
    out["outside_ms_per_step"] = (None if None in inside
                                  else out["other_device_ms_per_step"] - sum(inside))
    return out


def profiled(system, seed: int, first_index: int, n_batches: int) -> dict:
    """``n_batches`` batches of ``system`` (after one that warms the
    profiler up) under the profiler, as ``perfbench/trace.py`` runs them:
    the events, the window from the first kept batch's start to the last
    one's end (us), and the kept batches (their host clocks)."""
    sched = schedule(wait=0, warmup=1, active=n_batches, repeat=1)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    kept = []
    with profile(activities=activities, schedule=sched) as prof:
        for i in range(n_batches + 1):
            with record_function("perfbench.batch"):
                b = system.run_batch(seed, first_index + i)
            if i > 0:
                kept.append(b)
            prof.step()
    events = prof.events()
    batches = [e for e in _host(events) if e.name == "perfbench.batch"]
    return {"events": events, "w0": min(e.time_range.start for e in batches),
            "w1": max(e.time_range.end for e in batches), "batches": kept}
