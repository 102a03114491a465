#!/usr/bin/env python3
"""Split a benchmark cell's engine step by the program's profiler spans, on
one NVIDIA GPU.

For each ``--workload`` (a cell of ``BENCHMARK.json``), at the cell's batch:
set-up and one warm batch, ``--untraced`` batches on the host clock, then
``--batches`` batches (after one that warms the profiler up) under
torch.profiler, as ``perfbench/run.py --trace 1`` traces them. From the
trace: the device busy time, operations and the delivery kernel a step
(``perfbench/trace.py``'s figures), the device time each ``repro_torch.*``
span launched and its host self time (``perfbench/spans.py``), the split of
``other_device_ms_per_step`` into the neuron step, the delivery's glue, the
queue and the rest, the ten longest idle gaps labelled with the program
span open when each began, the ten longest that opened inside the engine
(``EventEngine.run``) and the idle time a step in all and inside it, and the host enqueue ms a step (host clock
around ``EventEngine.run``) of the untraced and the traced batches.
``--src`` names the ``src`` directory whose ``repro_torch`` is traced
(default: this checkout's), so that two checkouts can be traced in turns
on one card. Prints one JSON line per cell and writes them all to ``--out``:

    python3 scripts/trace_spans.py --workload tablev-fused.flash --seed 2147483659 \\
        [--src path/to/src] [--batches 3] [--untraced 8] [--out chiprun_out/spans.json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def card() -> str:
    done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    return done.stdout.strip()


def engine_gaps(events, w0: float, w1: float) -> list[tuple[float, float]]:
    """The device's idle gaps in ``[w0, w1)`` (us) that open while the host
    is inside ``EventEngine.run``, longest first."""
    import torch

    from perfbench import trace as tracing

    merged: list[list[float]] = []
    for a, b, _ in tracing._device_intervals(events):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    runs = [(e.time_range.start, e.time_range.end) for e in events
            if e.name == "repro_torch.run" and e.device_type == torch.autograd.DeviceType.CPU]
    gaps = [(x[1], y[0]) for x, y in zip(merged, merged[1:])]
    inside = [g for g in gaps if any(r0 <= g[0] < r1 for r0, r1 in runs)]
    return sorted(inside, key=lambda g: g[0] - g[1])


def trace_cell(name: str, seed: int, batches: int, untraced: int, device,
               batch: int | None = None) -> dict:
    """The figures of one cell on ``device``, at ``batch`` streams (default:
    the cell's)."""
    import torch

    from perfbench import harness, spans
    from perfbench import trace as tracing

    cell = harness.Cell(ROOT, name)
    system = cell.driver().System(cell.config, cell.mix, cell.spec, device, batch=batch)
    system.build()
    system.warm_up(seed)
    steps = system.steps
    plain = [system.run_batch(seed, i).enqueue_s for i in range(untraced)]
    traced = spans.profiled(system, seed, untraced, batches)
    events = traced["events"]
    # the breakdown as perfbench/trace.py makes it, its gaps labelled with
    # the program span open at each one's start
    with mock.patch.object(tracing, "_host_label", spans.label):
        figures = tracing.read(events)
    engine = engine_gaps(events, traced["w0"], traced["w1"])
    by_span = spans.read(events, traced["w0"], traced["w1"])
    n = batches * steps
    top = {k: dict(sorted(v["by_name"].items(), key=lambda kv: -kv[1])[:6])
           for k, v in by_span.items()}
    return {
        "workload": name, "seed": seed, "batch": system.batch,
        "torch": torch.__version__, "src": str(sys.path[1]), "traced_steps": n,
        "busy_ms_per_step": 1e3 * figures["busy_s"] / n,
        "window_ms_per_step": 1e3 * figures["window_s"] / n,
        "device_ops_per_step": figures["ops"] / n,
        "delivery_kernel_ms_per_step": {
            k: 1e3 * v / n for k, v in figures["by_name"].items()
            if any(d in k for d in spans.DELIVERY_KERNELS)},
        "split_ms_per_step": spans.split(by_span, figures, n),
        "span_device_ms_per_step": {k: 1e3 * v["device_s"] / n for k, v in by_span.items()},
        "span_host_self_ms_per_step": {k: 1e3 * v["host_self_s"] / n for k, v in by_span.items()},
        "span_calls": {k: v["calls"] for k, v in by_span.items()},
        "span_top_device_ms_per_step": {k: {op[:90]: 1e3 * s / n for op, s in v.items()}
                                        for k, v in top.items()},
        "host_enqueue_ms_per_step": {
            "untraced": 1e3 * statistics.median(plain) / steps,
            "traced": 1e3 * statistics.median(b.enqueue_s for b in traced["batches"]) / steps},
        "idle_gaps": figures["breakdown"]["idle_gaps"],
        "engine_idle_gaps": [[spans.label(events, a), (b - a) * 1e-6] for a, b in engine[:10]],
        "engine_idle_ms_per_step": 1e3 * sum(b - a for a, b in engine) * 1e-6 / n,
        "idle_ms_per_step": 1e3 * (figures["window_s"] - figures["busy_s"]) / n,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--untraced", type=int, default=8)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
    sys.path[0:1] = [str(ROOT), str(args.src.resolve())]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_spans: needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    lines = []
    for name in args.workload:
        line = trace_cell(name, args.seed, args.batches, args.untraced, device)
        lines.append(dict(line, card=card()))
        print(json.dumps(lines[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(line) + "\n" for line in lines))


if __name__ == "__main__":
    main()
