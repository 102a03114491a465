"""How a cell's step scales with the batch, on the card.

    python3 perfbench/sweep.py --workload NAME --batches 2048,4096,8192 --out FILE

For each batch size: the cell's system built at that size and warmed up,
then ``--repeats`` batches timed (host wall per batch, host enqueue per
step, device time per step between CUDA events around the run) and two
batches traced (the device's idle share). One JSON line per size. The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench import trace as tracing  # noqa: E402


def point(cell: harness.Cell, batch: int, repeats: int, device) -> dict:
    system = cell.driver().System(cell.config, cell.mix, cell.spec, device, batch=batch)
    system.build()
    system.warm_up(0)
    torch.cuda.reset_peak_memory_stats(device)
    walls, enqueue, device_ms = [], [], []
    for i in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        act = system.activity(0, i)
        carry = system.engine.init_state(batch=batch)
        start.record()
        t1 = time.perf_counter()
        carry, (spikes, _) = system.engine.run(carry, act)
        enqueue.append((time.perf_counter() - t1) / system.steps * 1e3)
        end.record()
        spikes[-1, :, :1].cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end) / system.steps)
        del act, carry, spikes
    t = tracing.trace(system, 0, repeats, 2)
    return {
        "workload": cell.name, "batch": batch, "repeats": repeats,
        "batch_wall_ms_median": statistics.median(walls),
        "host_enqueue_ms_per_step_median": statistics.median(enqueue),
        "device_ms_per_step_median": statistics.median(device_ms),
        "traced_idle_share": 1.0 - t["busy_s"] / t["window_s"],
        "traced_busy_ms_per_step": t["busy_s"] * 1e3 / (2 * system.steps),
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep.py times the card; no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(ROOT, args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda", 0)
    with out.open("a") as f:
        for b in (int(x) for x in args.batches.split(",")):
            line = json.dumps(point(cell, b, args.repeats, device))
            print(line, flush=True)
            f.write(line + "\n")
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
