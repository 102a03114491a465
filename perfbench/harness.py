"""The benchmark's run: one cell, one seed, one window.

``run.py --workload NAME --seed N --seconds S --trace 0|1`` finds the cell
in ``BENCHMARK.json`` and its files by name: ``workloads/NAME.json`` (batch,
checked batches, limits), the configuration's file, ``traffic/MIX.json``,
``drivers/SYSTEM.py`` (how the configuration's system is built and driven)
and one reader ``metrics/METRIC.py`` per metric. Set-up builds the program
and runs one whole batch; the window then runs batches back to back for
``S`` seconds; with ``--trace 1`` a few more batches run under the
profiler. Once the window has closed, the peak memory has been read and the
program is freed, the checked batches' answers are compared with the
reference. The last line on standard output is the result, and the last
lines on standard error each compared number beside its limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


class Cell:
    """A cell's files, found by name from ``BENCHMARK.json``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.here = Path(__file__).resolve().parent
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry
        cfg = next(c for c in self.bench["configs"] if c["name"] == entry["config"])
        self.config = json.loads((self.root / cfg["file"]).read_text())
        self.mix = json.loads((self.here / "traffic" / f"{entry['traffic']}.json").read_text())
        self.spec = json.loads((self.here / "workloads" / f"{name}.json").read_text())

    def metrics(self, section: str) -> list[dict]:
        return [m for m in self.bench[section] if "workloads" not in m
                or self.name in m["workloads"]]

    def driver(self):
        return importlib.import_module(f"perfbench.drivers.{self.config['system']}")

    def reader(self, metric: str):
        """The metric's reader, loaded from its file: a metric's name may hold
        a dot (``mfu.train``), which an import by name takes for a package."""
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            batch: int | None = None) -> dict:
    """Set-up, the window, the traced batches and the comparison; returns
    the run's record (what the metrics' readers read) and the verdict."""
    import torch

    t_in = time.perf_counter()
    driver = cell.driver()
    system = driver.System(cell.config, cell.mix, cell.spec, device, batch=batch)
    system.build()
    t_built = time.perf_counter()
    system.warm_up(seed)
    on_card = system.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(system.device)
        torch.cuda.reset_peak_memory_stats(system.device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    setup_parts = {"build": t_built - t_in, "warm_up": t_warm - t_built}

    checked = set(driver.checked_batches(seed, cell.spec))
    batches, answers = [], {}
    w0 = time.perf_counter()
    while True:
        i = len(batches)
        b = system.run_batch(seed, i, keep_answer=i in checked)
        if b.answer is not None:
            answers[i] = b.answer
            b.answer = None
        batches.append(b)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(system.device) if on_card else 0

    trace = None
    if traced:
        from perfbench import trace as tracing

        trace = tracing.trace(system, seed, len(batches), cell.spec["trace_batches"])
        # the traced batches again, untraced, for the spikes their steps
        # routed: keeping them inside the trace would grow its memory
        net = system.reference_network()
        work = [system.event_counts(system.run_batch(seed, i, keep_spikes=True).spikes, net)
                for i in trace["indices"]]
        trace["work"] = {k: sum(w[k] for w in work) for k in work[0]}
        del net
    shape = system.shape()
    system.free()

    values, failed = system.check(seed, answers) if answers else ({}, 0)
    from perfbench.reference.compare import verdict

    limits = cell.spec["limits"]
    correct, lines = verdict(values, limits)
    if not answers:
        correct = False
        lines.append("checked_batches 0 limit 1 FAILED: the window ended before a checked batch")
    return {
        "record": {
            "batch": system.batch, "steps": system.steps, "setup_s": setup_s,
            "setup_parts": setup_parts,
            "window_s": window_s, "batches": batches, "trace": trace, "shape": shape,
        },
        "correct": correct, "lines": lines, "values": values, "limits": limits,
        "attempted": len(batches) * system.batch, "failed": failed, "peak": peak,
    }


def result_line(cell: Cell, out: dict, traced: bool, device_info: dict) -> dict:
    record = out["record"]
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        value = cell.reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=out["peak"])
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if traced:
        trace = record["trace"]
        device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        line["breakdown"] = trace["breakdown"]
    line["checks"] = {k: {"value": v, "limit": out["limits"][k]} for k, v in out["values"].items()}
    return line


def main(argv: list[str], t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(root, args.workload)

    import torch

    t_torch = time.perf_counter()
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_cuda = time.perf_counter()
    out = measure(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    line = result_line(cell, out, bool(args.trace), info)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures repro_torch alone",
              file=sys.stderr)
        return 3
    print(json.dumps(line))
    sys.stdout.flush()
    # set-up's parts: process start to torch imported, the CUDA driver's
    # start, the program built, the warm-up batch
    parts = dict(imports=t_torch - t_start, cuda_init=t_cuda - t_torch,
                 **out["record"]["setup_parts"])
    print("setup_s parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()),
          file=sys.stderr)
    for text in out["lines"]:
        print(text, file=sys.stderr)
    return 0
