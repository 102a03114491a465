#!/usr/bin/env python3
"""Time the Table-V serving step on one NVIDIA GPU, part by part on the host clock.

A pool of 32 slots on the default Table-V tables, every slot holding a DVS
session that never decides (so the load stays constant), served on the
``fused``, ``cuda`` and ``fabric`` backends and on the fabric with
``per_link_stats`` (whose pool, where the port has it, feeds a traffic
profile). Per leg: 5 warm-up steps, then ``--rounds`` rounds of ``--steps``
steps, each step split into building the inputs, launching the engine step
(host time of the call), waiting for the device, and the readout; the
median over rounds of each part's mean ms per step; then ``--steps`` steps
under torch.profiler for the device-busy ms and device operations per
step (every device kernel's time, summed). ``--src`` names the
``src`` directory whose ``repro_torch`` is timed (default: this
checkout's), so that two checkouts can be timed in turns on one card
(A, B, B, A). ``--autotune N`` also builds ``backend="auto"`` engines N
times (activity 0.1, B = 32) and reports each decision. Prints one JSON
line:

    python3 scripts/time_serving.py [--src path/to/src] [--autotune N]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
POOL = 32
LEGS = (
    ("fused", "fused", None),
    ("cuda", "cuda", None),
    ("fabric", "fabric", {}),
    ("fabric_per_link", "fabric", {"per_link_stats": True}),
)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--autotune", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cnn import compile_poker_cnn
    from repro_torch.data.pipeline import DvsStreamConfig, DvsStreamSource
    from repro_torch.serve.aer import (
        AerServeConfig,
        AerSessionPool,
        DvsSession,
        build_poker_engine,
    )

    if not torch.cuda.is_available():
        sys.exit("time_serving: CUDA is not available")
    dev = torch.device("cuda")
    cc = compile_poker_cnn()
    cfg = AerServeConfig(pool_size=POOL, decision_threshold=float("inf"), max_steps=10**9)
    legs = {}
    for label, backend, options in LEGS:
        engine = build_poker_engine(cc.tables, backend=backend, device=dev,
                                    fabric_options=options)
        pool = AerSessionPool(cc, engine, cfg)
        for i in range(POOL):
            pool.admit(DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=i % 4, seed=i),
                                                     session_id=i), label=i % 4))
        for _ in range(5):
            pool.step()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(args.rounds):
            parts = dict.fromkeys(("inputs", "launch", "device_wait", "readout", "wall"), 0.0)
            for _ in range(args.steps):
                t0 = time.perf_counter()
                inp = pool.gather_inputs()
                t1 = time.perf_counter()
                pool.carry, out = pool.engine.step(pool.carry, inp)
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                pool.finish_step(out)
                t4 = time.perf_counter()
                for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
                    parts[key] += dt * 1e3 / args.steps
            rounds.append(parts)
        legs[label] = {key: statistics.median(r[key] for r in rounds) for key in rounds[0]}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                pool.step()
            torch.cuda.synchronize()
        # the device's operations, without its mirrors of the engine's
        # profiler spans (named as their host spans)
        events = prof.events()
        host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
        device = [e.time_range.elapsed_us() for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in host]
        legs[label]["device_busy_ms"] = sum(device) / 1e3 / args.steps
        legs[label]["device_ops"] = len(device) / args.steps
        legs[label]["profile"] = getattr(pool, "profile", None) is not None
    decisions = []
    for _ in range(args.autotune):
        engine = build_poker_engine(cc.tables, backend="auto", device=dev,
                                    autotune={"activity": 0.1, "batch": POOL})
        d = engine.autotune_decision
        decisions.append({"token": d.token(), "backend": engine.backend.name,
                          "measurements_us": dict(d.measurements)})
    print(json.dumps({"src": str(args.src), "card": torch.cuda.get_device_name(0),
                      "ms_per_step": legs, "autotune": decisions}), flush=True)


if __name__ == "__main__":
    main()
