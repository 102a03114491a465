"""The JAX package's counts for the workloads of chip_smoke.py's phase 3c.

Runs ``repro`` on the CPU at the phase's full width (the Table-V network
with the offline-Hebbian readout of the serving phase, a pool of 32 slots,
64 poker-DVS sessions of seed 7 with 16 events per step, the default 3x3
fabric) and prints the integer counts, placement and accuracies that
chip_smoke.py pins at the top of phase 3c as one JSON object. It is not
collected by pytest (a few minutes on the CPU); run it from the repository
root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/faults_phase_reference.py
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro.core.cnn import compile_poker_cnn  # noqa: E402
from repro.core.compiler import repair_placement  # noqa: E402
from repro.core.faults import FaultSpec, apply_table_faults, fault_blast_radius  # noqa: E402
from repro.core.routing import Fabric  # noqa: E402
from repro.data.pipeline import DvsStreamConfig, DvsStreamSource  # noqa: E402
from repro.serve.aer import (  # noqa: E402
    AerServeConfig,
    AerSessionPool,
    DvsSession,
    build_poker_engine,
)
from repro.serve.health import Watchdog, WatchdogConfig, migrate_pool, serve_resilient  # noqa: E402

POOL, SESSIONS, SEED, EVENTS_PER_STEP = 32, 64, 7, 16
# tests/test_faults.py's 25% of the 3x3 board's directed links
DEAD25 = ((0, 1), (1, 0), (0, 3), (3, 0), (1, 2), (2, 1))
# phase 3c part 2: one spec per fault class, and the steps each pool runs
CLASSES = {
    "dead_link": {"dead_links": ((0, 1),)},
    "lossy": {"link_drop_rate": 0.05, "seed": 3},
    "stuck_cluster": {"stuck_clusters": (0,)},
}
CLASS_STEPS = 20
MEMORY_FAULTS = {"cam_bit_flips": 64, "sram_bit_flips": 64, "seed": 11}


def tuned_cnn_and_suits():
    """The serving phase's readout and suits: the calibration run draws
    from ``default_rng(7)`` first, the session suits after it."""
    spec = importlib.util.spec_from_file_location(
        "poker_dvs_serve_example", REPO / "examples" / "poker_dvs_serve.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rng = np.random.default_rng(SEED)
    fc_select = example.tune_readout(rng)
    suits = rng.integers(0, 4, SESSIONS)
    return compile_poker_cnn(fc_select=fc_select), suits


def sessions(suits):
    return [
        DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=int(suits[i]),
                                                      events_per_step=EVENTS_PER_STEP,
                                                      seed=SEED), session_id=i),
                   label=int(suits[i]))
        for i in range(len(suits))
    ]


def serve_state(cc, suits, faults=None, placement=None):
    if placement is not None:
        cc = dataclasses.replace(
            cc, tables=dataclasses.replace(cc.tables, tile_of_cluster=placement))
    eng = build_poker_engine(cc.tables, backend="fabric", donate_carry=False, faults=faults)
    pool = AerSessionPool(cc, eng, AerServeConfig(pool_size=POOL))
    results = pool.serve(sessions(suits))
    return {"accuracy": float(np.mean([r.correct for r in results])),
            "link_dropped": int(sum(r.link_dropped for r in results)),
            "engine_steps": pool.n_steps}


def class_counts(cc, suits, faults):
    """A full pool of the first 32 sessions stepped ``CLASS_STEPS`` times
    (no evictions): link drops, delivered events and spikes, summed."""
    eng = build_poker_engine(cc.tables, backend="fabric", donate_carry=False, faults=faults)
    pool = AerSessionPool(cc, eng, AerServeConfig(pool_size=POOL))
    for s in sessions(suits)[:POOL]:
        pool.admit(s)
    link_dropped = delivered = spikes = 0
    for _ in range(CLASS_STEPS):
        out = pool.step()
        link_dropped += int(np.asarray(pool.last_stats.link_dropped).sum())
        delivered += int(np.asarray(pool.last_stats.delivered).sum())
        spikes += int(np.asarray(out).sum())
    return {"link_dropped": link_dropped, "delivered": delivered, "spikes": spikes}


def migration(cc, suits):
    fs = FaultSpec(dead_links=DEAD25)
    eng = build_poker_engine(cc.tables, backend="fabric", donate_carry=False, faults=fs)
    pool = AerSessionPool(cc, eng, AerServeConfig(pool_size=POOL))

    def on_degraded(old, ev):
        placement, _ = repair_placement(cc.tables, Fabric(), fs, seed=0)
        tables_r = dataclasses.replace(cc.tables, tile_of_cluster=placement)
        return migrate_pool(old, build_poker_engine(tables_r, backend="fabric",
                                                    donate_carry=False, faults=fs))

    wd = Watchdog(WatchdogConfig(window=4, link_drop_threshold=0.2, silence_steps=30))
    results, events = serve_resilient(pool, sessions(suits), watchdog=wd,
                                      on_degraded=on_degraded)
    degraded = [e for e in events if e.kind == "pool-degraded"]
    return {"results": len(results),
            "accuracy": float(np.mean([r.correct for r in results])),
            "link_dropped": int(sum(r.link_dropped for r in results)),
            "events": [e.kind for e in events],
            "degraded_step": degraded[0].step if degraded else None}


def memory_faults(cc, suits):
    corrupted, report = apply_table_faults(cc.tables, FaultSpec(**MEMORY_FAULTS))
    cc_c = dataclasses.replace(cc, tables=corrupted)
    eng = build_poker_engine(corrupted, backend="reference", donate_carry=False)
    pool = AerSessionPool(cc_c, eng, AerServeConfig(pool_size=POOL))
    results = pool.serve(sessions(suits))
    return {"flips": len(report),
            "blast_radius": fault_blast_radius(cc.tables, corrupted),
            "accuracy": float(np.mean([r.correct for r in results])),
            "latency_steps": int(sum(r.latency_steps for r in results)),
            "engine_steps": pool.n_steps}


def main() -> None:
    cc, suits = tuned_cnn_and_suits()
    fs = FaultSpec(dead_links=DEAD25)
    placement, report = repair_placement(cc.tables, Fabric(), fs, seed=0)
    out = {
        "repair": {"placement": placement.tolist(), "feasible": report["feasible"]},
        "states": {"healthy": serve_state(cc, suits),
                   "dead25": serve_state(cc, suits, fs),
                   "repaired": serve_state(cc, suits, fs, placement)},
        "classes": {name: class_counts(cc, suits, FaultSpec(**kw))
                    for name, kw in CLASSES.items()},
        "migration": migration(cc, suits),
        "memory": memory_faults(cc, suits),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
