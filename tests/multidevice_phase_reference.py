"""The JAX package's counts for the workloads of chip_smoke.py's phase 3e.

Runs ``repro`` on the CPU with 8 fake XLA devices at the phase's full
width: the Table-V network with the serving phase's offline-Hebbian
readout (1536 neurons in 6 cores of 256, K = 1024), 64 poker-DVS sessions
of seed 7 with 16 events per step, the default 3x3 fabric. The parts:

  1. fleets of 1, 2 and 4 shards over the fabric, 64 slots in all;
  2. fleets of 2 shards of 32 slots on the slab-retiled tables
     (``retile_for_slabs(cc, 2)``) over 1x1, 1x2 and 2x2 meshes, on the
     fabric ring and on the queued step;
  3. the same 1x1 and 1x2 fleets on the fabric at link capacity 8, on the
     first 32 sessions;
  4. the control plane: on the retiled tables a 1x1 and a 1x2 shard, 8
     sessions migrated mid-flight onto the 1x2 shard, then the 1x1 shard
     drained; a 4-shard fabric fleet of 32 slots each (16 sessions each)
     checkpointed after 3 steps, restored onto 2 shards (the lost shards'
     sessions into the survivors' free slots), and (the original) killed at
     shard 2 two steps later and recovered, with a fleet watchdog scanning
     every step; a 2-shard fleet of 2 slots and queue depth 2 refusing its
     ninth session.

Prints as one JSON object the sums over sessions (accuracy, link drops,
decision steps) and the fleet steps of each part, which chip_smoke.py pins
at the top of phase 3e. It is not collected by pytest (a few minutes on the
CPU); run it from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
      python tests/multidevice_phase_reference.py
"""

from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

import jax  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro.core.cnn import poker_neuron_params  # noqa: E402
from repro.core.event_engine import ShardedEventEngine  # noqa: E402
from repro.core.routing import Fabric  # noqa: E402
from repro.serve.aer import AerServeConfig  # noqa: E402
from repro.serve.health import FleetWatchdog  # noqa: E402
from repro.serve.sharded import (  # noqa: E402
    AdmissionError,
    ShardConfig,
    ShardedSessionPool,
    build_poker_shard_engine,
    retile_for_slabs,
)
from tests.faults_phase_reference import POOL, sessions, tuned_cnn_and_suits  # noqa: E402

SLOTS = 64  # fleet slots in all
MIGRATE, CKPT_AT, KILL_AFTER, VICTIM = 8, 3, 2, 2  # part 4


def summary(results, fleet=None) -> dict:
    out = {"sessions": len(results),
           "accuracy": float(np.mean([r.correct for r in results])),
           "link_dropped": int(sum(r.link_dropped for r in results)),
           "latency_steps": int(sum(r.latency_steps for r in results))}
    if fleet is not None:
        out["fleet_steps"] = fleet.n_steps
    return out


def drain(fleet, results=None, watchdog=None, events=None):
    results = [] if results is None else results
    while fleet.busy:
        fleet.step()
        if watchdog is not None:
            events.extend(watchdog.observe(fleet))
        results.extend(fleet.evict_finished())
    return results


def fleets(cc, suits) -> dict:
    """Part 1: 1, 2 and 4 shards, 64 slots in all, over the fabric."""
    out = {}
    for n in (1, 2, 4):
        fleet = ShardedSessionPool(cc, AerServeConfig(pool_size=SLOTS // n),
                                   ShardConfig(n_shards=n, backend="fabric"))
        out[str(n)] = summary(fleet.serve(sessions(suits)), fleet)
    return out


def meshes(rc, suits) -> dict:
    """Part 2: 2 shards of 32 slots on the retiled tables, per mesh and step."""
    out = {}
    for backend in ("fabric", "reference"):
        for bd, cd in ((1, 1), (1, 2), (2, 2)):
            fleet = ShardedSessionPool(
                rc, AerServeConfig(pool_size=SLOTS // 2),
                ShardConfig(n_shards=2, backend=backend, cluster_devices=cd, batch_devices=bd))
            out[f"{backend}_{bd}x{cd}"] = summary(fleet.serve(sessions(suits)), fleet)
    return out


def cap8(rc, suits) -> dict:
    """Part 3: link capacity 8 on 1x1 and 1x2 meshes, the first 32 sessions."""
    out = {}
    for cd in (1, 2):
        def factory(i, devices, cd=cd):
            return ShardedEventEngine(
                rc.tables, poker_neuron_params(), fabric=Fabric(),
                fabric_options={"link_capacity": 8}, queue_capacity=rc.tables.n_neurons,
                devices=devices, cluster_devices=cd)

        fleet = ShardedSessionPool(rc, AerServeConfig(pool_size=POOL // 2),
                                   ShardConfig(n_shards=2, backend="fabric", cluster_devices=cd),
                                   engine_factory=factory)
        out[f"1x{cd}"] = summary(fleet.serve(sessions(suits)[:POOL]), fleet)
    return out


def control_plane(cc, rc, suits) -> dict:
    """Part 4: migration and drain across meshes; checkpoint, restore onto
    fewer shards, kill and recover, the fleet watchdog; admission refusal."""
    devs = jax.devices()

    def factory(i, devices):
        return build_poker_shard_engine(rc.tables, "fabric", cluster_devices=1 + i,
                                        devices=devs[:1] if i == 0 else devs[1:3])

    fleet = ShardedSessionPool(rc, AerServeConfig(pool_size=POOL),
                               ShardConfig(n_shards=2, backend="fabric"), engine_factory=factory)
    for s in sessions(suits)[:POOL]:
        fleet.submit(s)
    for _ in range(4):
        fleet.step()
    results = fleet.evict_finished()
    moved = [s.session_id for s in fleet.pools[0].slots if s is not None][:MIGRATE]
    for sid in moved:
        fleet.migrate(sid, 1)
    drained = fleet.drain_shard(0)
    migration = {"migrated": len(moved), "drained": drained,
                 **summary(drain(fleet, results), fleet)}

    big = ShardedSessionPool(cc, AerServeConfig(pool_size=SLOTS // 2),
                             ShardConfig(n_shards=4, backend="fabric"))
    for s in sessions(suits):
        big.submit(s)
    wd = FleetWatchdog()
    events = []
    for _ in range(CKPT_AT):
        big.step()
        events.extend(wd.observe(big))
    results = big.evict_finished()
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d, keep=2)
        big.checkpoint(ck, blocking=True)
        small = ShardedSessionPool.restore(cc, AerServeConfig(pool_size=SLOTS // 2),
                                           ShardConfig(n_shards=2, backend="fabric"), ck)
        occupancy = sum(o for o, _ in small.occupancy().values())
        restore = {"occupied": occupancy, **summary(drain(small, list(results)), small)}
        for _ in range(KILL_AFTER):
            big.step()
            events.extend(wd.observe(big))
        held = sum(s is not None for s in big.pools[VICTIM].slots)
        big.kill_shard(VICTIM)
        recovered = big.recover_shard(ck, VICTIM)
    recover = {"held": held, "recovered": recovered,
               **summary(drain(big, results, wd, events), big),
               "watchdog_events": len(events), "watched_shards": sorted(wd._per_shard)}

    tiny = ShardedSessionPool(cc, AerServeConfig(pool_size=2), ShardConfig(queue_depth=2))
    admitted = 0
    try:
        for s in sessions(suits):
            tiny.submit(s)
            admitted += 1
    except AdmissionError:
        pass
    return {"migration": migration, "restore": restore, "recover": recover,
            "admitted_before_refusal": admitted}


def main() -> None:
    if len(jax.devices()) < 8:
        sys.exit("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    cc, suits = tuned_cnn_and_suits()
    rc = retile_for_slabs(cc, 2)
    out = {"placement": np.asarray(rc.tables.tile_of_cluster).tolist(),
           "fleets": fleets(cc, suits), "meshes": meshes(rc, suits), "cap8": cap8(rc, suits),
           "control": control_plane(cc, rc, suits)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
