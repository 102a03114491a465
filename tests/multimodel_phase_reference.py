"""The JAX package's counts for the workloads of chip_smoke.py's phase 3d.

Runs ``repro`` on the CPU at the phase's full width: two resident Table-V
networks (the serving phase's offline-Hebbian readout, 1536 neurons in 6
cores of 256 each, 3072 neurons in 12 clusters together) in a pool of 32
slots, 64 poker-DVS sessions of seed 7 with 16 events per step alternating
between models "a" and "b" by index, the default 3x3 fabric. Prints as one
JSON object the accuracies, link drops, decision steps, engine steps,
placement and observed costs that chip_smoke.py pins at the top of phase
3d. It is not collected by pytest (a few minutes on the CPU); run it from
the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/multimodel_phase_reference.py
"""

from __future__ import annotations

import json
import sys
from collections import deque
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

from repro.serve.aer import AerServeConfig, AerSessionPool  # noqa: E402
from repro.serve.health import ReplacementController  # noqa: E402
from tests.faults_phase_reference import POOL, sessions, tuned_cnn_and_suits  # noqa: E402

LOAD_AT = 4  # phase 3d part 3: steps of "a" alone before "b" is loaded
REPLACE_AT, AFTER_SWAP = 10, 6  # part 4: steps before the forced swap, and after it


def mixed(suits, n=None):
    """The sessions, on models "a" and "b" by even and odd index."""
    out = sessions(suits)[:n]
    for i, s in enumerate(out):
        s.model = "a" if i % 2 == 0 else "b"
    return out


def summary(results, pool=None) -> dict:
    out = {"sessions": len(results),
           "accuracy": float(np.mean([r.correct for r in results])),
           "link_dropped": int(sum(r.link_dropped for r in results)),
           "latency_steps": int(sum(r.latency_steps for r in results))}
    if pool is not None:
        out["engine_steps"] = pool.n_steps
    return out


def two_model(cc, suits, backend, n=None, fabric_options=None) -> dict:
    """Part 1 / 2: the two-model pool serving the mixed sessions."""
    pool = AerSessionPool.from_models({"a": cc, "b": cc}, AerServeConfig(pool_size=POOL),
                                      backend=backend, donate_carry=False,
                                      fabric_options=fabric_options)
    return summary(pool.serve(mixed(suits, n)), pool)


def hot_load(cc, suits) -> dict:
    """Part 3 on the fabric: "a" with its 32 sessions, ``load_model("b")``
    after 4 steps, b's sessions admitted as slots free, the pool drained;
    then ``unload_model("a")`` and the first 32 sessions served on "b"."""
    pool = AerSessionPool.from_models({"a": cc}, AerServeConfig(pool_size=POOL),
                                      backend="fabric", donate_carry=False)
    traffic = mixed(suits)
    pending = deque([s for s in traffic if s.model == "a"] + [s for s in traffic if s.model == "b"])
    results = []
    while pending or pool.occupied:
        if pool.n_steps == LOAD_AT and "b" not in pool.models:
            pool.load_model("b", cc)
        while pending and pool.free_slots and pending[0].model in pool.models:
            pool.admit(pending.popleft())
        pool.step()
        done = pool.finished_slots()
        if done:
            results.extend(pool.evict_many(done))
    steps = pool.n_steps
    pool.unload_model("a")
    survivors = sessions(suits)[:POOL]
    for s in survivors:
        s.model = "b"
    out = {m: summary([r for r in results if r.session_id % 2 == (m == "b")]) for m in "ab"}
    return {**out, "engine_steps": steps, "survivor": summary(pool.serve(survivors))}


def replacement(cc, suits) -> dict:
    """Part 4: a 32-slot fabric pool with per-link stats, the forced
    versioned swap after 10 steps; the next 32 sessions retargeted onto the
    new version, the old one drained."""
    cfg = AerServeConfig(pool_size=POOL)
    pools = [AerSessionPool.from_models({"poker": cc}, cfg, backend="fabric", donate_carry=False,
                                        fabric_options={"per_link_stats": True})
             for _ in range(2)]
    for pool in pools:
        for s in sessions(suits)[:POOL]:
            pool.admit(s)
    pool, control = pools
    for _ in range(REPLACE_AT):
        pool.step()
        control.step()
    ctl = ReplacementController(pool)
    report = ctl.maybe_replace(force=True)
    for _ in range(AFTER_SWAP):
        pool.step()
        control.step()
    equal = all(
        a.step == b.step and np.array_equal(a.counts, b.counts) and a.dropped == b.dropped
        and a.link_dropped == b.link_dropped for a, b in zip(pool.slots, control.slots))
    pending = deque(ctl.retarget(s) for s in sessions(suits)[POOL:])
    results, drained_at = [], None
    while pending or pool.occupied:
        done = pool.finished_slots()
        if done:
            results.extend(pool.evict_many(done))
        if ctl.retired and ctl.drain_retired():
            drained_at = pool.n_steps
        while pending and pool.free_slots:
            pool.admit(pending.popleft())
        if pool.occupied:
            pool.step()
    if ctl.retired and ctl.drain_retired():
        drained_at = pool.n_steps
    return {"name": report["name"], "placement": np.asarray(report["placement"]).tolist(),
            "cost_observed_old": report["cost_observed_old"],
            "cost_observed_new": report["cost_observed_new"],
            "mid_flight_equal_to_control": bool(equal), "drained_at_step": drained_at,
            "models": list(pool.models), **summary(results, pool)}


def main() -> None:
    cc, suits = tuned_cnn_and_suits()
    out = {
        "two_model": {backend: two_model(cc, suits, backend) for backend in ("reference", "fabric")},
        "fabric_cap8": two_model(cc, suits, "fabric", POOL, {"link_capacity": 8}),
        "hot_load_fabric": hot_load(cc, suits),
        "replacement": replacement(cc, suits),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
