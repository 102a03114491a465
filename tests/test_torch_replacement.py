"""Profile-guided live re-placement in the port against repro (DESIGN.md §18).

``ReplacementController`` on the port's pool, beside repro's on the same
sessions:

* the refusals (no traffic profile, a model not resident, no free tiles,
  a multi-model pool without ``model=``) carry repro's messages;
* the drift, ``min_steps`` and cooldown gates give repro's decisions, and a
  swap gives repro's version name, placement and observed costs;
* the forced swap (fabric) and a versioned ``load_model`` (queued) leave
  the sessions in flight byte-equal to an unswapped control pool;
* ``retarget`` and ``drain_retired`` retire the old version as repro's do,
  and ``migrate_pool`` keeps a multi-model pool's resident set.

Pools have 2 slots, as repro's tests/test_replacement.py uses.
"""

import dataclasses
import functools

import numpy as np
import pytest

from repro.core.cnn import compile_poker_cnn as j_compile_poker
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro.serve import health as jhealth
from repro_torch.core.cnn import compile_poker_cnn as t_compile_poker
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer
from repro_torch.serve import health as thealth

J = {"aer": jaer, "pipe": jpipe, "health": jhealth, "kw": {}}
T = {"aer": taer, "pipe": tpipe, "health": thealth, "kw": {"device": "cpu"}}


@functools.lru_cache(maxsize=1)
def _poker():
    return j_compile_poker(), t_compile_poker()


def _cc(pkg):
    return _poker()[pkg is T]


def _session(pkg, i, model=None, seed=9):
    return pkg["aer"].DvsSession(
        i, pkg["pipe"].DvsStreamSource(
            pkg["pipe"].DvsStreamConfig(symbol=i % 4, events_per_step=16, seed=seed),
            session_id=i),
        label=i % 4, model=model,
    )


def _pool(pkg, models=None, per_link=True, backend="fabric", pool_size=2):
    cfg = pkg["aer"].AerServeConfig(pool_size=pool_size, max_steps=10**6)
    fo = None
    if backend == "fabric":
        fo = {"per_link_stats": True} if per_link else {}
    return pkg["aer"].AerSessionPool.from_models(
        models or {"poker": _cc(pkg)}, cfg, backend=backend, fabric_options=fo, **pkg["kw"])


def _fill(pkg, pool, model=None, seed=9):
    for i in range(pool.cfg.pool_size):
        pool.admit(_session(pkg, i, model=model, seed=seed))


def _placed(pkg, tiles):
    cc = _cc(pkg)
    return dataclasses.replace(cc, tables=dataclasses.replace(
        cc.tables, tile_of_cluster=np.asarray(tiles, np.int32)))


def _error(fn, exc=ValueError):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


def _slots(pool):
    return [None if s is None else (s.step, s.model, s.counts.tobytes(), s.dropped,
                                    s.link_dropped) for s in pool.slots]


def _report(r):
    return None if r is None else (r["name"], r["step"], r["drift"], r["placement"].tolist(),
                                   r["cost_observed_old"], r["cost_observed_new"],
                                   r["mean_hops_old"], r["mean_hops_new"])


# ---------------------------------------------------------------------------
# typed refusal
# ---------------------------------------------------------------------------
def test_controller_refusals_equal_repro():
    msgs = []
    for pkg in (J, T):
        ctl = pkg["health"].ReplacementController
        two = _pool(pkg, models={"a": _cc(pkg), "b": _cc(pkg)})
        msgs.append([_error(lambda: ctl(_pool(pkg, backend="reference"))),
                     _error(lambda: ctl(_pool(pkg, per_link=False))),
                     _error(lambda: ctl(_pool(pkg), model="nope")),
                     _error(lambda: ctl(two))])
    assert msgs[1] == msgs[0]
    assert "per_link_stats" in msgs[1][0] and "not resident" in msgs[1][2]
    assert dataclasses.astuple(thealth.ReplacementConfig()) == \
        dataclasses.astuple(jhealth.ReplacementConfig())


def test_controller_stamps_the_default_placement_as_repro():
    pools = (_pool(J), _pool(T))
    for pool, pkg in zip(pools, (J, T)):
        pkg["health"].ReplacementController(pool)
    placed = pools[1].models["poker"].tables.tile_of_cluster
    np.testing.assert_array_equal(placed, pools[0].models["poker"].tables.tile_of_cluster)
    assert placed.tolist() == [0, 0, 0, 0, 1, 1]  # the 3x3 board's default, 4 cores a tile
    assert pools[1].fingerprint() == pools[0].fingerprint()


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
def _gates(pkg):
    pool = _pool(pkg)
    ctl = pkg["health"].ReplacementController(pool, cfg=pkg["health"].ReplacementConfig(
        drift_threshold=0.05, min_steps=6, cooldown_steps=50))
    out = [_report(ctl.maybe_replace())]  # nothing observed yet
    _fill(pkg, pool)
    for _ in range(3):
        pool.step()
    out.append(_report(ctl.maybe_replace()))  # below min_steps
    for _ in range(3):
        pool.step()
    out.append(ctl.drift())
    report = ctl.maybe_replace()
    out.append(_report(report))
    out.append((ctl.current, ctl.retired, list(pool.models), pool.profile.steps))
    out.append(_report(ctl.maybe_replace()))
    for _ in range(6):
        pool.step()
    out.append(_report(ctl.maybe_replace()))  # cooldown_steps=50 not yet elapsed
    old_tiles = set(np.asarray(pool.models["poker"].tables.tile_of_cluster).tolist())
    return out, old_tiles, report, _slots(pool)


def test_min_steps_threshold_and_cooldown_gates_equal_repro():
    got, old_tiles, report, slots = _gates(T)
    want, _, _, want_slots = _gates(J)
    assert got == want and slots == want_slots
    assert got[0] is None and got[1] is None and got[2] >= 0.05
    assert got[3][0] == "poker@r1" and got[5] is None and got[6] is None
    assert got[4] == ("poker@r1", ["poker"], ["poker", "poker@r1"], 0)
    assert not old_tiles & set(report["placement"].tolist())


def test_below_threshold_never_swaps_as_repro():
    drifts = []
    for pkg in (J, T):
        pool = _pool(pkg)
        ctl = pkg["health"].ReplacementController(pool, cfg=pkg["health"].ReplacementConfig(
            drift_threshold=0.99, min_steps=2, cooldown_steps=0))
        _fill(pkg, pool)
        for _ in range(8):
            pool.step()
        assert ctl.maybe_replace() is None
        assert ctl.version == 0 and list(pool.models) == ["poker"]
        drifts.append(ctl.drift())
    assert drifts[1] == drifts[0] and 0.0 < drifts[1] < 0.99


# ---------------------------------------------------------------------------
# the bit-exact rung
# ---------------------------------------------------------------------------
def _forced(pkg):
    pool_a, pool_b = _pool(pkg), _pool(pkg)  # B is the unswapped control
    _fill(pkg, pool_a, seed=23)
    _fill(pkg, pool_b, seed=23)
    for _ in range(10):
        pool_a.step()
        pool_b.step()
    ctl = pkg["health"].ReplacementController(pool_a, cfg=pkg["health"].ReplacementConfig(
        min_steps=1, cooldown_steps=0))
    report = ctl.maybe_replace(force=True)
    for _ in range(6):
        pool_a.step()
        pool_b.step()
    return report, _slots(pool_a), _slots(pool_b)


def test_forced_swap_is_byte_equal_for_mid_flight_sessions_and_repro():
    report, swapped, control = _forced(T)
    want, want_swapped, _ = _forced(J)
    assert swapped == control == want_swapped
    assert _report(report) == _report(want)
    assert report["cost_observed_new"] <= report["cost_observed_old"]


def test_versioned_swap_byte_equal_in_queued_mode():
    base = _placed(T, [0, 0, 1, 1, 2, 2])
    pool_a = _pool(T, models={"poker": base}, backend="reference")
    pool_b = _pool(T, models={"poker": base}, backend="reference")
    _fill(T, pool_a, seed=31)
    _fill(T, pool_b, seed=31)
    for _ in range(8):
        pool_a.step()
        pool_b.step()
    pool_a.load_model("poker@r1", _placed(T, [3, 4, 5, 6, 7, 8]))
    assert pool_a.engine.n_clusters == 12
    for _ in range(6):
        pool_a.step()
        pool_b.step()
    assert _slots(pool_a) == _slots(pool_b)


def test_no_free_tiles_raises_toward_the_best_effort_rung_as_repro():
    msgs = []
    for pkg in (J, T):
        pool = _pool(pkg, models={"a": _placed(pkg, [0, 1, 2, 3, 4, 5]),
                                  "b": _placed(pkg, [3, 4, 5, 6, 7, 8])})
        _fill(pkg, pool, model="a")
        for _ in range(4):
            pool.step()
        ctl = pkg["health"].ReplacementController(pool, model="a")
        msgs.append(_error(lambda: ctl.maybe_replace(force=True), RuntimeError))
    assert msgs[1] == msgs[0] and "migrate_pool" in msgs[1]


# ---------------------------------------------------------------------------
# version lifecycle
# ---------------------------------------------------------------------------
def _lifecycle(pkg):
    pool = _pool(pkg)
    _fill(pkg, pool)
    for _ in range(4):
        pool.step()
    ctl = pkg["health"].ReplacementController(pool)
    report = ctl.maybe_replace(force=True)
    out = [_report(report), ctl.drain_retired(), sorted(pool.models)]
    pool.evict(0)
    s_new = ctl.retarget(_session(pkg, 7))
    out.append(s_new.model)
    pool.admit(s_new)
    for _ in range(3):
        pool.step()
    out.append(_slots(pool))
    pool.evict(1)
    out += [ctl.drain_retired(), sorted(pool.models), ctl.retired]
    moved = pkg["health"].migrate_pool(pool, pool.engine)
    out += [list(moved.models), _slots(moved)]
    return out


def test_retarget_and_drain_retire_the_old_version_as_repro():
    got = _lifecycle(T)
    assert got == _lifecycle(J)
    assert got[1] == [] and got[2] == ["poker", "poker@r1"] and got[3] == "poker@r1"
    assert got[5] == ["poker"] and got[6] == ["poker@r1"] and got[7] == []
    assert got[8] == ["poker@r1"]
