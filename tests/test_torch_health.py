"""The serving watchdog and degraded-mode recovery in the port against repro.

``serve_resilient`` gives repro's events (kinds, steps, slots, values,
messages) and results on a healthy pool, on a tenant that keeps faulting
(retry with backoff, then slot quarantine, then the exhausted pool) and on
a severed forward path (silence detection). The Table-V pool with the
Hebbian-tuned readout is served healthy, over 25% dead mesh links and on
the repaired placement with repro's accuracy and link drops, and the
degraded pool migrates mid-flight onto the repaired engine and finishes at
100% (repro's test size: pool 4, 8 sessions).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import compiler as jcomp
from repro.core import dispatch as jdispatch
from repro.core import faults as jfaults
from repro.core import routing as jrouting
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro.serve import health as jhealth
from repro_torch.core import cnn as tcnn
from repro_torch.core import compiler as tcomp
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import faults as tfaults
from repro_torch.core import routing as trouting
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer
from repro_torch.serve import health as thealth
from tests.test_faults import DEAD25

J = {"aer": jaer, "cnn": jcnn, "pipe": jpipe, "health": jhealth, "faults": jfaults,
     "routing": jrouting, "comp": jcomp, "kw": {"donate_carry": False}}
T = {"aer": taer, "cnn": tcnn, "pipe": tpipe, "health": thealth, "faults": tfaults,
     "routing": trouting, "comp": tcomp, "kw": {"device": "cpu"}}


def _sessions(p, n, seed=11):
    return [
        p["aer"].DvsSession(
            i, p["pipe"].DvsStreamSource(
                p["pipe"].DvsStreamConfig(symbol=i % 4, events_per_step=16, seed=seed),
                session_id=i),
            label=i % 4)
        for i in range(n)
    ]


def _key(results):
    return sorted((r.session_id, r.label, r.prediction, r.decided, r.latency_steps,
                   tuple(r.counts), r.dropped, r.link_dropped, r.error) for r in results)


def _events(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.fixture(scope="module")
def plain():
    return {"j": jcnn.compile_poker_cnn(), "t": tcnn.compile_poker_cnn()}


@pytest.fixture(scope="module")
def tuned():
    """The Table-V CNN with the offline-Hebbian readout (examples/
    poker_dvs_serve.py's calibration, tests/test_torch_serving.py holds the
    selection equal to repro's)."""
    sel = taer.tune_poker_readout("cpu", np.random.default_rng(7))
    return {"j": jcnn.compile_poker_cnn(fc_select=sel), "t": tcnn.compile_poker_cnn(fc_select=sel)}


def _pool(p, cc, cfg_kw, backend="reference", faults=None):
    eng = p["aer"].build_poker_engine(cc.tables, backend=backend, faults=faults, **p["kw"])
    return p["aer"].AerSessionPool(cc, eng, p["aer"].AerServeConfig(**cfg_kw))


# ---------------------------------------------------------------------------
# the escalation ladder
# ---------------------------------------------------------------------------
def test_healthy_serve_resilient_equals_serve_and_repro(plain):
    cfg = {"pool_size": 2, "max_steps": 20}
    out = {}
    for name, p in (("j", J), ("t", T)):
        wd = p["health"].Watchdog(p["health"].WatchdogConfig(silence_steps=30))
        results, events = p["health"].serve_resilient(
            _pool(p, plain[name], cfg), _sessions(p, 4), watchdog=wd)
        assert events == []
        out[name] = _key(results)
    assert out["t"] == out["j"] == _key(_pool(T, plain["t"], cfg).serve(_sessions(T, 4)))


class _AlwaysBad:
    def events(self, step):
        return np.array([[5, -1]])  # malformed on every step


def test_retry_then_quarantine_equals_repro(plain):
    out = {}
    for name, p in (("j", J), ("t", T)):
        h = p["health"]
        pool = _pool(p, plain[name], {"pool_size": 1, "max_steps": 20})
        wd = h.Watchdog(h.WatchdogConfig(max_retries=1, backoff_base=1, quarantine_after=2))
        bad = p["aer"].DvsSession(0, _AlwaysBad(), label=1)
        results, events = h.serve_resilient(pool, [bad], watchdog=wd)
        results2, events2 = h.serve_resilient(pool, _sessions(p, 1), watchdog=wd)
        out[name] = (_key(results), _events(events), _key(results2), _events(events2),
                     sorted(pool.quarantined), pool.n_steps)
    assert out["t"] == out["j"]
    kinds = [e[0] for e in out["t"][1]]
    assert kinds.count("session-error") == 2 and "slot-quarantined" in kinds
    assert out["t"][4] == [0]
    assert out["t"][2][0][-1] == "pool exhausted: all slots quarantined"


def test_silence_detection_equals_repro(plain):
    out = {}
    for name, p in (("j", J), ("t", T)):
        h = p["health"]
        fs = p["faults"].FaultSpec(dead_links=((0, 1), (1, 0)))  # severs conv -> pool/out
        pool = _pool(p, plain[name], {"pool_size": 2, "max_steps": 40}, "fabric", fs)
        wd = h.Watchdog(h.WatchdogConfig(silence_steps=6, max_retries=0,
                                         link_drop_threshold=2.0))
        results, events = h.serve_resilient(pool, _sessions(p, 2), watchdog=wd)
        out[name] = (_key(results), _events(events))
    assert out["t"] == out["j"]
    assert any(e[0] == "session-silent" for e in out["t"][1])
    assert all(r[-1] and "no readout progress" in r[-1] for r in out["t"][0])


class _StatsPool:
    """The parts of a pool the watchdog reads: no tenants, one step's stats."""

    def __init__(self, array):
        self.slots, self.n_steps, self.last_stats, self.array = [], 0, None, array

    def feed(self, dispatch, lost, delivered):
        self.n_steps += 1
        self.last_stats = dispatch.DeliveryStats(
            dropped=self.array([0, 0]), link_dropped=self.array([lost, 0]),
            delivered=self.array([delivered, 0]))


def test_degraded_hysteresis_equals_repro():
    """``pool-degraded`` fires once per episode and re-arms only below half
    the threshold; a window with nothing sent reads 0."""
    fracs = [0.0, 0.5, 0.5, 0.5, 0.3, 0.2, 0.1, 0.0, 0.0, 0.0, 0.6, 0.6, 0.6, 0.6, None]
    out = {}
    for name, h, dispatch, array in (
        ("j", jhealth, jdispatch, lambda v: np.asarray(v, np.int32)),
        ("t", thealth, tdispatch, lambda v: torch.tensor(v, dtype=torch.int32)),
    ):
        wd = h.Watchdog(h.WatchdogConfig(window=3, link_drop_threshold=0.4))
        pool = _StatsPool(array)
        events, rates = [], []
        for f in fracs:
            lost, sent = (0, 0) if f is None else (int(f * 10), 10)
            pool.feed(dispatch, lost, sent - lost)
            events += _events(wd.observe(pool))
            rates.append(wd.link_drop_rate())
        out[name] = (events, rates)
    assert out["t"] == out["j"]
    assert [e[0] for e in out["t"][0]] == ["pool-degraded", "pool-degraded"]


# ---------------------------------------------------------------------------
# 25% dead links: degrade, repair, migrate (the Table-V tuned readout)
# ---------------------------------------------------------------------------
def _serve_state(p, cc, faults=None, placement=None):
    if placement is not None:
        tables = dataclasses.replace(cc.tables, tile_of_cluster=placement)
        cc = dataclasses.replace(cc, tables=tables)
    results = _pool(p, cc, {"pool_size": 4}, "fabric", faults).serve(_sessions(p, 8))
    return float(np.mean([r.correct for r in results])), sum(r.link_dropped for r in results)


def test_dead_links_degrade_and_repair_restores_accuracy_as_repro(tuned):
    out = {}
    for name, p in (("j", J), ("t", T)):
        cc = tuned[name]
        fs = p["faults"].FaultSpec(dead_links=DEAD25)
        placement, report = p["comp"].repair_placement(cc.tables, p["routing"].Fabric(), fs,
                                                       seed=0)
        assert report["feasible"]
        out[name] = (_serve_state(p, cc), _serve_state(p, cc, fs),
                     _serve_state(p, cc, fs, placement), placement.tolist())
    assert out["t"] == out["j"]
    healthy, faulted, repaired, _ = out["t"]
    assert healthy == (1.0, 0)
    assert faulted[0] < 1.0 and faulted[1] > 0
    assert repaired[0] == 1.0 and repaired[1] < faulted[1]


def test_degraded_pool_migrates_mid_flight_as_repro(tuned):
    out = {}
    for name, p in (("j", J), ("t", T)):
        h, cc = p["health"], tuned[name]
        fs = p["faults"].FaultSpec(dead_links=DEAD25)
        pool = _pool(p, cc, {"pool_size": 4}, "fabric", fs)
        migrations = []

        def on_degraded(old, ev, p=p, cc=cc, fs=fs, migrations=migrations):
            placement, report = p["comp"].repair_placement(cc.tables, p["routing"].Fabric(),
                                                           fs, seed=0)
            assert report["feasible"]
            tables_r = dataclasses.replace(cc.tables, tile_of_cluster=placement)
            eng_r = p["aer"].build_poker_engine(tables_r, backend="fabric", faults=fs,
                                                **p["kw"])
            migrations.append((ev.step, ev.value, old.n_steps, len(old.occupied)))
            return p["health"].migrate_pool(old, eng_r)

        wd = h.Watchdog(h.WatchdogConfig(window=4, link_drop_threshold=0.2, silence_steps=30))
        results, events = h.serve_resilient(pool, _sessions(p, 8), watchdog=wd,
                                            on_degraded=on_degraded)
        out[name] = (_key(results), _events(events), migrations)
    assert out["t"] == out["j"]
    results, events, migrations = out["t"]
    assert len(migrations) == 1 and migrations[0][1] >= 0.2
    assert [e[0] for e in events].count("pool-degraded") == 1
    assert len(results) == 8
    assert all(r[2] == r[1] for r in results)  # 100% accuracy


def test_migrate_pool_onto_an_equal_engine_is_bit_exact(plain):
    """Migration between two engines of one geometry changes nothing: every
    session ends as in the uninterrupted run."""
    cc = plain["t"]
    cfg = taer.AerServeConfig(pool_size=2, max_steps=20)
    want = _key(taer.AerSessionPool(cc, taer.build_poker_engine(cc.tables, "fabric",
                                                                device="cpu"), cfg)
                .serve(_sessions(T, 3)))
    pool = taer.AerSessionPool(cc, taer.build_poker_engine(cc.tables, "fabric", device="cpu"),
                               cfg)
    migrated = []

    class _Once(thealth.Watchdog):
        def observe(self, p):
            if p.n_steps == 3 and not migrated:
                migrated.append(p.n_steps)
                return [thealth.FaultEvent(kind="pool-degraded", step=p.n_steps, value=1.0)]
            return []

    new_eng = taer.build_poker_engine(cc.tables, "fabric", device="cpu")
    results, events = thealth.serve_resilient(
        pool, _sessions(T, 3), watchdog=_Once(),
        on_degraded=lambda p, ev: thealth.migrate_pool(p, new_eng))
    assert migrated == [3] and len(events) == 1
    assert _key(results) == want


def test_unported_parts_name_their_roadmap_items():
    assert dataclasses.astuple(thealth.WatchdogConfig()) == \
        dataclasses.astuple(jhealth.WatchdogConfig())
    # FleetWatchdog came with 'Multi-device': one Watchdog per shard, kept
    # across scans, and the fleet gated by its worst shard, as repro's is
    rates, scanned = [], []
    for pkg in (J, T):
        health, aer = pkg["health"], pkg["aer"]
        fw = health.FleetWatchdog(health.WatchdogConfig(window=4))
        assert fw.link_drop_rate() == 0.0
        a, b = fw.shard_watchdog(0), fw.shard_watchdog(3)
        assert fw.shard_watchdog(0) is a and a is not b and isinstance(a, health.Watchdog)
        a._drop_window.extend([0.1, 0.3])
        b._drop_window.append(0.5)
        rates.append(fw.link_drop_rate())
        cc = pkg["cnn"].compile_poker_cnn()
        pool = aer.AerSessionPool(cc, aer.build_poker_engine(cc.tables, **pkg["kw"]),
                                  aer.AerServeConfig(pool_size=1))
        fleet = type("Fleet", (), {"pools": {5: pool}, "live_shards": lambda self: [5]})()
        scanned.append((fw.observe(fleet), sorted(fw._per_shard)))
    assert rates == [0.5, 0.5]
    assert scanned[0] == scanned[1] == ([], [0, 3, 5])
    # the live versioned swap came with 'Multi-model': repro's defaults, and
    # a pool without a traffic profile is refused as repro refuses it
    assert dataclasses.astuple(thealth.ReplacementConfig()) == \
        dataclasses.astuple(jhealth.ReplacementConfig())
    cc = tcnn.compile_poker_cnn()
    pool = taer.AerSessionPool(cc, taer.build_poker_engine(cc.tables, device="cpu"),
                               taer.AerServeConfig(pool_size=1))
    with pytest.raises(ValueError, match="per_link_stats"):
        thealth.ReplacementController(pool)
