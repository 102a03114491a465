"""The port's sharded session fleet against repro (serve/sharded.py, DESIGN.md §17).

Mirrors repro's tests/test_sharded_serving.py on the Table-V network with
pools of 2 slots (4 for the restore and recovery fleets). Every fleet
scenario (serving, migration, drain, restore onto fewer shards, kill and
recovery) is held session for session to what repro's solo pool gives the
same sessions, which is what repro's own fleet gives them (its tests hold
that invariant); admission picks, refusal texts, ``fleet_stats``, the
``FleetWatchdog`` events and the fleet's ``_fleet_meta()`` /
``snapshot_tree()`` are held to repro's fleet on the same state.

The port's shards run in-process, on ``["cpu"] * k`` where a mesh has
several cells. repro's multi-device fleet (1x2 cluster meshes on fake XLA
devices) runs once per module in one subprocess that writes its results to
a temporary ``.npz``; its 1x1 fleets and solo pools run in-process.

Tolerances: session results (counts, prediction, decision, latency, drops,
link drops) are bit-exact; ``fleet_stats``' float latency / energy sums are
``allclose(rtol=1e-5, atol=1e-7)``.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.cnn import compile_poker_cnn as j_compile_poker
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro.serve import health as jhealth
from repro.serve import sharded as jsharded
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.cnn import compile_poker_cnn as t_compile_poker
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer
from repro_torch.serve import health as thealth
from repro_torch.serve import sharded as tsharded
from repro_torch.serve.sharded import AdmissionError, ShardConfig, ShardedSessionPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = {"aer": jaer, "pipe": jpipe, "sharded": jsharded, "health": jhealth, "kw": {}}
T = {"aer": taer, "pipe": tpipe, "sharded": tsharded, "health": thealth, "kw": {"device": "cpu"}}
MAX_STEPS = 25
SOLO_IDS = (*range(8), 10, 11)  # every session id a scenario below serves
MESH_IDS = (0, 1, 2, 3, 10)  # the multi-device scenarios' sessions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU side here is many small ops: one intra-op thread, so
    test workers running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=1)
def _poker():
    return j_compile_poker(), t_compile_poker()


def _session(pkg, i, symbol=None):
    symbol = {10: 2, 11: 1}.get(i, i % 4) if symbol is None else symbol
    pipe = pkg["pipe"]
    return pkg["aer"].DvsSession(
        i, pipe.DvsStreamSource(pipe.DvsStreamConfig(symbol=symbol, events_per_step=16, seed=9),
                                session_id=i),
        label=symbol)


def _cfg(pkg, pool_size=2):
    return pkg["aer"].AerServeConfig(pool_size=pool_size, max_steps=MAX_STEPS)


def _fleet(pkg, n_shards=2, pool_size=2, queue_depth=2, backend="reference", **kw):
    cc = _poker()[pkg is T]
    return pkg["sharded"].ShardedSessionPool(
        cc, _cfg(pkg, pool_size),
        pkg["sharded"].ShardConfig(n_shards=n_shards, queue_depth=queue_depth, backend=backend),
        **pkg["kw"], **kw)


def _key(r):
    return (r.counts.tolist(), r.prediction, r.decided, r.latency_steps, r.dropped,
            r.link_dropped, r.error)


def _drain(fleet, res=None):
    res = {} if res is None else res
    while fleet.busy:
        fleet.step()
        for r in fleet.evict_finished():
            res[r.session_id] = _key(r)
    return res


@pytest.fixture(scope="module")
def solo():
    """repro's solo pool on each backend: every session of the scenarios
    below served at once (a session's results do not depend on its slot)."""
    cc = _poker()[0]
    out = {}
    for backend in ("reference", "fabric"):
        pool = jaer.AerSessionPool(cc, jaer.build_poker_engine(cc.tables, backend),
                                   _cfg(J, len(SOLO_IDS)))
        out[backend] = {r.session_id: _key(r)
                        for r in pool.serve([_session(J, i) for i in SOLO_IDS])}
    return out


def _assert_results(got: dict, want: dict, ids):
    assert set(got) == set(ids)
    for sid in ids:
        assert got[sid] == want[sid], sid


def _mesh_reference(path):
    """repro's 1x2-cluster-mesh fleet on fake CPU devices (run by the
    ``mesh_reference`` fixture in a subprocess): two shards on disjoint
    device pairs over the slab-retiled tables, serving MESH_IDS."""
    import jax

    assert len(jax.devices()) >= 8, jax.devices()
    cc = jsharded.retile_for_slabs(j_compile_poker(), 2)
    fleet = jsharded.ShardedSessionPool(
        cc, _cfg(J, 3), jsharded.ShardConfig(n_shards=2, queue_depth=4, backend="fabric",
                                             cluster_devices=2))
    assert [len({d.id for d in fleet._shard_devices[i]}) for i in range(2)] == [2, 2]
    res = {r.session_id: _key(r) for r in fleet.serve([_session(J, i) for i in MESH_IDS])}
    np.savez(path, results=np.array(json.dumps(res)),
             placement=np.asarray(cc.tables.tile_of_cluster))


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_serving") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}]; "
            f"import test_torch_sharded_serving as m; m._mesh_reference({str(path)!r})")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stdout + "\n" + done.stderr
    with np.load(path) as f:
        res = {int(k): tuple(v) for k, v in json.loads(str(f["results"])).items()}
        return {"results": res, "placement": f["placement"]}


# ---------------------------------------------------------------------------
# layers 1 + 2: fleet stepping and admission control
# ---------------------------------------------------------------------------
def test_admission_balances_by_traffic_score():
    picks = {}
    for pkg in (J, T):
        fleet = _fleet(pkg)
        picks[pkg is T] = [fleet.submit(_session(pkg, i)) for i in range(4)]
    assert picks[True] == picks[False] and sorted(picks[True]) == [0, 0, 1, 1]
    occ = fleet.occupancy()
    assert occ[0][1] + occ[1][1] == 4  # all queued until the first backfill
    fleet.step()
    assert fleet.occupancy() == {0: (2, 0), 1: (2, 0)}


def test_admission_bounded_queue_raises_typed_error(solo):
    errors = []
    for pkg in (J, T):
        fleet = _fleet(pkg, queue_depth=2)
        for i in range(8):  # per shard 2 slot-bound + 2 overflow
            fleet.submit(_session(pkg, i))
        with pytest.raises(pkg["sharded"].AdmissionError, match="queue_depth") as e:
            fleet.submit(_session(pkg, 99, 0))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    _assert_results(_drain(fleet), solo["reference"], range(8))


def test_admission_rejects_unknown_model():
    errors = []
    for pkg in (J, T):
        sess = _session(pkg, 0)
        sess.model = "nope"
        with pytest.raises(KeyError, match="not resident") as e:
            _fleet(pkg).submit(sess)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_fleet_serve_matches_repro(solo, backend):
    fleet = _fleet(T, backend=backend)
    res = {r.session_id: _key(r) for r in fleet.serve([_session(T, i) for i in range(8)])}
    _assert_results(res, solo[backend], range(8))
    assert isinstance(fleet.pools[0].engine, tsharded.ShardedEventEngine)
    assert fleet.pools[0].carry[1].device.type == "cpu"


@pytest.fixture(scope="module")
def fleet_trace():
    """repro's and the port's fabric fleets over four steps with two
    sessions still queued: per step the fleet stats and the fleet
    watchdog's events, then the fleet meta and the snapshot tree."""
    out = {}
    for pkg in (J, T):
        fleet = _fleet(pkg, backend="fabric", queue_depth=4)
        wd = pkg["health"].FleetWatchdog()
        assert fleet.fleet_stats() is None  # nothing stepped yet
        for i in range(6):
            fleet.submit(_session(pkg, i))
        stats, events = [], []
        for _ in range(4):
            fleet.step()
            stats.append(fleet.fleet_stats())
            events.append([(shard, ev.kind, ev.slot, ev.session_id)
                           for shard, ev in wd.observe(fleet)])
        out[pkg is T] = dict(fleet=fleet, stats=stats, events=events, wd=wd,
                             meta=fleet._fleet_meta(), tree=fleet.snapshot_tree())
    return out


def test_fleet_stats_sums_shards_like_repro(fleet_trace):
    t, j = fleet_trace[True], fleet_trace[False]
    for got, want in zip(t["stats"], j["stats"]):
        for f in ("dropped", "link_dropped", "delivered", "hops"):
            assert int(getattr(got, f)) == int(getattr(want, f)), f
        for f in ("latency_s", "energy_j"):
            np.testing.assert_allclose(float(getattr(got, f)), float(getattr(want, f)),
                                       rtol=1e-5, atol=1e-7)
    fleet = t["fleet"]
    per_shard = sum(int(fleet.pools[i].last_stats.delivered.sum()) for i in fleet.live_shards())
    assert int(t["stats"][-1].delivered) == per_shard > 0


def test_fleet_watchdog_scans_every_shard_like_repro(fleet_trace):
    t, j = fleet_trace[True], fleet_trace[False]
    assert t["events"] == j["events"]
    assert set(t["wd"]._per_shard) == set(j["wd"]._per_shard) == {0, 1}
    assert t["wd"].link_drop_rate() == j["wd"].link_drop_rate()
    assert isinstance(t["wd"].shard_watchdog(0), thealth.Watchdog)


def test_fleet_meta_and_snapshot_tree_match_repro(fleet_trace):
    """The same fleet state gives repro's ``_fleet_meta()`` (queued
    sessions' meta included) and ``snapshot_tree()``: the same keys and
    the same per-shard session meta, fingerprints included."""
    t, j = fleet_trace[True], fleet_trace[False]
    assert t["meta"] == j["meta"] and len(t["meta"]["queues"][0]) + len(t["meta"]["queues"][1]) == 2

    def keys(tree):
        return {k: keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None

    assert keys(t["tree"]) == keys(j["tree"])
    for shard in t["tree"]["shards"]:
        blobs = [json.loads(np.asarray(x["shards"][shard]["session_meta"]).tobytes().decode())
                 for x in (t["tree"], j["tree"])]
        assert blobs[0] == blobs[1]
    assert json.loads(t["tree"]["fleet_meta"].tobytes().decode()) == t["meta"]


# ---------------------------------------------------------------------------
# layer 3: live migration and drain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_migration_mid_flight_matches_repro(solo, backend):
    """A tenant migrated between shards mid-serve finishes as in repro's
    undisturbed run: neuron state, queued spikes and the phase-normalized
    in-flight fabric slab all survive the move."""
    fleet = _fleet(T, backend=backend)
    fleet.submit(_session(T, 10))
    fleet.submit(_session(T, 11))
    for _ in range(4):
        fleet.step()
    shard, _ = fleet.locate(10)
    fleet.migrate(10, 1 - shard)
    assert fleet.locate(10)[0] == 1 - shard
    _assert_results(_drain(fleet), solo[backend], (10, 11))


def test_migrate_validates_destination():
    fleet = _fleet(T)
    fleet.submit(_session(T, 0))
    fleet.step()
    with pytest.raises(KeyError, match="session 77 is not resident in the fleet"):
        fleet.locate(77)
    assert fleet.migrate(0, fleet.locate(0)[0]) == fleet.locate(0)[1]
    fleet.kill_shard(1)
    with pytest.raises(ValueError, match="destination shard 1 is not live"):
        fleet.migrate(0, 1)


def test_drain_shard_moves_everything(solo):
    fleet = _fleet(T, pool_size=4)
    for i in range(4):
        fleet.submit(_session(T, i))
    for _ in range(3):
        fleet.step()
    assert fleet.drain_shard(0) == 2
    assert fleet.occupancy()[0] == (0, 0)
    _assert_results(_drain(fleet), solo["reference"], range(4))


def test_drain_shard_raises_when_no_room():
    fleet = _fleet(T)
    for i in range(4):
        fleet.submit(_session(T, i))
    fleet.step()  # both shards full
    with pytest.raises(AdmissionError, match="cannot drain shard 0: 2 resident sessions but "
                                             "only 0 free slots elsewhere"):
        fleet.drain_shard(0)
    fleet.kill_shard(1)
    with pytest.raises(ValueError, match="already dead"):
        fleet.drain_shard(1)


# ---------------------------------------------------------------------------
# layer 4: fleet checkpoint, elastic restore, kill + recover
# ---------------------------------------------------------------------------
def _started(backend, steps):
    fleet = _fleet(T, n_shards=4, pool_size=4, queue_depth=4, backend=backend)
    for i in range(8):
        fleet.submit(_session(T, i))
    for _ in range(steps):
        fleet.step()
    return fleet


@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_restore_onto_fewer_shards_matches_repro(solo, backend, tmp_path):
    """A 4-shard fleet saved mid-serve restores at 2 shards: surviving
    shards in place, lost shards' sessions redistributed into free slots;
    every session finishes as in repro's undisturbed run."""
    fleet = _started(backend, 5)
    ck = Checkpointer(str(tmp_path), keep=2)
    fleet.checkpoint(ck, blocking=True)
    small = ShardedSessionPool.restore(
        _poker()[1], _cfg(T, 4), ShardConfig(n_shards=2, queue_depth=4, backend=backend), ck,
        device="cpu")
    assert small.n_steps == fleet.n_steps == 5
    assert sum(o for o, _ in small.occupancy().values()) == 8
    assert all(p.carry[1].device.type == "cpu" for p in small.pools)
    res = {}
    for r in fleet.evict_finished():  # none finish in 5 steps
        res[r.session_id] = _key(r)
    _assert_results(_drain(small, res), solo[backend], range(8))


def test_restore_impossible_raises_typed_mismatch(tmp_path):
    fleet = _started("reference", 3)
    ck = Checkpointer(str(tmp_path), keep=2)
    fleet.checkpoint(ck, blocking=True)
    cc = _poker()[1]
    # 1 shard x 4 slots cannot hold 8 mid-flight sessions
    with pytest.raises(taer.CheckpointMismatchError, match="redistribute"):
        ShardedSessionPool.restore(cc, _cfg(T, 4), ShardConfig(n_shards=1, queue_depth=0), ck,
                                   device="cpu")
    with pytest.raises(taer.CheckpointMismatchError, match="pool_size"):
        ShardedSessionPool.restore(cc, _cfg(T, 2), ShardConfig(n_shards=4, queue_depth=4), ck,
                                   device="cpu")
    # a fabric fleet's carry does not fit the queued checkpoint's
    with pytest.raises(taer.CheckpointMismatchError, match="does not fit"):
        ShardedSessionPool.restore(cc, _cfg(T, 4), ShardConfig(n_shards=4, queue_depth=4,
                                                               backend="fabric"), ck,
                                   device="cpu")


@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_kill_shard_recover_from_checkpoint_matches_repro(solo, backend, tmp_path):
    """Kill a shard mid-serve; its sessions roll back to the checkpoint and
    splice into survivors, whose current state keeps serving untouched.
    Every result, the recovered tenants' included, equals repro's
    undisturbed run."""
    fleet = _started(backend, 3)
    ck = Checkpointer(str(tmp_path), keep=2)
    fleet.checkpoint(ck, blocking=True)
    for _ in range(2):
        fleet.step()
    victim = 2
    held = [s.session_id for s in fleet.pools[victim].slots if s is not None]
    assert held  # the dead shard held tenants
    fleet.kill_shard(victim)
    with pytest.raises(ValueError, match="already dead"):
        fleet.kill_shard(victim)
    assert fleet.recover_shard(ck, victim) == len(held)
    res = _drain(fleet, {r.session_id: _key(r) for r in fleet.evict_finished()})
    _assert_results(res, solo[backend], range(8))


def test_recover_shard_guards(tmp_path):
    fleet = _fleet(T)
    ck = Checkpointer(str(tmp_path), keep=2)
    with pytest.raises(ValueError, match="is live"):
        fleet.recover_shard(ck, 0)
    fleet.kill_shard(0)
    with pytest.raises(FileNotFoundError):
        fleet.recover_shard(ck, 0)
    fleet.kill_shard(1)
    with pytest.raises(AdmissionError, match="no live shards"):
        fleet.submit(_session(T, 0))


def test_fleet_refusals_match_repro():
    """Too few devices per shard, several models over cluster-sharded fabric
    shards, and the card by default."""
    errors = []
    for pkg in (J, T):
        with pytest.raises(ValueError) as e:
            pkg["sharded"].ShardedSessionPool(
                _poker()[pkg is T], _cfg(pkg),
                pkg["sharded"].ShardConfig(cluster_devices=2), **pkg["kw"])
        errors.append(str(e.value))
        with pytest.raises(NotImplementedError) as e:
            cc = _poker()[pkg is T]
            pkg["sharded"].ShardedSessionPool(
                cc, _cfg(pkg), pkg["sharded"].ShardConfig(cluster_devices=2, backend="fabric"),
                models={"a": cc, "b": cc}, **pkg["kw"])
        errors.append(str(e.value))
    assert errors[0] == errors[2] == "fleet needs at least 2 devices per shard, have 1"
    assert errors[1] == errors[3]
    with pytest.raises(ValueError, match="n_shards must be positive"):
        _fleet(T, n_shards=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardedSessionPool(_poker()[1], _cfg(T), ShardConfig())


# ---------------------------------------------------------------------------
# multi-device: the port on ["cpu"] * k against repro on fake devices
# ---------------------------------------------------------------------------
def _retiled():
    return tsharded.retile_for_slabs(_poker()[1], 2)


def test_fleet_on_1x2_meshes_matches_repro(mesh_reference):
    """Two shards of 1x2 cluster meshes (fabric ring, slab-retiled tables)
    serve as repro's fleet on disjoint fake-device pairs; the port's 1x1
    fleet on the same tables agrees (only the mesh differs)."""
    cc = _retiled()
    np.testing.assert_array_equal(np.asarray(cc.tables.tile_of_cluster),
                                  mesh_reference["placement"])
    out = {}
    for cd in (2, 1):
        fleet = ShardedSessionPool(cc, _cfg(T, 3), ShardConfig(
            n_shards=2, queue_depth=4, backend="fabric", cluster_devices=cd),
            devices=["cpu"] * 2 * cd)
        assert fleet.pools[1].engine.mesh.shape == {"data": 1, "model": cd}
        out[cd] = {r.session_id: _key(r)
                   for r in fleet.serve([_session(T, i) for i in MESH_IDS])}
    _assert_results(out[2], mesh_reference["results"], MESH_IDS)
    assert out[1] == out[2]


def test_cross_mesh_migration_matches_repro(mesh_reference):
    """A tenant starts on a 1x1 shard and moves mid-flight onto a 1x2
    cluster shard (same retiled tables, another mesh); it finishes as in
    repro."""
    cc = _retiled()

    def factory(shard_id, devices):
        return tsharded.build_poker_shard_engine(
            cc.tables, "fabric", cluster_devices=1 + shard_id, devices=["cpu"] * (1 + shard_id))

    fleet = ShardedSessionPool(cc, _cfg(T), ShardConfig(n_shards=2, queue_depth=4,
                                                        backend="fabric"),
                               device="cpu", engine_factory=factory)
    fleet.submit(_session(T, 10))
    fleet.step()
    if fleet.locate(10)[0] != 0:
        fleet.migrate(10, 0)
    for _ in range(3):
        fleet.step()
    fleet.migrate(10, 1)  # 1x1 mesh -> 1x2 mesh, mid-flight
    assert fleet.locate(10)[0] == 1 and fleet.pools[1].engine.mesh.size == 2
    _assert_results(_drain(fleet), mesh_reference["results"], (10,))


def test_elastic_restore_across_mesh_shapes(mesh_reference, tmp_path):
    """A fleet checkpointed with shards on 1x2 cluster meshes restores onto
    2x2 meshes and finishes as repro's fleet."""
    cc = _poker()[1]

    def shards(bd):
        return ShardConfig(n_shards=2, queue_depth=4, backend="fabric", cluster_devices=2,
                           batch_devices=bd)

    f = ShardedSessionPool(cc, _cfg(T), shards(1), devices=["cpu"] * 2)
    for i in range(4):
        f.submit(_session(T, i))
    for _ in range(5):
        f.step()
    ck = Checkpointer(str(tmp_path), keep=2)
    f.checkpoint(ck, blocking=True)
    g = ShardedSessionPool.restore(cc, _cfg(T), shards(2), ck, devices=["cpu"] * 4)
    assert g.pools[0].engine.mesh.shape == {"data": 2, "model": 2}
    _assert_results(_drain(g), mesh_reference["results"], range(4))
