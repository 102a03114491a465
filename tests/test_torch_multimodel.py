"""Multi-model residency in the port against repro (DESIGN.md §16).

Both packages on the same inputs:

* ``concat_tables`` and its ``TableSlab`` s, ``ModelRegistry`` (slabs,
  combined tables, ``fingerprint``) and the pool's ``fingerprint()`` are
  byte-equal to repro's;
* the fabric ring's entry table built slab by slab equals the build from
  the concatenated table (its ``cluster_start`` / ``cluster_order`` ranges
  included) and repro's slab build, on random tables of K = 24 and 40;
* a two-model pool serves each session as that model served solo, and as
  repro's two-model pool does, queued and over the fabric;
* a hot load under live sessions, the unload after it, and the refusals
  give repro's results and messages;
* a checkpoint of a two-model pool restores bit-exactly (repro's checkpoint
  into the port's pool too), and a changed model set or order raises
  ``CheckpointMismatchError``.

Pools have 2 slots, as repro's tests/test_multimodel.py uses.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import event_engine as jeng
from repro.core import routing as jrouting
from repro.core import tags as jtags
from repro.core.cnn import compile_poker_cnn as j_compile_poker
from repro.core.compiler import Geometry as JGeometry
from repro.core.neuron import NeuronParams as JParams, NeuronState as JState
from repro.data import pipeline as jpipe
from repro.kernels.fabric_deliver import ops as jfops
from repro.serve import aer as jaer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import event_engine as teng
from repro_torch.core import routing as trouting
from repro_torch.core import tags as ttags
from repro_torch.core.cnn import compile_poker_cnn as t_compile_poker
from repro_torch.core.compiler import Geometry, artifact_from_tables
from repro_torch.core.dispatch import FabricBackend
from repro_torch.core.faults import FaultSpec
from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.fabric_deliver import ops as tfops
from repro_torch.serve import aer as taer

J = {"aer": jaer, "pipe": jpipe, "kw": {}}
T = {"aer": taer, "pipe": tpipe, "kw": {"device": "cpu"}}
MAX_STEPS = 30  # long enough for the default readout's counts to move


@functools.lru_cache(maxsize=1)
def _poker():
    return j_compile_poker(), t_compile_poker()


def _session(pkg, i, symbol, model=None, seed=9):
    aer, pipe = pkg["aer"], pkg["pipe"]
    return aer.DvsSession(
        i, pipe.DvsStreamSource(pipe.DvsStreamConfig(symbol=symbol, events_per_step=16,
                                                     seed=seed), session_id=i),
        label=symbol, model=model,
    )


def _cfg(pkg, pool_size=2, **kw):
    kw.setdefault("max_steps", MAX_STEPS)
    return pkg["aer"].AerServeConfig(pool_size=pool_size, **kw)


def _two_model_pool(pkg, backend="reference", order=("a", "b")):
    cc = _poker()[pkg is T]
    return pkg["aer"].AerSessionPool.from_models(
        {name: cc for name in order}, _cfg(pkg), backend=backend, **pkg["kw"])


def _key(results):
    return sorted((r.session_id, r.prediction, r.decided, r.latency_steps, tuple(r.counts),
                   r.dropped, r.link_dropped, r.error) for r in results)


def _random_spec(spec_cls, seed, n=32, cluster=8, k=24, edges=48):
    rng = np.random.default_rng(seed)
    spec = spec_cls(n_neurons=n, cluster_size=cluster, k_tags=k)
    for _ in range(edges):
        spec.connect(int(rng.integers(n)), int(rng.integers(n)), int(rng.integers(4)))
    return spec


def _random_tables(seed, **kw):
    """The same random network compiled by each package: (repro's, port's)."""
    return (jtags.compile_network(_random_spec(jtags.NetworkSpec, seed, **kw)),
            ttags.compile_network(_random_spec(ttags.NetworkSpec, seed, **kw)))


def _parts(*cases):
    both = [_random_tables(seed, **kw) for seed, kw in cases]
    return [j for j, _ in both], [t for _, t in both]


def _assert_tables_equal(t, j):
    for name in ("src_tag", "src_dest", "cam_tag", "cam_syn"):
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (t.cluster_size, t.k_tags) == (j.cluster_size, j.k_tags)
    if j.tile_of_cluster is None:
        assert t.tile_of_cluster is None
    else:
        np.testing.assert_array_equal(t.tile_of_cluster, j.tile_of_cluster)
    assert t.fingerprint() == j.fingerprint()


def _error(fn, exc=ValueError):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


# ---------------------------------------------------------------------------
# tables, slabs and the registry
# ---------------------------------------------------------------------------
THREE = ((0, {}), (1, {"n": 48, "k": 40}), (2, {}))


@pytest.mark.parametrize("placed", [False, True])
def test_concat_tables_and_slabs_equal_repro(placed):
    jparts, tparts = _parts(*THREE)
    if placed:
        tiles = [np.arange(p.n_clusters, dtype=np.int32) % 4 for p in tparts]
        jparts = [dataclasses.replace(p, tile_of_cluster=x) for p, x in zip(jparts, tiles)]
        tparts = [dataclasses.replace(p, tile_of_cluster=x) for p, x in zip(tparts, tiles)]
    jcomb, jslabs = jtags.concat_tables(jparts)
    tcomb, tslabs = ttags.concat_tables(tparts)
    _assert_tables_equal(tcomb, jcomb)
    assert tcomb.k_tags == 40 and [s.neuron_lo for s in tslabs] == [0, 32, 80]
    assert [dataclasses.astuple(s) for s in tslabs] == [dataclasses.astuple(s) for s in jslabs]
    assert [(s.n_neurons, s.n_clusters) for s in tslabs] == [(32, 4), (48, 6), (32, 4)]
    # each slab's dense connectivity is the solo table's, at the slab's offset
    got = tcomb.dense_equivalent()
    want = np.concatenate([p.dense_equivalent() + [[s.neuron_lo, s.neuron_lo, 0]]
                           for p, s in zip(tparts, tslabs)])
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])


def test_concat_tables_refusals_equal_repro():
    jparts, tparts = _parts((0, {}), (1, {}))
    jmixed = [dataclasses.replace(jparts[0], tile_of_cluster=np.zeros(4, np.int32)), jparts[1]]
    tmixed = [dataclasses.replace(tparts[0], tile_of_cluster=np.zeros(4, np.int32)), tparts[1]]
    jwide, twide = _random_tables(1, cluster=16, k=64)
    for jarg, targ in (([], []), (jmixed, tmixed), ([jparts[0], jwide], [tparts[0], twide])):
        assert _error(lambda: ttags.concat_tables(targ)) == \
            _error(lambda: jtags.concat_tables(jarg))


def test_registry_slabs_combined_and_fingerprint_equal_repro():
    (ja, jb), (ta, tb) = _parts((0, {}), (1, {"n": 48, "k": 40}))
    jreg, treg = jeng.ModelRegistry({"a": ja}), teng.ModelRegistry({"a": ta})
    jwide, twide = _random_tables(1, cluster=16, k=64)
    for jcall, tcall, exc in ((lambda: jreg.load("a", jb), lambda: treg.load("a", tb), ValueError),
                              (lambda: jreg.load("b", jwide), lambda: treg.load("b", twide),
                               ValueError),
                              (lambda: jreg.unload("z"), lambda: treg.unload("z"), KeyError)):
        assert _error(tcall, exc) == _error(jcall, exc)
    assert treg.fingerprint() == jreg.fingerprint()
    tables, slabs = treg.combined()
    assert tables is ta and list(slabs) == ["a"]  # a registry of one is free
    jreg.load("b", jb)
    treg.load("b", tb)
    assert treg.names == jreg.names == ["a", "b"] and len(treg) == 2 and "b" in treg
    assert treg.fingerprint() == jreg.fingerprint()
    jcomb, jslabs = jreg.combined()
    tcomb, tslabs = treg.combined()
    _assert_tables_equal(tcomb, jcomb)
    assert {n: dataclasses.astuple(s) for n, s in tslabs.items()} == \
        {n: dataclasses.astuple(s) for n, s in jslabs.items()}
    assert tslabs == treg.slabs()
    treg.unload("a")
    jreg.unload("a")
    assert treg.names == ["b"] and treg.fingerprint() == jreg.fingerprint()
    assert treg.combined()[1]["b"].neuron_lo == 0
    assert _error(lambda: teng.ModelRegistry().combined()) == \
        _error(lambda: jeng.ModelRegistry().combined())


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1)])
def test_slab_entry_table_equals_concat_build_and_repro(order):
    jparts, tparts = _parts(*(THREE[i] for i in order))
    jcomb, _ = jtags.concat_tables(jparts)
    tcomb, _ = ttags.concat_tables(tparts)
    fab = Geometry(grid_x=2, grid_y=2, cores_per_tile=4, neurons_per_core=8).fabric()
    jfab = JGeometry(grid_x=2, grid_y=2, cores_per_tile=4, neurons_per_core=8).fabric()
    nc = tcomb.n_clusters
    tmodel = trouting.build_delivery_model(
        fab, nc, 1e-3, tile_of_cluster=trouting.default_tile_of_cluster(nc, fab))
    jmodel = jrouting.build_delivery_model(
        jfab, nc, 1e-3, tile_of_cluster=jrouting.default_tile_of_cluster(nc, jfab))
    per_model = [(t.src_tag, t.src_dest) for t in tparts]
    slabbed = tfops.build_fabric_entries_slabs(per_model, 8, tcomb.k_tags, tmodel, device="cpu")
    direct = tfops.build_fabric_entries(tcomb.src_tag, tcomb.src_dest, 8, tcomb.k_tags, tmodel,
                                        device="cpu")
    jslabbed = jfops.build_fabric_entries_slabs([(p.src_tag, p.src_dest) for p in jparts], 8,
                                                jcomb.k_tags, jmodel)
    for f in dataclasses.fields(tfops.FabricEntries):
        got = getattr(slabbed, f.name)
        assert torch.equal(got, getattr(direct, f.name)), f.name
        if hasattr(jslabbed, f.name):
            want = np.asarray(getattr(jslabbed, f.name))
            assert got.numpy().tobytes() == want.tobytes(), f.name
    # each cluster's run holds exactly the entries addressed to it
    start, run = slabbed.cluster_start.long(), slabbed.cluster_order.long()
    for c in range(nc):
        ids = run[start[c]:start[c + 1]]
        assert torch.equal(slabbed.dstk[ids].long() // tcomb.k_tags, torch.full_like(ids, c))
    # the backend's build, and the refusal of a faulted model
    backend = FabricBackend(fabric=fab, tile_of_cluster=tmodel.tile_of_cluster)
    via_backend = backend.build_entries_slabs(per_model, 8, tcomb.k_tags, device="cpu")
    assert torch.equal(via_backend.dstk, direct.dstk)
    faulted = trouting.build_delivery_model(
        fab, nc, 1e-3, faults=FaultSpec(dead_links=((0, 1),)),
        tile_of_cluster=tmodel.tile_of_cluster)
    assert "does not support fault injection" in _error(
        lambda: tfops.build_fabric_entries_slabs(per_model, 8, tcomb.k_tags, faulted, "cpu"))


def test_engine_entry_slabs_build_and_refusals_equal_repro():
    jparts, tparts = _parts((0, {}), (1, {}))
    jcomb, _ = jtags.concat_tables(jparts)
    tcomb, _ = ttags.concat_tables(tparts)
    fab = Geometry(grid_x=2, grid_y=1, cores_per_tile=4, neurons_per_core=8).fabric()
    jfab = JGeometry(grid_x=2, grid_y=1, cores_per_tile=4, neurons_per_core=8).fabric()
    per_t = [(t.src_tag, t.src_dest) for t in tparts]
    per_j = [(t.src_tag, t.src_dest) for t in jparts]
    eng = teng.EventEngine(tcomb, NeuronParams(), queue_capacity=64, fabric=fab,
                           device="cpu", entry_slabs=per_t)
    plain = teng.EventEngine(tcomb, NeuronParams(), queue_capacity=64, fabric=fab, device="cpu")
    for f in dataclasses.fields(tfops.FabricEntries):
        assert torch.equal(getattr(eng._fabric_entries, f.name),
                           getattr(plain._fabric_entries, f.name)), f.name
    cases = (
        (lambda: jeng.EventEngine(jcomb, JParams(), queue_capacity=64, fabric=jfab,
                                  entry_slabs=per_j[:1]),
         lambda: teng.EventEngine(tcomb, NeuronParams(), queue_capacity=64, fabric=fab,
                                  device="cpu", entry_slabs=per_t[:1])),
        (lambda: jeng.EventEngine(jcomb, JParams(), queue_capacity=64, fabric=jfab,
                                  fabric_options={"ring": False}, entry_slabs=per_j),
         lambda: teng.EventEngine(tcomb, NeuronParams(), queue_capacity=64, fabric=fab,
                                  device="cpu", fabric_options={"ring": False},
                                  entry_slabs=per_t)),
        (lambda: jaer.build_poker_engine(jcomb, entry_slabs=per_j),
         lambda: taer.build_poker_engine(tcomb, device="cpu", entry_slabs=per_t)),
    )
    for fj, ft in cases:
        assert _error(ft) == _error(fj)


def test_slice_and_embed_slot_carry_equal_repro():
    """A fabric slot carry of a two-model engine sliced to one slab and
    embedded into the slab layout that loading a third model gives: the
    arrays are repro's, byte for byte, and the embed base is the fresh
    init, not zeros."""
    jparts, tparts = _parts((0, {}), (1, {"k": 40}), (2, {}))
    fab = Geometry(grid_x=2, grid_y=2, cores_per_tile=4, neurons_per_core=8).fabric()
    jfab = JGeometry(grid_x=2, grid_y=2, cores_per_tile=4, neurons_per_core=8).fabric()
    treg, jreg = teng.ModelRegistry(), jeng.ModelRegistry()
    for name, jt, tt in zip("abc", jparts, tparts):
        jreg.load(name, jt)
        treg.load(name, tt)
    tcomb, tslabs = treg.combined()
    jcomb, jslabs = jreg.combined()
    teng_ = teng.EventEngine(tcomb, NeuronParams(), queue_capacity=96, fabric=fab, device="cpu")
    jeng_ = jeng.EventEngine(jcomb, JParams(), queue_capacity=96, fabric=jfab)
    rng = np.random.default_rng(0)
    s, n = 2, tcomb.n_neurons
    d = teng_.fabric_model.max_delay
    leaves = {k: rng.standard_normal((s, n)).astype(np.float32) for k in ("v", "w", "refrac")}
    i_syn = rng.standard_normal((s, n, 4)).astype(np.float32)
    spikes = (rng.random((s, 32 + 32)) < 0.3).astype(np.float32)  # slabs a and b
    infl = rng.random((s, max(d, 1), 8, 40)).astype(np.float32)
    # a and b only (clusters 0..8): slice b from the two-model layout
    two = teng.ModelRegistry({"a": tparts[0], "b": tparts[1]}).slabs()
    jtwo = jeng.ModelRegistry({"a": jparts[0], "b": jparts[1]}).slabs()
    tsc = teng.SlotCarry(state=NeuronState(**{k: v[:, :64] for k, v in leaves.items()},
                                           i_syn=i_syn[:, :64]),
                         spikes=spikes, inflight=infl)
    jsc = jeng.SlotCarry(state=JState(**{k: v[:, :64] for k, v in leaves.items()},
                                      i_syn=i_syn[:, :64]),
                         spikes=spikes, inflight=infl)
    tpart = teng.slice_slot_carry(tsc, two["b"])
    jpart = jeng.slice_slot_carry(jsc, jtwo["b"])
    for f in ("v", "w", "refrac", "i_syn"):
        assert getattr(tpart.state, f).tobytes() == np.asarray(getattr(jpart.state, f)).tobytes()
    assert tpart.inflight.shape == (s, max(d, 1), 4, 40)
    temb = teng.embed_slot_carry(tpart, teng_, tslabs["b"])
    jemb = jeng.embed_slot_carry(jpart, jeng_, jslabs["b"])
    for f in ("v", "w", "refrac", "i_syn"):
        assert getattr(temb.state, f).tobytes() == np.asarray(getattr(jemb.state, f)).tobytes()
    assert temb.spikes.tobytes() == np.asarray(jemb.spikes).tobytes()
    assert temb.inflight.tobytes() == np.asarray(jemb.inflight).tobytes()
    fresh = teng_.init_state(batch=s)[0].v.numpy()
    np.testing.assert_array_equal(temb.state.v[:, :32], fresh[:, :32])  # not zeros
    assert not np.all(fresh == 0)
    bad = dataclasses.replace(tpart, spikes=tpart.spikes[:, :-1])
    jbad = dataclasses.replace(jpart, spikes=np.asarray(jpart.spikes)[:, :-1])
    assert _error(lambda: teng.embed_slot_carry(bad, teng_, tslabs["b"])) == \
        _error(lambda: jeng.embed_slot_carry(jbad, jeng_, jslabs["b"]))
    queued = teng.EventEngine(tcomb, NeuronParams(), queue_capacity=96, device="cpu")
    jqueued = jeng.EventEngine(jcomb, JParams(), queue_capacity=96)
    assert _error(lambda: teng.embed_slot_carry(tpart, queued, tslabs["b"])) == \
        _error(lambda: jeng.embed_slot_carry(jpart, jqueued, jslabs["b"]))


# ---------------------------------------------------------------------------
# serving isolation
# ---------------------------------------------------------------------------
def _two_sessions(pkg, models=("a", "b")):
    return [_session(pkg, 0, 1, models[0]), _session(pkg, 1, 2, models[1])]


@functools.lru_cache(maxsize=None)
def _repro_two_model(backend):
    pool = _two_model_pool(J, backend)
    return _key(pool.serve(_two_sessions(J))), pool.fingerprint()


@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_two_model_pool_equals_solo_and_repro(backend):
    """Each session of the two-model pool equals that model served solo
    (queued: counts and latency; fabric: the prediction, as repro's test
    holds), and every session equals repro's two-model pool."""
    _, tcc = _poker()
    pool = _two_model_pool(T, backend)
    assert pool.engine.n_clusters == 12 and pool.engine.n_neurons == 3072
    got = _key(pool.serve(_two_sessions(T)))
    want, fingerprint = _repro_two_model(backend)
    assert got == want
    assert pool.fingerprint() == fingerprint
    solo = taer.AerSessionPool(tcc, taer.build_poker_engine(tcc.tables, backend, device="cpu"),
                               _cfg(T))
    alone = _key(solo.serve(_two_sessions(T, (None, None))))
    if backend == "reference":
        assert got == alone
    else:
        assert [r[1] for r in got] == [r[1] for r in alone]
        assert pool.engine._fabric_entries.dstk.numel() == 2 * 1280


def test_admission_needs_a_resident_model_name_as_repro():
    """Model identity is data: a mixed pool serves sessions of either model
    on the engine it was built with. A session without a model name is
    refused when several are resident, and an unknown name always."""
    mixed = _two_model_pool(T)
    engine = mixed.engine
    mixed.serve([_session(T, i, i % 4, "ab"[i % 2]) for i in range(4)])
    assert mixed.engine is engine and mixed.n_steps > 0
    pools = (_two_model_pool(J), _two_model_pool(T))
    for exc, model in ((ValueError, None), (KeyError, "zebra")):
        assert _error(lambda: pools[1].admit(_session(T, 0, 1, model)), exc) == \
            _error(lambda: pools[0].admit(_session(J, 0, 1, model)), exc)
    tcc = _poker()[1]
    solo = taer.AerSessionPool.from_models({"a": tcc}, _cfg(T), device="cpu")
    solo.admit(_session(T, 0, 1))
    assert solo.slots[0].model == "a" and solo.slots[0].counts.shape == (4,)
    default = taer.AerSessionPool(tcc, taer.build_poker_engine(tcc.tables, device="cpu"), _cfg(T))
    default.admit(_session(T, 0, 1))
    assert default.slots[0].model == "default" and list(default.slabs) == ["default"]


def _hot_load(pkg, backend):
    """repro's test_hot_load_under_live_sessions: two sessions on "a", four
    steps, load "b" live, drain; unload "a" and serve one session on "b"."""
    cc = _poker()[pkg is T]
    pool = pkg["aer"].AerSessionPool.from_models({"a": cc}, _cfg(pkg), backend=backend,
                                                 **pkg["kw"])
    pool.admit(_session(pkg, 0, 1, "a"))
    pool.admit(_session(pkg, 1, 2, "a"))
    for _ in range(4):
        pool.step()
    pool.load_model("b", cc)
    assert list(pool.models) == ["a", "b"]
    results = []
    while pool.occupied:
        pool.step()
        done = pool.finished_slots()
        if done:
            results.extend(pool.evict_many(done))
    pool.unload_model("a")
    assert list(pool.models) == ["b"]
    survivor = pool.serve([_session(pkg, 9, 3, "b")])
    return _key(results), _key(survivor), pool


@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_hot_load_under_live_sessions_equals_repro(backend):
    got, got_survivor, pool = _hot_load(T, backend)
    want, want_survivor, _ = _hot_load(J, backend)
    assert got == want and got_survivor == want_survivor
    assert len(got) == 2 and all(r[-1] is None for r in got)
    assert pool.engine.n_clusters == 6 and pool.slabs["b"].neuron_lo == 0
    if backend == "reference":  # queued mode: equal to an undisturbed run
        tcc = _poker()[1]
        undisturbed = taer.AerSessionPool.from_models({"a": tcc}, _cfg(T), device="cpu")
        assert got == _key(undisturbed.serve(_two_sessions(T, ("a", "a"))))


def test_unload_and_load_refusals_equal_repro():
    msgs = []
    for pkg in (J, T):
        cc = _poker()[pkg is T]
        aer = pkg["aer"]
        pool = _two_model_pool(pkg)
        pool.admit(_session(pkg, 0, 1, "a"))
        out = [_error(lambda: pool.unload_model("a"), RuntimeError),
               _error(lambda: pool.load_model("a", cc))]
        pool.evict(0)
        pool.unload_model("a")
        out += [_error(lambda: pool.unload_model("b")),
                _error(lambda: pool.unload_model("a"), KeyError)]
        fixed = aer.AerSessionPool(cc, aer.build_poker_engine(cc.tables, **pkg["kw"]), _cfg(pkg))
        out += [_error(lambda: fixed.load_model("b", cc), RuntimeError),
                _error(lambda: fixed.unload_model("default"), RuntimeError),
                _error(lambda: aer.AerSessionPool.from_models({}, _cfg(pkg), **pkg["kw"]))]
        msgs.append(out)
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_restore_refuses_a_retargeted_engine_and_another_model_set(tmp_path):
    _, tcc = _poker()
    pool = taer.AerSessionPool(tcc, taer.build_poker_engine(tcc.tables, device="cpu"), _cfg(T))
    pool.admit(_session(T, 0, 1))
    pool.step()
    ck = Checkpointer(str(tmp_path / "solo"))
    pool.checkpoint(ck, blocking=True)
    art = artifact_from_tables(
        tcc.tables, Geometry(grid_x=2, grid_y=2, cores_per_tile=2, neurons_per_core=256),
        optimize=False)
    retargeted = taer.build_poker_engine(art.tables, backend="fabric", device="cpu")
    with pytest.raises(taer.CheckpointMismatchError):
        taer.AerSessionPool.restore(tcc, retargeted, _cfg(T), ck)
    back = taer.AerSessionPool.restore(tcc, taer.build_poker_engine(tcc.tables, device="cpu"),
                                       _cfg(T), ck)
    assert back.n_steps == 1 and back.slots[0].model == "default"
    np.testing.assert_array_equal(back.slots[0].counts, pool.slots[0].counts)

    multi = _two_model_pool(T)
    multi.admit(_session(T, 0, 1, "a"))
    multi.step()
    ck2 = Checkpointer(str(tmp_path / "multi"))
    multi.checkpoint(ck2, blocking=True)
    with pytest.raises(taer.CheckpointMismatchError):
        taer.AerSessionPool.restore(tcc, taer.build_poker_engine(tcc.tables, device="cpu"),
                                    _cfg(T), ck2)
    swapped = _two_model_pool(T, order=("b", "a"))
    with pytest.raises(taer.CheckpointMismatchError, match="fingerprint"):
        taer.AerSessionPool.restore(tcc, swapped.engine, _cfg(T), ck2,
                                    models={"b": tcc, "a": tcc})


def test_repro_two_model_checkpoint_resumes_in_the_port(tmp_path):
    """repro's two-model pool checkpointed after 3 steps: the port's pool
    restores it (models=) and resumes to repro's decisions, and the port's
    own checkpoint of its pool round-trips bit-exactly."""
    jcc, tcc = _poker()
    jpool = jaer.AerSessionPool.from_models({"a": jcc, "b": jcc}, _cfg(J), donate_carry=False)
    for s in _two_sessions(J):
        jpool.admit(s)
    for _ in range(3):
        jpool.step()
    jck = JCheckpointer(str(tmp_path / "jax"))
    jpool.checkpoint(jck, blocking=True)
    models = {"a": tcc, "b": tcc}
    engine = taer.AerSessionPool._engine_for(
        models, {"backend": "reference", "device": "cpu", "faults": None,
                 "fabric_options": None, "autotune": None})
    back = taer.AerSessionPool.restore(tcc, engine, _cfg(T), Checkpointer(str(tmp_path / "jax")),
                                       models=models)
    assert [s.model for s in back.slots] == ["a", "b"] and back.n_steps == 3
    ck = Checkpointer(str(tmp_path / "port"))
    back.checkpoint(ck, blocking=True)
    again = taer.AerSessionPool.restore(tcc, engine, _cfg(T), ck, models=models)

    def finish(pool):
        out = []
        while pool.occupied:
            pool.step()
            done = pool.finished_slots()
            if done:
                out.extend(pool.evict_many(done))
        return _key(out)

    want = finish(jpool)
    assert finish(back) == want and finish(again) == want
