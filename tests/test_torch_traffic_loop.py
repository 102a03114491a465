"""The traffic feedback loop and the dispatch autotuner in the port against
repro.

* ``TrafficProfile`` folds the same ``DeliveryStats`` into the same
  matrices, rates and drift;
* the Table-V pool's ``profile`` (fabric engines with ``per_link_stats``)
  and ``fingerprint()`` equal repro's single-model pool's (registry name
  ``"default"``) in queued, ring and roll modes;
* the measure → optimize → recompile loop at a small pool (4 slots, 8
  steps) gives repro's link drops before and after, and its placement;
* ``autotune_backend`` with injected measurements gives repro's decision,
  ``token()`` and pool fingerprint, and ``backend="auto"`` refuses what
  repro refuses.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import compiler as jcomp
from repro.core import dispatch as jdisp
from repro.core import routing as jrouting
from repro.core import tags as jtags
from repro.core.event_engine import EventEngine as JEngine
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro_torch.core import cnn as tcnn
from repro_torch.core import compiler as tcomp
from repro_torch.core import dispatch as tdisp
from repro_torch.core import routing as trouting
from repro_torch.core import tags as ttags
from repro_torch.core.event_engine import EventEngine as TEngine
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer

_J = (jcnn, jcomp, jaer, jpipe, jrouting, {})
_T = (tcnn, tcomp, taer, tpipe, trouting, {"device": "cpu"})
STALE = np.array([0, 8, 2, 6, 4, 5], np.int32)  # benchmarks/serving.py's corners-first


def _sessions(aer, pipe, n, seed=23):
    rng = np.random.default_rng(seed)
    suits = rng.integers(0, 4, n)
    return [
        aer.DvsSession(i, pipe.DvsStreamSource(
            pipe.DvsStreamConfig(symbol=int(suits[i]), events_per_step=16, seed=seed),
            session_id=i), label=int(suits[i]))
        for i in range(n)
    ]


# ---------------------------------------------------------------------------
# TrafficProfile
# ---------------------------------------------------------------------------
def test_traffic_profile_equal_on_the_same_stats():
    rng = np.random.default_rng(0)
    nc, nt = 6, 9
    profiles = (jcomp.TrafficProfile.empty(nc, nt), tcomp.TrafficProfile.empty(nc, nt))
    for step in range(3):
        delivered = rng.integers(0, 20, (4, nc * nc)).astype(np.int32)
        link = rng.integers(0, 3, (4, nt * nt)).astype(np.int32)
        dropped = rng.integers(0, 2, 4).astype(np.int32)
        profiles[0].observe(jdisp.DeliveryStats(dropped=jnp.asarray(dropped),
                                                link_dropped=jnp.asarray(link),
                                                delivered=jnp.asarray(delivered)))
        profiles[1].observe(tdisp.DeliveryStats(dropped=torch.as_tensor(dropped),
                                                link_dropped=torch.as_tensor(link),
                                                delivered=torch.as_tensor(delivered)),
                            steps=1)
    j, t = profiles
    for name in ("pair_delivered", "link_dropped", "last"):
        assert getattr(j, name).tobytes() == getattr(t, name).tobytes(), name
    assert (j.dropped, j.steps, j.total_link_dropped) == (t.dropped, t.steps, t.total_link_dropped)
    np.testing.assert_array_equal(j.matrix(), t.matrix())
    tables = tcnn.compile_poker_cnn().tables
    np.testing.assert_array_equal(j.rates(jcnn.compile_poker_cnn().tables), t.rates(tables))
    assumed = tcomp.traffic_matrix(tables)
    assert j.drift(assumed) == t.drift(assumed) and 0.0 < t.drift(assumed) <= 1.0
    assert tcomp.TrafficProfile.empty(nc, nt).drift(assumed) == 0.0
    with pytest.raises(ValueError, match="per_link_stats"):
        t.observe(tdisp.DeliveryStats(dropped=torch.zeros(4), delivered=torch.zeros(4),
                                      link_dropped=torch.zeros(4)))


# ---------------------------------------------------------------------------
# the pool's profile and fingerprint
# ---------------------------------------------------------------------------
def _pool(pkg, mode, pool_size=3, tables_of=None, autotune=None):
    cnn, _, aer, *_, kw = pkg
    cc = cnn.compile_poker_cnn()
    if tables_of is not None:
        cc = dataclasses.replace(cc, tables=tables_of(cc.tables))
    if mode == "queued":
        eng = aer.build_poker_engine(cc.tables, "reference", **kw)
    elif mode == "auto":
        eng = aer.build_poker_engine(cc.tables, "auto", autotune=autotune, **kw)
    else:
        opts = {"per_link_stats": True, "link_capacity": 8, "ring": mode == "ring"}
        eng = aer.build_poker_engine(cc.tables, "fabric", fabric_options=opts, **kw)
    return aer.AerSessionPool(cc, eng, aer.AerServeConfig(pool_size=pool_size, max_steps=10**6))


@pytest.mark.parametrize("mode", ["queued", "ring", "roll"])
def test_pool_profile_and_fingerprint_equal_to_repro(mode):
    pools = {}
    for name, pkg in (("j", _J), ("t", _T)):
        pool = pools[name] = _pool(pkg, mode)
        for s in _sessions(pkg[2], pkg[3], 2):  # one slot stays empty
            pool.admit(s)
        for _ in range(4):
            pool.step()
    j, t = pools["j"], pools["t"]
    assert t.fingerprint() == j.fingerprint()
    if mode == "queued":
        assert j.profile is None and t.profile is None
        return
    for name in ("pair_delivered", "link_dropped", "last"):
        assert getattr(t.profile, name).tobytes() == getattr(j.profile, name).tobytes(), name
    assert (t.profile.dropped, t.profile.steps) == (j.profile.dropped, j.profile.steps) == (0.0, 4)
    assert t.profile.pair_delivered.sum() > 0


def test_pool_fingerprint_tracks_mode_size_and_tables():
    fps = {_pool(_T, m, pool_size=p).fingerprint() for m in ("queued", "ring", "roll")
           for p in (2, 3)}
    assert len(fps) == 6
    stale = _pool(_T, "ring", tables_of=lambda t: dataclasses.replace(t, tile_of_cluster=STALE))
    assert stale.fingerprint() not in fps
    # the fabric without per_link_stats keeps no profile
    cc = tcnn.compile_poker_cnn()
    eng = taer.build_poker_engine(cc.tables, "fabric", device="cpu")
    assert taer.AerSessionPool(cc, eng, taer.AerServeConfig(pool_size=2)).profile is None


# ---------------------------------------------------------------------------
# measure -> optimize -> recompile
# ---------------------------------------------------------------------------
def _feedback_loop(pkg, pool_size=4, steps=8):
    cnn, comp, aer, pipe, routing, kw = pkg
    cc = cnn.compile_poker_cnn()
    fo = {"link_capacity": 2, "per_link_stats": True}
    cfg = aer.AerServeConfig(pool_size=pool_size, max_steps=10**6)

    def serve(tables):
        pool = aer.AerSessionPool(
            dataclasses.replace(cc, tables=tables),
            aer.build_poker_engine(tables, "fabric", fabric_options=dict(fo), **kw), cfg)
        for s in _sessions(aer, pipe, pool_size):
            pool.admit(s)
        for _ in range(steps):
            pool.step()
        return pool

    before = serve(dataclasses.replace(cc.tables, tile_of_cluster=STALE))
    placement, info = comp.optimize_placement(before.profile.matrix(), routing.Fabric(),
                                              init=STALE, seed=0)
    after = serve(dataclasses.replace(cc.tables, tile_of_cluster=placement))
    return (before.profile.total_link_dropped, placement.tolist(), info,
            after.profile.total_link_dropped, before.fingerprint(), after.fingerprint(),
            [s.link_dropped for s in after.slots])


def test_feedback_loop_equal_to_repro():
    want, got = _feedback_loop(_J), _feedback_loop(_T)
    assert got == want
    drops_before, _, info, drops_after, fp_before, fp_after, _ = got
    assert drops_after < drops_before and fp_before != fp_after
    assert info["mean_hops_final"] < info["mean_hops_init"]


# ---------------------------------------------------------------------------
# the dispatch autotuner
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def _specs():
    out = []
    for tags in (jtags, ttags):
        rng = np.random.default_rng(0)
        spec = tags.NetworkSpec(n_neurons=64, cluster_size=8, k_tags=64)
        for _ in range(150):
            spec.connect(int(rng.integers(64)), int(rng.integers(64)), int(rng.integers(4)))
        out.append(tags.compile_network(spec))
    return tuple(out)


def _decide(disp, tables, measure, **kw):
    t = tables
    extra = {"device": "cpu"} if disp is tdisp else {}
    return disp.autotune_backend(t.src_tag, t.src_dest, t.cam_tag, t.cam_syn,
                                 t.cluster_size, t.k_tags, measure=measure, **kw, **extra)


_MEASURES = [
    ({"dense": 1.0, "queued": 2.0, "fused": 3.0}, {}),
    ({"dense": 2.0, "queued": 1.0, "fused": 3.0}, {}),
    ({"dense": 2.0, "queued": 2.0, "fused": 1.99}, {}),
    ({"dense": 1.04, "queued": 9.0, "fused": 1.0}, {}),
    ({"dense": 1.06, "queued": 9.0, "fused": 1.0}, {}),
    ({"dense": 3.0, "queued": 1.0, "fused": 2.0}, {"queue_capacity": 4, "activity": 0.5,
                                                    "batch": 32}),
    ({"fabric_ring": 0.5, "dense": 9.0}, {"candidates": ("dense", "fabric_ring")}),
]


@pytest.mark.parametrize("measure, kw", _MEASURES)
def test_injected_decision_equal_to_repro(measure, kw):
    j, t = (_decide(d, tab, measure, **kw) for d, tab in zip((jdisp, tdisp), _specs()))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.token() == j.token()
    assert tdisp.autotune_candidates() == jdisp.autotune_candidates()


@pytest.mark.parametrize("winner, on_card", [("dense", "cuda"), ("queued", "cuda"),
                                              ("fused", "fused")])
def test_card_decision_never_serves_the_plain_stage_2(winner, on_card):
    """Tuned for the card, a dense or queued winner is served by the
    cam_match kernel's backend; the decision and its token stay repro's,
    and on the CPU the mapping is repro's own."""
    t = _specs()[1]
    measure = {c: (1.0 if c == winner else 9.0) for c in ("dense", "queued", "fused")}
    card = tdisp.autotune_backend(t.src_tag, t.src_dest, t.cam_tag, t.cam_syn, t.cluster_size,
                                  t.k_tags, measure=measure, device="cuda")
    cpu = _decide(tdisp, t, measure)
    repro_d = _decide(jdisp, _specs()[0], measure)
    assert card.backend == on_card and cpu.backend == repro_d.backend
    assert card.token() == cpu.token() == repro_d.token() and card.dense == repro_d.dense
    assert tdisp.served_backend(cpu.backend, "cuda") == on_card
    assert tdisp.served_backend(cpu.backend, "cpu") == cpu.backend


def test_autotuner_refusals_match_repro():
    for disp, tables in zip((jdisp, tdisp), _specs()):
        with pytest.raises(ValueError, match="injected"):
            _decide(disp, tables, None, candidates=("fabric_ring",))
        with pytest.raises(ValueError, match="unknown autotune candidate"):
            _decide(disp, tables, None, candidates=("dense", "sparse"))
    for engine, tables, extra in ((JEngine, _specs()[0], {}),
                                  (TEngine, _specs()[1], {"device": "cpu"})):
        d = _decide(jdisp if engine is JEngine else tdisp, tables,
                    {"dense": 1.0, "queued": 2.0, "fused": 3.0})
        routing = jrouting if engine is JEngine else trouting
        with pytest.raises(ValueError, match="backend='auto'"):
            engine(tables, backend="reference", autotune={"decision": d}, **extra)
        with pytest.raises(ValueError, match="explicit backend"):
            engine(tables, backend="auto", fabric=routing.Fabric(grid_x=2, grid_y=1), **extra)
        with pytest.raises(ValueError, match="exclusive"):
            engine(tables, backend="auto", autotune={"decision": d, "activity": 0.5}, **extra)
    for aer, kw in ((jaer, {}), (taer, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not fabric"):
            aer.build_poker_engine(_specs()[0], "fabric", autotune={}, **kw)


def test_lossless_queue_aliases_queued_to_dense_on_the_cpu():
    """Timed on the CPU (the fused candidate injected): under a lossless
    queue the queued figure is dense's, copied, and dense wins the dead
    heat; a compacting queue times queued on its own."""
    t = _specs()[1]
    for cap in (None, t.n_neurons):
        d = _decide(tdisp, t, {"fused": 9e9}, queue_capacity=cap, iters=2)
        m = dict(d.measurements)
        assert m["queued"] == m["dense"] > 0 and d.winner == "dense"
    m = dict(_decide(tdisp, t, {"fused": 9e9}, queue_capacity=4, activity=1.0,
                     iters=2).measurements)
    assert m["queued"] != m["dense"]
    timed = _decide(tdisp, t, None, iters=1)
    assert timed.winner in tdisp.autotune_candidates()
    assert all(us > 0 for _, us in timed.measurements)


def _run(engine, module, tables, steps=6, batch=2, seed=1):
    """repro's tests/test_autotune.py ``_run``: every neuron kicked at step 0,
    later dynamics driven purely by delivered events."""
    rng = np.random.default_rng(seed)
    ev = (rng.random((steps, batch, tables.n_clusters, tables.k_tags)) < 0.2).astype(
        np.float32) * 4.0
    i_ext = np.zeros((steps, batch, tables.n_neurons), np.float32)
    i_ext[0] = 4e3
    if module == "j":
        carry, (spikes, stats) = engine.run(engine.init_state(batch=batch), jnp.asarray(ev),
                                            jnp.asarray(i_ext))
        return np.asarray(carry[0].v), np.asarray(spikes), np.asarray(stats.dropped)
    carry, (spikes, stats) = engine.run(engine.init_state(batch=batch), torch.as_tensor(ev),
                                        torch.as_tensor(i_ext))
    return carry[0].v.numpy(), spikes.numpy(), stats.dropped.numpy()


@pytest.mark.parametrize("winner", ["dense", "queued", "fused"])
def test_autotuned_engine_equal_to_repro(winner):
    """The built step honors the decision as repro's does: under a 4-deep
    queue a dense winner bypasses compaction (zero drops), a queued or
    fused winner compacts and drops; spikes and drops equal repro's."""
    measure = {c: (1.0 if c == winner else 9.0) for c in ("dense", "queued", "fused")}
    out = {}
    for name, disp, engine, tables, extra in (
            ("j", jdisp, JEngine, _specs()[0], {}),
            ("t", tdisp, TEngine, _specs()[1], {"device": "cpu"})):
        d = _decide(disp, tables, measure, queue_capacity=4)
        eng = engine(tables, backend="auto", queue_capacity=4, autotune={"decision": d}, **extra)
        assert eng.autotune_decision == d and eng._autotune_dense == (winner == "dense")
        out[name] = _run(eng, name, tables)
    (vj, sj, dj), (vt, st, dt) = out["j"], out["t"]
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-7)
    assert (int(dt.sum()) == 0) == (winner == "dense")


def test_autotuned_pool_fingerprint_equal_to_repro():
    for measure in ({"dense": 1.0, "queued": 2.0, "fused": 3.0},
                    {"dense": 2.0, "queued": 1.0, "fused": 3.0}):
        fps = []
        for pkg, disp in ((_J, jdisp), (_T, tdisp)):
            t = pkg[0].compile_poker_cnn().tables
            d = _decide(disp, t, measure)
            fps.append(_pool(pkg, "auto", autotune={"decision": d}).fingerprint())
        assert fps[0] == fps[1]
    assert fps[1] != _pool(_T, "queued").fingerprint()


def test_engine_accepts_compile_result_and_artifact():
    spec = ttags.NetworkSpec(n_neurons=32, cluster_size=8, k_tags=16)
    for s in range(32):
        spec.connect(s, (s * 5) % 32)
    res = tcomp.compile_network_v2(spec)
    art = tcomp.artifact_from_tables(res, tcomp.Geometry(grid_x=2, grid_y=1, cores_per_tile=2,
                                                         neurons_per_core=8, k_tags=16))
    for wrapped in (res, art):
        eng = TEngine(wrapped, device="cpu")
        assert eng.n_neurons == 32 and torch.equal(
            eng.tables.src_tag, torch.as_tensor(res.tables.src_tag))
