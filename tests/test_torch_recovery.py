"""Slot migration and pool recovery in the port against repro.

``EventEngine.extract_slots`` / ``splice_slots`` move slots between engines
in all four ring/roll combinations: from the same mid-flight carry (repro's,
carried across with ``convert.carry_from_numpy``) the port's ``SlotCarry``
arrays and spliced carries are bit-exact against repro's, and the moved
slots step on bit-exactly. The pool's checkpoint, kill and restore resumes
every session exactly as the uninterrupted run, in queued and fabric-ring
mode, with repro's results; the restore refuses a changed geometry and an
unknown stream source as repro's does.
"""

from collections import deque

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import routing as jrouting
from repro.core.cnn import compile_poker_cnn as j_compile_poker
from repro.core.event_engine import EventEngine as JEngine
from repro.core.neuron import NeuronParams as JParams
from repro.core.tags import NetworkSpec as JSpec, compile_network as j_compile
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import carry_from_numpy
from repro_torch.core import routing as trouting
from repro_torch.core.cnn import compile_poker_cnn as t_compile_poker
from repro_torch.core.event_engine import EventEngine as TEngine, SlotCarry
from repro_torch.core.faults import FaultSpec
from repro_torch.core.neuron import NeuronParams as TParams, NeuronState
from repro_torch.core.tags import NetworkSpec as TSpec, compile_network as t_compile
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer
from tests.test_faults import DT


def _two_tile(spec_cls, compile_fn, routing, hops_delay=2):
    const = routing.ChipConstants(latency_across_chip_s=hops_delay * DT)
    fab = routing.Fabric(grid_x=2, grid_y=1, cores_per_tile=1, constants=const)
    spec = spec_cls(n_neurons=8, cluster_size=4, k_tags=8, max_cam_words=64)
    spec.connect_group([0], [(4, 0)], shared_tag=False, copies=32)
    spec.connect_group([1], [(5, 0)], shared_tag=False, copies=32)
    spec.connect_group([2], [(3, 1)], shared_tag=False, copies=2)
    return compile_fn(spec, fabric=fab), fab


def _j_engine(ring, delay=2):
    tables, fab = _two_tile(JSpec, j_compile, jrouting, delay)
    return JEngine(tables, JParams(input_gain=3.0, dt=DT), fabric=fab, queue_capacity=8,
                   fabric_options={"dt": DT, "ring": ring})


def _t_engine(ring, delay=2):
    tables, fab = _two_tile(TSpec, t_compile, trouting, delay)
    return TEngine(tables, TParams(input_gain=3.0, dt=DT), fabric=fab, queue_capacity=8,
                   device="cpu", fabric_options={"dt": DT, "ring": ring})


def _i_ext(rng, batch):
    return ((rng.random((batch, 8)) < 0.5) * 5e3).astype(np.float32)


def _j_run(eng, batch, steps, seed):
    rng = np.random.default_rng(seed)
    carry = eng.init_state(batch=batch)
    for _ in range(steps):
        carry, _ = eng.step(carry, jnp.zeros((batch, 2, 8)), jnp.asarray(_i_ext(rng, batch)))
    return carry


def _leaves(carry) -> list[np.ndarray]:
    """Every array of a carry or SlotCarry (either package), as numpy."""
    state, *rest = carry
    names = ("v", "w", "refrac", "i_syn")
    out = [np.asarray(getattr(state, n)) for n in names]
    for x in rest:
        if x is not None:
            out.append(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
    return out


def _sc_leaves(sc) -> list[np.ndarray]:
    return _leaves((sc.state, sc.spikes, sc.inflight))


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# extract_slots / splice_slots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src_ring,dst_ring", [(True, True), (True, False),
                                               (False, True), (False, False)])
def test_extract_splice_cross_mode_bit_exact_against_repro(src_ring, dst_ring):
    """A slot extracted mid-run (events in flight, ring cursor mid-phase) is
    phase-normalized as repro's is, splices into a fresh engine of either
    mode as repro's does, and steps on bit-exactly."""
    j_src, j_dst = _j_engine(src_ring), _j_engine(dst_ring)
    t_src, t_dst = _t_engine(src_ring), _t_engine(dst_ring)
    carry_j = _j_run(j_src, 2, 5, seed=0)  # 5 % (max_delay + 1) != 0
    sc_j = j_src.extract_slots(carry_j, [1, 0])
    assert np.asarray(sc_j.inflight).any()  # events genuinely in flight
    carry_t = carry_from_numpy(jax.tree.map(np.asarray, carry_j), device="cpu")
    sc_t = t_src.extract_slots(carry_t, [1, 0])
    assert isinstance(sc_t, SlotCarry) and isinstance(sc_t.state, NeuronState)
    _assert_bit_equal(_sc_leaves(sc_t), _sc_leaves(sc_j))

    moved_j = j_dst.splice_slots(j_dst.init_state(batch=2), [1, 0], sc_j)
    moved_t = t_dst.splice_slots(t_dst.init_state(batch=2), [1, 0], sc_t)
    _assert_bit_equal(_leaves(moved_t), _leaves(moved_j))

    rng_a, rng_b = np.random.default_rng(7), np.random.default_rng(7)
    zeros = torch.zeros((2, 2, 8))
    for _ in range(6):
        carry_t, (sa, _) = t_src.step(carry_t, zeros, torch.as_tensor(_i_ext(rng_a, 2)))
        moved_t, (sb, _) = t_dst.step(moved_t, zeros, torch.as_tensor(_i_ext(rng_b, 2)))
        assert torch.equal(sa, sb)


@pytest.mark.parametrize("src_delay,dst_delay", [(2, 1), (1, 2), (3, 1)])
def test_splice_rebuckets_across_delay_horizons_as_repro(src_delay, dst_delay):
    """Engines of different ``max_delay``: shorter horizons gain zero tail
    slots, longer ones fold the excess tail into the last slot, on ring and
    roll targets, bit-exact against repro."""
    for dst_ring in (True, False):
        j_src = _j_engine(True, src_delay)
        carry_j = _j_run(j_src, 2, 5, seed=0)
        sc_j = j_src.extract_slots(carry_j, [0, 1])
        assert np.asarray(sc_j.inflight).any()
        sc_t = _t_engine(True, src_delay).extract_slots(
            carry_from_numpy(jax.tree.map(np.asarray, carry_j), device="cpu"), [0, 1])
        j_dst, t_dst = _j_engine(dst_ring, dst_delay), _t_engine(dst_ring, dst_delay)
        base_j = _j_run(j_dst, 2, 3, seed=5)  # a target cursor away from 0
        base_t = carry_from_numpy(jax.tree.map(np.asarray, base_j), device="cpu")
        _assert_bit_equal(_leaves(t_dst.splice_slots(base_t, [0, 1], sc_t)),
                          _leaves(j_dst.splice_slots(base_j, [0, 1], sc_j)))


def test_splice_leaves_unlisted_slots_untouched():
    eng = _t_engine(True)
    carry = carry_from_numpy(jax.tree.map(np.asarray, _j_run(_j_engine(True), 3, 4, seed=2)),
                             device="cpu")
    before = [x.clone() for x in _torch_leaves(carry)]
    sc = eng.extract_slots(carry, [1])
    target = eng.splice_slots(carry, [2], sc)  # copy slot 1 onto slot 2
    for cur, new, was in zip(_torch_leaves(carry), _torch_leaves(target), before):
        assert torch.equal(cur, was)  # the carry passed in is not written
        if cur.ndim == 0:  # the shared ring cursor
            assert torch.equal(cur, new)
            continue
        assert torch.equal(cur[0], new[0]) and torch.equal(cur[1], new[1])
        assert torch.equal(cur[1], new[2])


def _torch_leaves(carry):
    state, *rest = carry
    return [state.v, state.w, state.refrac, state.i_syn, *rest]


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_extract_splice_validation_errors_equal_repro():
    j_eng, t_eng = _j_engine(True), _t_engine(True)
    j_carry, t_carry = j_eng.init_state(batch=2), t_eng.init_state(batch=2)
    j_sc, t_sc = j_eng.extract_slots(j_carry, [0]), t_eng.extract_slots(t_carry, [0])
    cases = [
        (lambda: j_eng.extract_slots(j_carry, [0, 0]),
         lambda: t_eng.extract_slots(t_carry, [0, 0])),
        (lambda: j_eng.extract_slots(j_carry, [5]), lambda: t_eng.extract_slots(t_carry, [5])),
        (lambda: j_eng.extract_slots(j_carry, []), lambda: t_eng.extract_slots(t_carry, [])),
        (lambda: j_eng.extract_slots(j_eng.init_state(), [0]),
         lambda: t_eng.extract_slots(t_eng.init_state(), [0])),
        (lambda: j_eng.splice_slots(j_carry, [0, 1], j_sc),
         lambda: t_eng.splice_slots(t_carry, [0, 1], t_sc)),
    ]
    for fj, ft in cases:
        assert _error(ft) == _error(fj)
    # a SlotCarry of another network: neuron count, state leaf and grid
    j_other = JEngine(j_compile_poker().tables, JParams())
    t_other = TEngine(t_compile_poker().tables, TParams(), device="cpu")
    assert _error(lambda: t_other.splice_slots(t_other.init_state(batch=2), [0], t_sc)) == \
        _error(lambda: j_other.splice_slots(j_other.init_state(batch=2), [0], j_sc))
    bad = SlotCarry(state=NeuronState(**{k: np.zeros((1, 7), np.float32)
                                         for k in ("v", "w", "refrac", "i_syn")}),
                    spikes=t_sc.spikes, inflight=t_sc.inflight)
    assert "a mismatched leaf must raise" in _error(lambda: t_eng.splice_slots(t_carry, [0], bad))
    grid = SlotCarry(state=t_sc.state, spikes=t_sc.spikes,
                     inflight=np.zeros((1, 2, 3, 8), np.float32))
    assert "in-flight grid" in _error(lambda: t_eng.splice_slots(t_carry, [0], grid))
    tables, _ = _two_tile(TSpec, t_compile, trouting)
    queued = TEngine(tables, TParams(dt=DT), queue_capacity=8, device="cpu")
    live = _t_engine(True).extract_slots(carry_from_numpy(
        jax.tree.map(np.asarray, _j_run(_j_engine(True), 1, 3, seed=1)), device="cpu"), [0])
    assert "no fabric delay line" in _error(
        lambda: queued.splice_slots(queued.init_state(batch=1), [0], live))
    assert queued.extract_slots(queued.init_state(batch=1), [0]).inflight is None


# ---------------------------------------------------------------------------
# checkpointed pool recovery
# ---------------------------------------------------------------------------
def _sessions(aer, pipe, n, seed=11):
    return [
        aer.DvsSession(
            i, pipe.DvsStreamSource(pipe.DvsStreamConfig(symbol=i % 4, events_per_step=16,
                                                         seed=seed), session_id=i),
            label=i % 4,
        )
        for i in range(n)
    ]


def _result_key(results):
    return sorted((r.session_id, r.prediction, r.latency_steps, r.decided,
                   tuple(r.counts), r.dropped, r.link_dropped) for r in results)


@pytest.fixture(scope="module")
def compiled():
    return j_compile_poker(), t_compile_poker()


def _kill_and_restore(cc, make_engine, cfg, ck, sessions, kill_at=5):
    """Serve ``sessions``; at engine step ``kill_at`` checkpoint, drop the
    pool and its engine, rebuild both and restore, then serve on."""
    pool = taer.AerSessionPool(cc, make_engine(), cfg)
    pending = deque(sessions)
    results, killed, k = [], False, 0
    while pending or pool.occupied:
        while pending and pool.free_slots:
            pool.admit(pending.popleft())
        pool.step()
        k += 1
        if k == kill_at and not killed:
            pool.checkpoint(ck, blocking=True)
            del pool
            pool = taer.AerSessionPool.restore(cc, make_engine(), cfg, ck)
            assert pool.n_steps == kill_at and len(pool.occupied) == cfg.pool_size
            killed = True
        finished = pool.finished_slots()
        if finished:
            results.extend(pool.evict_many(finished))
    assert killed
    return results


@pytest.mark.parametrize("mode", ["queued", "fabric", "fabric-dead25"])
def test_kill_restore_resumes_bit_exact_and_equals_repro(mode, compiled, tmp_path):
    jcc, tcc = compiled
    backend = "reference" if mode == "queued" else "fabric"
    faults = {}
    if mode == "fabric-dead25":
        from repro.core.faults import FaultSpec as JFaultSpec
        from tests.test_faults import DEAD25

        faults = {"j": {"faults": JFaultSpec(dead_links=DEAD25)},
                  "t": {"faults": FaultSpec(dead_links=DEAD25)}}
    cfg_kw = {"pool_size": 2, "max_steps": 20}
    j_eng = jaer.build_poker_engine(jcc.tables, backend=backend, donate_carry=False,
                                    **faults.get("j", {}))
    want = jaer.AerSessionPool(jcc, j_eng, jaer.AerServeConfig(**cfg_kw)).serve(
        _sessions(jaer, jpipe, 4))

    def make_engine():
        return taer.build_poker_engine(tcc.tables, backend=backend, device="cpu",
                                       **faults.get("t", {}))

    cfg = taer.AerServeConfig(**cfg_kw)
    straight = taer.AerSessionPool(tcc, make_engine(), cfg).serve(_sessions(taer, tpipe, 4))
    ck = Checkpointer(str(tmp_path))
    resumed = _kill_and_restore(tcc, make_engine, cfg, ck, _sessions(taer, tpipe, 4))
    assert _result_key(resumed) == _result_key(straight) == _result_key(want)
    if mode == "fabric-dead25":
        assert sum(r.link_dropped for r in resumed) > 0
    # the same on-disk layout as repro's checkpointer: repro reads the meta blob
    step = ck.latest_step()
    blob = JCheckpointer(str(tmp_path)).restore(step, {"session_meta": np.zeros(0, np.uint8)})
    meta = np.asarray(blob["session_meta"]).astype(np.uint8).tobytes().decode()
    assert '"pool_size": 2' in meta and '"model": "default"' in meta


def test_restore_refuses_a_changed_geometry(compiled, tmp_path):
    _, tcc = compiled
    cfg = taer.AerServeConfig(pool_size=2, max_steps=20)
    ring = taer.build_poker_engine(tcc.tables, "fabric", device="cpu")
    pool = taer.AerSessionPool(tcc, ring, cfg)
    for s in _sessions(taer, tpipe, 2):
        pool.admit(s)
    pool.step()
    ck = Checkpointer(str(tmp_path))
    pool.checkpoint(ck, blocking=True)
    roll = taer.build_poker_engine(tcc.tables, "fabric", device="cpu",
                                   fabric_options={"ring": False})
    queued = taer.build_poker_engine(tcc.tables, device="cpu")
    with pytest.raises(taer.CheckpointMismatchError, match="does not fit the restoring"):
        taer.AerSessionPool.restore(tcc, roll, cfg, ck)  # the delay line changed shape
    with pytest.raises(taer.CheckpointMismatchError, match="fingerprint"):
        taer.AerSessionPool.restore(tcc, queued, cfg, ck)  # another delivery mode
    with pytest.raises(taer.CheckpointMismatchError, match="does not fit the restoring"):
        taer.AerSessionPool.restore(tcc, ring, taer.AerServeConfig(pool_size=3), ck)
    pool3 = taer.AerSessionPool(tcc, ring, taer.AerServeConfig(pool_size=3))
    with pytest.raises(taer.CheckpointMismatchError, match="pool_size=2"):
        pool3.load_snapshot_tree({"carry": pool3.carry,
                                  "session_meta": pool.snapshot_tree()["session_meta"]})
    assert pool3.slots == [None] * 3  # a refused restore installs nothing
    assert issubclass(taer.CheckpointMismatchError, ValueError)
    back = taer.AerSessionPool.restore(tcc, ring, cfg, ck)
    assert [s.step for s in back.slots] == [1, 1] and back.n_steps == 1


def test_restore_unknown_source_requires_factory(compiled, tmp_path):
    _, tcc = compiled
    cfg = taer.AerServeConfig(pool_size=2, max_steps=20)
    eng = taer.build_poker_engine(tcc.tables, device="cpu")
    pool = taer.AerSessionPool(tcc, eng, cfg)

    class _Opaque:
        def events(self, step):
            return np.array([[15, 15]])

    pool.admit(taer.DvsSession(0, _Opaque(), label=1))
    pool.step()
    ck = Checkpointer(str(tmp_path))
    pool.checkpoint(ck, blocking=True)
    with pytest.raises(TypeError, match="source_factory"):
        taer.AerSessionPool.restore(tcc, eng, cfg, ck)
    rebuilt = taer.AerSessionPool.restore(tcc, eng, cfg, ck,
                                          source_factory=lambda meta: _Opaque())
    assert rebuilt.slots[0].session_id == 0 and rebuilt.slots[0].step == 1
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        taer.AerSessionPool.restore(tcc, eng, cfg, Checkpointer(str(tmp_path / "empty")))


def test_session_from_meta_checks_the_model():
    meta = {"session_id": 3, "label": 1, "model": "other", "step": 2, "counts": [0, 1, 0, 0],
            "dropped": 0, "link_dropped": 0, "error": None,
            "source": {"kind": "dvs_stream", "cfg": {"symbol": 1}, "session_id": 3}}
    with pytest.raises(taer.CheckpointMismatchError, match="not resident"):
        taer.session_from_meta(meta, ["default"], slot=0)
    sess = taer.session_from_meta({**meta, "model": None}, ["default"], slot=0)
    assert sess.step == 2 and sess.source.cfg.symbol == 1 and sess.counts.dtype == np.float64


def test_pool_typed_errors_and_quarantine_equal_repro(compiled):
    from repro.core.faults import FaultSpec as JFaultSpec

    messages = []
    for aer, pipe, cc, spec, kw in (
        (jaer, jpipe, compiled[0], JFaultSpec, {"donate_carry": False}),
        (taer, tpipe, compiled[1], FaultSpec, {"device": "cpu"}),
    ):
        pool = aer.AerSessionPool(cc, aer.build_poker_engine(cc.tables, **kw),
                                  aer.AerServeConfig(pool_size=2, max_steps=20))
        sessions = _sessions(aer, pipe, 3)
        pool.admit(sessions[0])
        pool.admit(sessions[1])
        out = []
        for fn in (lambda: pool.admit(sessions[2]), lambda: pool.quarantine_slot(0),
                   lambda: pool.quarantine_slot(-1)):
            with pytest.raises((aer.PoolFullError, aer.SlotError)) as e:
                fn()
            out.append((type(e.value).__name__, str(e.value)))
        pool.evict(0)
        pool.quarantine_slot(0)
        assert pool.free_slots == [] and pool.quarantined == {0}
        with pytest.raises(aer.PoolFullError) as e:
            pool.admit(sessions[2])
        out.append(str(e.value))
        with pytest.raises(ValueError) as e:
            aer.build_poker_engine(cc.tables, backend="reference",
                                   faults=spec(dead_links=((0, 1),)), **kw)
        out.append(str(e.value))
        messages.append(out)
    assert messages[1] == messages[0]


def test_extract_inject_session_between_ring_and_roll_pools(compiled):
    """A session moved mid-flight from a ring pool to a roll pool (and one
    moved back) finishes exactly as in an uninterrupted ring pool."""
    _, tcc = compiled
    cfg = taer.AerServeConfig(pool_size=2, max_steps=20)
    ring = taer.build_poker_engine(tcc.tables, "fabric", device="cpu")
    roll = taer.build_poker_engine(tcc.tables, "fabric", device="cpu",
                                   fabric_options={"ring": False})
    want = taer.AerSessionPool(tcc, ring, cfg).serve(_sessions(taer, tpipe, 2))
    a, b = taer.AerSessionPool(tcc, ring, cfg), taer.AerSessionPool(tcc, roll, cfg)
    for s in _sessions(taer, tpipe, 2):
        a.admit(s)
    for _ in range(3):
        a.step()
    sess, sc = a.extract_session(1)
    assert a.slots[1] is None and float(a.carry[0].v[1, 0]) == float(
        ring.init_state(batch=1)[0].v[0, 0])  # the vacated slot is wiped
    b.n_steps = a.n_steps
    assert b.inject_session(sess, sc) == 0
    results = []
    for _ in range(2):
        a.step()
        b.step()
    sess2, sc2 = b.extract_session(0)
    a.inject_session(sess2, sc2)
    while a.occupied:
        a.step()
        results.extend(a.evict_many(a.finished_slots()))
    assert _result_key(results) == _result_key(want)
    with pytest.raises(taer.SlotError, match="not occupied"):
        b.extract_session(0)
    with pytest.raises(ValueError, match="admit_restored needs"):
        b.admit_restored(_sessions(taer, tpipe, 1)[0])
