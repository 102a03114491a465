"""The port's compiler v2, memory model and one-call delivery against repro.

Host-side numpy in both packages, so every comparison is exact: tag
numbers, tables, placements and their ``info`` floats, report fields and
memory-model values are equal, and the same errors are raised. The
one-call delivery (``two_stage_deliver``) is held to repro's and to the
dense oracle.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiler as jcomp
from repro.core import memory_model as jmm
from repro.core import routing as jrouting
from repro.core import tags as jtags
from repro.core import two_stage as jtwo
from repro.core.event_engine import dense_weights_from_tables as j_dense_weights
from repro_torch.core import compiler as tcomp
from repro_torch.core import memory_model as tmm
from repro_torch.core import routing as trouting
from repro_torch.core import tags as ttags
from repro_torch.core import two_stage as ttwo
from repro_torch.core.event_engine import dense_weights_from_tables
from tests.test_torch_cnn import _assert_tables_equal, _random_spec

_REPORT_ARRAYS = ("tags_used", "tags_v1", "sram_fill", "cam_fill")
_REPORT_SCALARS = ("k_tags", "cluster_size", "sram_bits", "cam_bits",
                   "eq2_bits_per_neuron", "measured_bits_per_neuron", "mean_hops")


def _assert_reports_equal(j, t):
    for name in _REPORT_ARRAYS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in _REPORT_SCALARS:
        assert getattr(j, name) == getattr(t, name), name
    if j.tile_of_cluster is None:
        assert t.tile_of_cluster is None
    else:
        np.testing.assert_array_equal(j.tile_of_cluster, t.tile_of_cluster)
    assert j.summary() == t.summary()


def _both(fn, seed, **kw):
    """``fn(module, spec)`` on each package's spec: results, or errors."""
    out = []
    for tags in (jtags, ttags):
        try:
            out.append(fn(tags, _random_spec(tags.NetworkSpec, seed, **kw)))
        except ValueError as e:
            out.append(e)
    return out


def _assert_same(j, t):
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError) and str(t) == str(j)
    else:
        _assert_tables_equal(j, t)


# ---------------------------------------------------------------------------
# tag-reuse allocation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 42, 115, 2024])
def test_reuse_allocator_byte_equal(seed):
    j, t = _both(lambda m, s: m.compile_network(s, allocator="reuse"), seed)
    _assert_same(j, t)
    if not isinstance(t, ValueError):
        np.testing.assert_array_equal(j.dense_equivalent(), t.dense_equivalent())


def test_reuse_allocator_seed_sweep():
    """200 random specs: byte-equal tables (or the same error) under both
    allocators, and v2 never spends more SRAM or CAM than v1 where v1
    compiles."""
    for seed in range(200):
        for allocator in ("greedy", "reuse"):
            j, t = _both(lambda m, s: m.compile_network(s, allocator=allocator), seed)
            _assert_same(j, t)
        v1, v2 = (_both(lambda m, s: m.compile_network(s, allocator=a), seed)[1]
                  for a in ("greedy", "reuse"))
        if not isinstance(v1, ValueError):
            assert v2.sram_bits() <= v1.sram_bits() and v2.cam_bits() <= v1.cam_bits()


@pytest.mark.parametrize("seed", [0, 5, 115])
def test_allocate_tags_reuse_colors_equal(seed):
    got = []
    for tags, comp in ((jtags, jcomp), (ttags, tcomp)):
        spec = _random_spec(tags.NetworkSpec, seed)
        got.append(comp.allocate_tags_reuse(spec, tags.expand_units(spec)))
    (jt, ju), (tt, tu) = got
    assert jt == tt
    assert ju.dtype == tu.dtype and ju.tobytes() == tu.tobytes()


def test_seed_115_v1_error_and_v2_tables():
    """repro's v1 baseline cannot compile the seed-115 spec (its known
    hypothesis failure); the port raises the same text, and v2 compiles it
    to the same tables in both packages."""
    j, t = _both(lambda m, s: m.compile_network(s, allocator="greedy"), 115)
    assert isinstance(j, ValueError) and str(t) == str(j)
    assert "stage-1 fan-out exceeds F/M" in str(t)
    _assert_same(*_both(lambda m, s: m.compile_network(s, allocator="reuse"), 115))


def test_reuse_overflow_and_unknown_allocator_errors_match():
    for tags in (jtags, ttags):
        spec = tags.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=2, max_cam_words=4)
        for s in range(4):
            spec.connect(s, 4)
        with pytest.raises(ValueError, match="exhausted even with tag reuse"):
            tags.compile_network(spec, allocator="reuse")
    msgs = []
    for tags in (jtags, ttags):
        with pytest.raises(ValueError) as ei:
            tags.compile_network(tags.NetworkSpec(8, 4, 8), allocator="nope")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_table_bits_equal():
    j, t = _both(lambda m, s: m.compile_network(s), 3)
    assert (j.sram_bits(), j.cam_bits()) == (t.sram_bits(), t.cam_bits())
    assert t.sram_bits() > 0 and t.cam_bits() > 0


# ---------------------------------------------------------------------------
# traffic + placement
# ---------------------------------------------------------------------------
def _traffic_pair(seed, nc):
    rng = np.random.default_rng(seed)
    t = rng.random((nc, nc)) * (rng.random((nc, nc)) < 0.4)
    return t


@pytest.mark.parametrize("seed", [0, 1, 2, 9])
def test_optimize_placement_equal(seed):
    fab_j = jrouting.Fabric(grid_x=3, grid_y=2, cores_per_tile=3)
    fab_t = trouting.Fabric(grid_x=3, grid_y=2, cores_per_tile=3)
    traffic = _traffic_pair(seed, 12)
    pj, ij = jcomp.optimize_placement(traffic, fab_j, seed=seed, anneal_steps=600)
    pt, it = tcomp.optimize_placement(traffic, fab_t, seed=seed, anneal_steps=600)
    assert pj.dtype == pt.dtype and pj.tobytes() == pt.tobytes()
    assert ij == it
    assert it["cost_final"] <= it["cost_init"]


@pytest.mark.parametrize("seed", [3, 4])
def test_optimize_placement_slabs_and_allowed_tiles_equal(seed):
    fab_j = jrouting.Fabric(grid_x=4, grid_y=2, cores_per_tile=2)
    fab_t = trouting.Fabric(grid_x=4, grid_y=2, cores_per_tile=2)
    traffic = _traffic_pair(seed, 8)
    init = np.array([0, 0, 1, 1, 4, 4, 5, 5], np.int32)
    pj, ij = jcomp.optimize_placement(traffic, fab_j, init=init, seed=seed,
                                      anneal_steps=400, device_slabs=2)
    pt, it = tcomp.optimize_placement(traffic, fab_t, init=init, seed=seed,
                                      anneal_steps=400, device_slabs=2)
    assert pj.tobytes() == pt.tobytes() and ij == it
    allowed = np.array([True, True, False, True, True, False, True, True])
    init2 = np.array([0, 0, 1, 1, 3, 3, 4, 4], np.int32)
    pj, ij = jcomp.optimize_placement(traffic, fab_j, init=init2, seed=seed,
                                      anneal_steps=400, allowed_tiles=allowed)
    pt, it = tcomp.optimize_placement(traffic, fab_t, init=init2, seed=seed,
                                      anneal_steps=400, allowed_tiles=allowed)
    assert pj.tobytes() == pt.tobytes() and ij == it
    assert allowed[pt].all()
    for comp, fab in ((jcomp, fab_j), (tcomp, fab_t)):
        with pytest.raises(ValueError, match="symmetric"):
            comp.optimize_placement(traffic, fab, hop_matrix=np.triu(np.ones((8, 8))))
        with pytest.raises(ValueError, match="disallowed tiles"):
            comp.optimize_placement(traffic, fab, allowed_tiles=allowed)


def test_traffic_matrix_slab_placement_and_session_rate_equal():
    j, t = _both(lambda m, s: m.compile_network(s), 4)
    np.testing.assert_array_equal(jcomp.traffic_matrix(j), tcomp.traffic_matrix(t))
    rates = np.random.default_rng(1).random(t.n_neurons)
    np.testing.assert_array_equal(jcomp.traffic_matrix(j, rates),
                                  tcomp.traffic_matrix(t, rates))
    assert jcomp.session_rate(j) == tcomp.session_rate(t)
    fab_j = jrouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=1)
    fab_t = trouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=1)
    pj, ij = jcomp.device_slab_placement(j, fab_j, 2, seed=1, anneal_steps=200)
    pt, it = tcomp.device_slab_placement(t, fab_t, 2, seed=1, anneal_steps=200)
    assert pj.tobytes() == pt.tobytes() and ij == it
    with pytest.raises(ValueError, match="must divide"):
        tcomp.device_slab_placement(t, fab_t, 3)
    h = trouting.tile_hop_matrix(fab_t).astype(np.float64)
    traffic = tcomp.traffic_matrix(t)
    assert tcomp.placement_cost(traffic, h, pt) == jcomp.placement_cost(
        np.asarray(traffic), h, pj)


def test_repair_placement_not_ported():
    """Ported with faults and recovery: on a random spec, around a dead tile
    and a lossy link, the placement and report are repro's."""
    from repro.core import faults as jfaults
    from repro_torch.core import faults as tfaults

    t = ttags.compile_network(_random_spec(ttags.NetworkSpec, 0))
    j = jtags.compile_network(_random_spec(jtags.NetworkSpec, 0))
    kw = {"dead_tiles": (1,), "link_drop_rate": {(3, 4): 0.2}}
    pt, rt = tcomp.repair_placement(t, trouting.Fabric(), tfaults.FaultSpec(**kw), seed=2)
    pj, rj = jcomp.repair_placement(j, jrouting.Fabric(), jfaults.FaultSpec(**kw), seed=2)
    assert pt.tobytes() == pj.tobytes() and rt == rj


# ---------------------------------------------------------------------------
# compile report + v2 front-end, on the Table-IV shuffle network (smoke size)
# ---------------------------------------------------------------------------
def shuffle_spec(tags, grid=2, cluster=4, k=64):
    """benchmarks/routing_throughput.py's shuffle network: cluster c fans
    into cluster perm(c) through two connect-groups per source (seed 17)."""
    n_clusters = grid * grid * 4
    rng = np.random.default_rng(17)
    perm = rng.permutation(n_clusters)
    spec = tags.NetworkSpec(n_neurons=n_clusters * cluster, cluster_size=cluster, k_tags=k)
    fan = min(4, cluster)
    for s in range(spec.n_neurons):
        dst_cl = int(perm[s // cluster])
        for syn in (0, int(1 + rng.integers(3))):
            dsts = dst_cl * cluster + rng.choice(cluster, size=fan, replace=False)
            spec.connect_one_to_many(s, [int(d) for d in dsts], syn)
    return spec


def test_compile_network_v2_and_report_equal_on_shuffle_network():
    fab_j = jrouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=4)
    fab_t = trouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=4)
    rj = jcomp.compile_network_v2(shuffle_spec(jtags), fabric=fab_j, seed=0)
    rt = tcomp.compile_network_v2(shuffle_spec(ttags), fabric=fab_t, seed=0)
    for name in ("src_tag", "src_dest", "cam_tag", "cam_syn", "tile_of_cluster"):
        a, b = np.asarray(getattr(rj.tables, name)), getattr(rt.tables, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert rj.tables.fingerprint() == rt.tables.fingerprint()
    _assert_reports_equal(rj.report, rt.report)
    assert int(rt.report.tags_used.sum()) * 2 == int(rt.report.tags_v1.sum())
    assert rt.report.mean_hops is not None
    # a pinned placement, no fabric, and the v1 report on the same spec
    pin = np.arange(16, dtype=np.int32) // 4
    for kw in ({"tile_of_cluster": pin}, {"optimize": False}):
        rj = jcomp.compile_network_v2(shuffle_spec(jtags), fabric=fab_j, **kw)
        rt = tcomp.compile_network_v2(shuffle_spec(ttags), fabric=fab_t, **kw)
        assert rj.tables.fingerprint() == rt.tables.fingerprint()
        _assert_reports_equal(rj.report, rt.report)
    rj = jcomp.compile_network_v2(shuffle_spec(jtags))
    rt = tcomp.compile_network_v2(shuffle_spec(ttags))
    _assert_reports_equal(rj.report, rt.report)
    assert rt.report.mean_hops is None
    with pytest.raises(ValueError, match="requires a fabric"):
        tcomp.compile_network_v2(shuffle_spec(ttags), tile_of_cluster=pin)
    sj, st = shuffle_spec(jtags), shuffle_spec(ttags)
    _assert_reports_equal(jcomp.build_report(sj, jtags.compile_network(sj)),
                          tcomp.build_report(st, ttags.compile_network(st)))


@pytest.mark.parametrize("seed", [1, 6, 11])
def test_build_report_equal_on_random_specs(seed):
    j, t = _both(lambda m, s: m.compile_network(s, allocator="reuse"), seed)
    if isinstance(j, ValueError):
        pytest.fail(f"seed {seed} does not compile: {j}")
    _assert_reports_equal(
        jcomp.build_report(_random_spec(jtags.NetworkSpec, seed), j),
        tcomp.build_report(_random_spec(ttags.NetworkSpec, seed), t),
    )


def test_table_v_reuse_with_report_equal():
    """Table-V under v2: tables byte-equal to v1's (no two units share a
    source set), 512 tags either way, and the report equal to repro's."""
    from repro.core import cnn as jcnn
    from repro_torch.core import cnn as tcnn

    j = jcnn.compile_poker_cnn(allocator="reuse", with_report=True)
    t = tcnn.compile_poker_cnn(allocator="reuse", with_report=True)
    _assert_tables_equal(j.tables, t.tables)
    assert t.tables.fingerprint() == tcnn.compile_poker_cnn().tables.fingerprint()
    _assert_reports_equal(j.report, t.report)
    assert int(t.report.tags_used.sum()) == int(t.report.tags_v1.sum()) == 512
    assert round(t.report.measured_bits_per_neuron, 1) == 466.1
    assert round(t.report.eq2_bits_per_neuron, 1) == 778.5
    assert tcnn.compile_poker_cnn().report is None


# ---------------------------------------------------------------------------
# memory model
# ---------------------------------------------------------------------------
_GRID = [(n, f, c, m, k) for n in (64, 1024, 65536) for f in (16, 4096)
         for c in (16, 256) for m in (1, 8, 64) for k in (64, 1024)]


def test_memory_model_equal_on_grid():
    for n, f, c, m, k in _GRID:
        for name in ("mem_source_bits", "mem_total_bits"):
            assert getattr(jmm, name)(n, f, c, m, k) == getattr(tmm, name)(n, f, c, m, k)
        assert jmm.mem_target_bits(c, m, k) == tmm.mem_target_bits(c, m, k)
        for alpha in (0.5, 1.0, 4.0):
            assert jmm.mem_total_bits_alpha(n, f, c, m, alpha) == tmm.mem_total_bits_alpha(
                n, f, c, m, alpha)
            assert jmm.optimal_m(n, f, c, alpha) == tmm.optimal_m(n, f, c, alpha)
            assert jmm.optimal_m_integer(n, f, c, alpha) == tmm.optimal_m_integer(n, f, c, alpha)
            assert jmm.mem_at_optimal_m(n, f, c, alpha) == tmm.mem_at_optimal_m(n, f, c, alpha)
            assert jmm.feasible(n, f, c, alpha) == tmm.feasible(n, f, c, alpha)
        assert jmm.conventional_bits(n, f) == tmm.conventional_bits(n, f)
        assert jmm.constraint_c_lower_bound(n, f) == tmm.constraint_c_lower_bound(n, f)


def test_memory_model_params_equal():
    pj, pt = jmm.paper_prototype_params(), tmm.paper_prototype_params()
    assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
    for p in (pt, tmm.RoutingParams(n=1000, f=300, c=64, m=7, alpha=1.5)):
        q = jmm.RoutingParams(**dataclasses.asdict(p))
        assert (p.k, p.n_clusters, p.stage1_fanout, p.cam_words_per_neuron) == (
            q.k, q.n_clusters, q.stage1_fanout, q.cam_words_per_neuron)
    assert math.isclose(tmm.mem_at_optimal_m(1024, 4096, 256),
                        tmm.mem_total_bits_alpha(1024, 4096, 256,
                                                 tmm.optimal_m(1024, 4096, 256)))


# ---------------------------------------------------------------------------
# two_stage_deliver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend, queue", [("reference", None), ("reference", 5),
                                            ("fused", None), ("cuda", None)])
def test_two_stage_deliver_equal_to_repro_and_dense_oracle(backend, queue):
    """v2 tables of the shuffle network: the port's one-call delivery (on
    the CPU its kernel backends run their plain versions) equals repro's
    reference delivery and, with a lossless queue, the dense oracle."""
    res_j = jcomp.compile_network_v2(shuffle_spec(jtags))
    res_t = tcomp.compile_network_v2(shuffle_spec(ttags))
    t = res_t.tables
    rng = np.random.default_rng(3)
    spikes = (rng.random((3, t.n_neurons)) < 0.3).astype(np.float32)
    ext = (rng.integers(0, 3, (3, t.n_clusters, t.k_tags)) * 8.0).astype(np.float32)
    args = [torch.as_tensor(getattr(t, k)) for k in ("src_tag", "src_dest", "cam_tag", "cam_syn")]
    drive, stats = ttwo.two_stage_deliver(
        torch.as_tensor(spikes), *args, t.cluster_size, t.k_tags,
        external_activity=torch.as_tensor(ext), backend=backend, queue_capacity=queue,
        with_stats=True,
    )
    jt = res_j.tables
    want, jstats = jtwo.two_stage_deliver(
        jnp.asarray(spikes), *(jnp.asarray(getattr(jt, k)) for k in
                               ("src_tag", "src_dest", "cam_tag", "cam_syn")),
        jt.cluster_size, jt.k_tags, external_activity=jnp.asarray(ext),
        queue_capacity=queue, with_stats=True,
    )
    np.testing.assert_array_equal(drive.numpy(), np.asarray(want))
    np.testing.assert_array_equal(stats.dropped.numpy(), np.asarray(jstats.dropped))
    if queue is None:
        dense = torch.as_tensor(dense_weights_from_tables(t))
        np.testing.assert_array_equal(dense.numpy(), j_dense_weights(jt))
        oracle = torch.einsum("dst,bs->bdt", dense, torch.as_tensor(spikes))
        ext_drive = ttwo.stage2_cam_match(torch.as_tensor(ext), args[2], args[3], t.cluster_size)
        np.testing.assert_array_equal(drive.numpy(), (oracle + ext_drive).numpy())
        assert int(stats.dropped.sum()) == 0
    else:
        assert int(stats.dropped.sum()) > 0


def test_two_stage_deliver_tolerates_a_backend_without_the_newer_keywords():
    """A backend whose ``deliver`` lacks ``queue_capacity`` / ``syn_onehot``
    / ``with_stats``: both packages drop the one-hot hint, synthesize
    zero-drop stats, and refuse a queue capacity with the same words."""
    from repro.core import dispatch as jdisp
    from repro_torch.core import dispatch as tdisp

    def legacy(disp, stage2):
        class Legacy(disp.DispatchBackend):
            name = "legacy"

            def deliver(self, spikes, src_tag, src_dest, cam_tag, cam_syn, cluster_size,
                        k_tags, external_activity=None):
                return stage2(spikes, src_tag, src_dest, cam_tag, cam_syn, cluster_size,
                              k_tags, external_activity=external_activity)

        return Legacy()

    t = ttags.compile_network(_random_spec(ttags.NetworkSpec, 4))
    spikes = (np.random.default_rng(5).random((2, t.n_neurons)) < 0.4).astype(np.float32)
    names = ("src_tag", "src_dest", "cam_tag", "cam_syn")
    out = {}
    for key, two, disp, arr in (("t", ttwo, tdisp, torch.as_tensor),
                                ("j", jtwo, jdisp, jnp.asarray)):
        be = legacy(disp, two.two_stage_deliver)
        args = [arr(spikes)] + [arr(np.asarray(getattr(t, k))) for k in names]
        drive, stats = two.two_stage_deliver(*args, t.cluster_size, t.k_tags, backend=be,
                                             with_stats=True)
        with pytest.raises(ValueError, match="predates event-sparse delivery") as err:
            two.two_stage_deliver(*args, t.cluster_size, t.k_tags, backend=be, queue_capacity=4)
        out[key] = (np.asarray(drive), np.asarray(stats.dropped), str(err.value))
    for got, want in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(got, want)
    assert not out["t"][1].any()
