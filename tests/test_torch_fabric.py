"""The fabric slice of the port against repro: routing model, placement,
static entry table, the ring step (against repro's Pallas ``fabric_deliver``
kernel in interpret mode), ring vs roll, the fabric EventEngine, and the
Table-V pool served over the fabric.

Tolerances: drives, rings, arrival steps and every integer stat
(``dropped``, ``link_dropped``, ``delivered``, ``hops``) are bit-exact:
weights are 0/1 spikes and external input is an integer count times 8.0, so
every sum is an integer below 2**24, exact in float32 in any order. The
float latency/energy sums add the same float32 terms in another order:
``allclose(rtol=1e-5)``. Neuron state is held per step from the same carry
at ``allclose(rtol=1e-5, atol=1e-7)`` (ROADMAP queue 3 says why a
free-running state is not).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import event_engine as jee
from repro.core import routing as jrouting
from repro.core import two_stage as jts
from repro.core.tags import NetworkSpec as JSpec
from repro.core.tags import compile_network as j_compile
from repro.kernels.fabric_deliver import ops as jops
from repro.kernels.fabric_deliver.ref import fabric_deliver_ring_ref as j_ring_ref
from repro_torch.convert import carry_from_numpy, params_from_jax, state_from_numpy, tables_from_numpy
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import event_engine as tee
from repro_torch.core import neuron as tneuron
from repro_torch.core import routing as trouting
from repro_torch.core import two_stage as tts
from repro_torch.core.tags import NetworkSpec as TSpec
from repro_torch.core.tags import compile_network as t_compile
from repro_torch.kernels.fabric_deliver import ops as tops
from repro_torch.kernels.fabric_deliver.ref import fabric_deliver_ring_ref as t_ring_ref

from tests._hypothesis_compat import given, settings, st

DT = 1e-3
INT_STATS = ("dropped", "link_dropped", "delivered", "hops")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _fabric(mod, gx, gy, cpt, latency_mult=1.0):
    return mod.Fabric(
        grid_x=gx, grid_y=gy, cores_per_tile=cpt,
        constants=mod.ChipConstants(latency_across_chip_s=latency_mult * DT),
    )


def _random_tables(rng, n, n_clusters, k, e=3, s=4):
    src_tag = rng.integers(-1, k, (n, e)).astype(np.int32)
    src_dest = rng.integers(0, n_clusters, (n, e)).astype(np.int32)
    cam_tag = rng.integers(-1, k, (n, s)).astype(np.int32)
    cam_syn = rng.integers(0, 4, (n, s)).astype(np.int32)
    return src_tag, src_dest, cam_tag, cam_syn


def _assert_stats_equal(got, want, msg, int_fields=INT_STATS):
    for f in int_fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f"{msg}: {f}"
        )
    for f in ("latency_s", "energy_j"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), rtol=1e-5,
            err_msg=f"{msg}: {f}",
        )


# ---------------------------------------------------------------------------
# routing model and placement
# ---------------------------------------------------------------------------
_GEOMETRIES = [  # (grid_x, grid_y, cores_per_tile, n_clusters, latency x dt)
    (3, 3, 4, 6, 0.0154),  # the Table-V default: max_delay 1
    (2, 2, 1, 4, 1.0),
    (3, 2, 2, 11, 2.0),
    (4, 1, 3, 9, 0.5),
]


@pytest.mark.parametrize("geom", _GEOMETRIES)
@pytest.mark.parametrize("placement", ["default", "shuffled"])
@pytest.mark.parametrize("link_capacity", [None, 3])
def test_delivery_model_matches_repro(geom, placement, link_capacity):
    gx, gy, cpt, nc, lat = geom
    jf, tf = _fabric(jrouting, gx, gy, cpt, lat), _fabric(trouting, gx, gy, cpt, lat)
    tiles = None
    if placement == "shuffled":
        slots = np.repeat(np.arange(jf.n_tiles), cpt)
        tiles = np.random.default_rng(nc).permutation(slots)[:nc].astype(np.int32)
    j = jrouting.build_delivery_model(jf, nc, DT, tile_of_cluster=tiles, link_capacity=link_capacity)
    t = trouting.build_delivery_model(tf, nc, DT, tile_of_cluster=tiles, link_capacity=link_capacity)
    for f in ("tile_of_cluster", "mesh_hops", "delay_steps"):
        assert getattr(t, f).dtype == getattr(j, f).dtype
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert (t.n_tiles, t.max_delay, t.link_capacity) == (j.n_tiles, j.max_delay, j.link_capacity)
    for f in ("latency_s", "energy_j"):
        assert getattr(t, f).dtype == np.float32
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=1e-7, err_msg=f)
    assert t.pair_alive is None and t.pair_drop_rate is None
    np.testing.assert_array_equal(trouting.tile_hop_matrix(tf), jrouting.tile_hop_matrix(jf))
    assert trouting.avg_distance_mesh(64) == jrouting.avg_distance_mesh(64)
    assert trouting.avg_distance_hierarchical(64) == jrouting.avg_distance_hierarchical(64)


@pytest.mark.parametrize(
    "tiles, n_clusters, match",
    [
        ([0, 1, 2], 4, "shape"),
        ([0, 9, 1, 2], 4, "tile ids"),
        ([-1, 0, 1, 2], 4, "tile ids"),
        ([0, 0, 0, 0, 0], 5, "clusters on one tile"),
    ],
)
def test_validate_placement_errors_match_repro(tiles, n_clusters, match):
    for mod in (jrouting, trouting):
        with pytest.raises(ValueError, match=match):
            mod.validate_placement(mod.Fabric(), n_clusters, np.asarray(tiles))
    for mod in (jrouting, trouting):
        with pytest.raises(ValueError, match="do not fit"):
            mod.default_tile_of_cluster(37, mod.Fabric())
        with pytest.raises(ValueError, match="dt must be positive"):
            mod.build_delivery_model(mod.Fabric(), 4, 0.0)
        with pytest.raises(ValueError, match="link_capacity must be positive"):
            mod.build_delivery_model(mod.Fabric(), 4, DT, link_capacity=0)


def test_faults_are_not_ported_yet():
    """Faults are ported now (tests/test_torch_faults.py): the delivery
    model carries repro's fault matrices, and the backend checks the spec
    against its fabric as repro's does."""
    from repro.core import dispatch as jdispatch
    from repro.core import faults as jfaults
    from repro_torch.core import faults as tfaults

    kw = {"dead_links": ((0, 1),), "link_drop_rate": 0.1, "seed": 1}
    jm = jrouting.build_delivery_model(jrouting.Fabric(), 4, DT, faults=jfaults.FaultSpec(**kw))
    tm = trouting.build_delivery_model(trouting.Fabric(), 4, DT, faults=tfaults.FaultSpec(**kw))
    assert tm.pair_alive.tobytes() == jm.pair_alive.tobytes()
    assert tm.pair_drop_rate.tobytes() == jm.pair_drop_rate.tobytes()
    bad = {"dead_links": ((0, 4),)}
    with pytest.raises(ValueError) as want:
        jdispatch.FabricBackend(faults=jfaults.FaultSpec(**bad))
    with pytest.raises(ValueError, match="not a directed adjacent mesh link") as got:
        tdispatch.FabricBackend(faults=tfaults.FaultSpec(**bad))
    assert str(got.value) == str(want.value)


def _spec_pair(seed, n=48, cluster=8, k=32, edges=80):
    rng = np.random.default_rng(seed)
    specs = [mod(n_neurons=n, cluster_size=cluster, k_tags=k, max_cam_words=24,
                 max_sram_entries=16) for mod in (JSpec, TSpec)]
    seen = set()
    for _ in range(edges):
        s, d = int(rng.integers(n)), int(rng.integers(n))
        if (s, d) not in seen:
            seen.add((s, d))
            syn = int(rng.integers(4))
            for spec in specs:
                spec.connect(s, d, syn)
    return specs


@pytest.mark.parametrize("tiles", [None, [1, 0, 3, 2, 2, 0]])
def test_compile_with_placement_byte_equal(tiles):
    jspec, tspec = _spec_pair(3)
    j = j_compile(jspec, fabric=jrouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=2),
                  tile_of_cluster=tiles)
    t = t_compile(tspec, fabric=trouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=2),
                  tile_of_cluster=tiles)
    for f in ("src_tag", "src_dest", "cam_tag", "cam_syn", "tile_of_cluster"):
        a, b = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert t.fingerprint() == j.fingerprint()
    assert t.fingerprint() != t_compile(tspec).fingerprint()  # the placement is hashed
    with pytest.raises(ValueError, match="clusters on one tile"):
        t_compile(tspec, fabric=trouting.Fabric(grid_x=2, grid_y=2, cores_per_tile=1),
                  tile_of_cluster=[0, 0, 1, 2, 3, 3])


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", [1, 2, 5])
def test_dispatch_slots_matches_repro(cap):
    rng = np.random.default_rng(cap)
    flat = rng.integers(-2, 9, (4, 40)).astype(np.int32)  # bins 0..6; 7, 8 and < 0 inactive
    got_slot, got_keep = tts.dispatch_slots(_t(flat), 7, cap)
    for row in range(flat.shape[0]):
        want_slot, want_keep = jts.dispatch_slots(jnp.asarray(flat[row]), 7, cap)
        np.testing.assert_array_equal(got_slot[row].numpy(), np.asarray(want_slot))
        np.testing.assert_array_equal(got_keep[row].numpy(), np.asarray(want_keep))


def test_accumulate_into_and_scatter_count_match_repro():
    rng = np.random.default_rng(6)
    b, size, m = 3, 40, 25
    buf = rng.integers(0, 5, (b, size)).astype(np.float32)
    flat = rng.integers(-3, size + 3, (b, m)).astype(np.int32)  # some out of range
    w = rng.integers(0, 3, (b, m)).astype(np.float32)
    # repro's scatter takes in-range indices only; an out-of-range index is
    # dropped here, which must equal adding nothing
    ok = (flat >= 0) & (flat < size)
    j_flat, j_w = jnp.asarray(np.where(ok, flat, 0)), jnp.asarray(np.where(ok, w, 0))
    got = tts._accumulate_into(_t(buf), _t(flat), _t(w))
    want = jts._accumulate_into(jnp.asarray(buf), j_flat, j_w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    row = np.clip(flat[0], 0, size - 1)  # [M] batch-shared indices
    shared = tts._accumulate_into(_t(buf), _t(row), _t(w))
    want = jts._accumulate_into(jnp.asarray(buf), jnp.asarray(row), jnp.asarray(w))
    np.testing.assert_array_equal(shared.numpy(), np.asarray(want))
    mask = rng.random((2, 5, 4)) < 0.5
    bins = rng.integers(0, 9, (2, 5, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        tts._scatter_count(_t(mask), _t(bins), 7).numpy(),
        np.asarray(jts._scatter_count(jnp.asarray(mask), jnp.asarray(bins), 7)),
    )


def _model_pair(fab_args, nc, link_capacity, tiles=None):
    gx, gy, cpt, lat = fab_args
    jm = jrouting.build_delivery_model(_fabric(jrouting, gx, gy, cpt, lat), nc, DT,
                                       tile_of_cluster=tiles, link_capacity=link_capacity)
    tm = trouting.build_delivery_model(_fabric(trouting, gx, gy, cpt, lat), nc, DT,
                                       tile_of_cluster=tiles, link_capacity=link_capacity)
    return jm, tm


@pytest.mark.parametrize("empty", [False, True])
def test_build_fabric_entries_matches_repro(empty):
    rng = np.random.default_rng(4)
    nc, cs, k = 6, 5, 8
    src_tag, src_dest, _, _ = _random_tables(rng, nc * cs, nc, k, e=4)
    if empty:
        src_tag[:] = -1
    jm, tm = _model_pair((3, 1, 2, 2.0), nc, 2, tiles=np.array([2, 0, 1, 0, 2, 1], np.int32))
    j = jops.build_fabric_entries(src_tag, src_dest, cs, k, jm)
    t = tops.build_fabric_entries(src_tag, src_dest, cs, k, tm, device="cpu")
    # the port's table carries repro's columns, then the kernel's static
    # per-cluster ranges (held in tests/test_torch_deliver_redesign.py)
    assert [f.name for f in dataclasses.fields(t)] == [
        *(f.name for f in dataclasses.fields(j)), "cluster_start", "cluster_order"]
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert t.src.shape[0] == (1 if empty else int((src_tag >= 0).sum()))


@pytest.mark.parametrize("per_link_stats", [False, True])
@pytest.mark.parametrize("cursor", [None, 2])
def test_stage1_route_events_fabric_matches_repro(per_link_stats, cursor):
    rng = np.random.default_rng(8)
    nc, cs, k = 6, 4, 8
    n = nc * cs
    src_tag, src_dest, _, _ = _random_tables(rng, n, nc, k, e=4)
    jm, tm = _model_pair((3, 1, 2, 2.0), nc, 2)
    spikes = ((rng.random((3, n)) < 0.5) * rng.integers(1, 4, (3, n))).astype(np.float32)
    jq = jts.compact_events(jnp.asarray(spikes), 15)
    tq = tts.compact_events(_t(spikes), 15)
    kw = dict(n_clusters=nc, k_tags=k, cluster_size=cs, n_tiles=jm.n_tiles,
              max_delay=jm.max_delay, link_capacity=2, per_link_stats=per_link_stats)
    j = jts.stage1_route_events_fabric(
        jq, jnp.asarray(src_tag), jnp.asarray(src_dest),
        cluster_tile=jnp.asarray(jm.tile_of_cluster), delay_steps=jnp.asarray(jm.delay_steps),
        mesh_hops=jnp.asarray(jm.mesh_hops), latency_s=jnp.asarray(jm.latency_s),
        energy_j=jnp.asarray(jm.energy_j),
        cursor=None if cursor is None else jnp.int32(cursor), **kw,
    )
    t = tts.stage1_route_events_fabric(
        tq, _t(src_tag), _t(src_dest), cluster_tile=_t(tm.tile_of_cluster),
        delay_steps=_t(tm.delay_steps), mesh_hops=_t(tm.mesh_hops),
        latency_s=_t(tm.latency_s), energy_j=_t(tm.energy_j),
        cursor=None if cursor is None else torch.tensor(cursor, dtype=torch.int32), **kw,
    )
    assert jm.max_delay == 4
    np.testing.assert_array_equal(t.buffer.numpy(), np.asarray(j.buffer))
    _assert_stats_equal(t, j, "stage 1", int_fields=INT_STATS[1:])
    assert int(t.link_dropped.sum()) > 0 and int(t.buffer[:, 1:].sum()) > 0


# ---------------------------------------------------------------------------
# the ring step against repro's Pallas kernel in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("link_capacity", [None, 1, 2])
def test_ring_step_matches_repro_pallas_interpret(link_capacity, batch):
    """The plain ring step (``kernel=True`` on CPU tensors takes the plain
    version) against repro's ``fabric_deliver`` Pallas kernel in interpret
    mode, with max_delay = 2, a queue shorter than N and the cursor
    wrapping twice: drives, rings and integer stats bit-exact."""
    rng = np.random.default_rng(5 + (link_capacity or 0))
    nc, cs, k = 4, 4, 8
    n = nc * cs
    src_tag, src_dest, cam_tag, cam_syn = _random_tables(rng, n, nc, k)
    jm, tm = _model_pair((2, 1, 2, 2.0), nc, link_capacity)
    assert jm.max_delay == 2
    jent = jops.build_fabric_entries(src_tag, src_dest, cs, k, jm)
    tent = tops.build_fabric_entries(src_tag, src_dest, cs, k, tm, device="cpu")
    lead = () if batch is None else (batch,)
    d1 = jm.max_delay + 1
    j_ring, j_cur = jnp.zeros((*lead, d1, nc, k), jnp.float32), jnp.int32(0)
    t_ring, t_cur = torch.zeros((*lead, d1, nc, k)), torch.tensor(0, dtype=torch.int32)
    kw = dict(max_delay=jm.max_delay, link_capacity=jm.link_capacity, queue_capacity=n // 2)
    for step in range(2 * d1 + 1):
        spikes = (rng.random((*lead, n)) < 0.5).astype(np.float32)
        ext = (rng.integers(0, 3, (*lead, nc, k)) * (rng.random((*lead, nc, k)) < 0.2) * 8.0
               ).astype(np.float32)
        jd, j_ring, j_cur, js = jops.fabric_deliver_ring(
            jnp.asarray(spikes), jent, jnp.asarray(cam_tag), jnp.asarray(cam_syn), cs, k,
            j_ring, j_cur, external_activity=jnp.asarray(ext), interpret=True, **kw,
        )
        td, t_ring, t_cur, ts = tops.fabric_deliver_ring(
            _t(spikes), tent, _t(cam_tag), _t(cam_syn), cs, k, t_ring, t_cur,
            external_activity=_t(ext), **kw,
        )
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=f"step {step} drive")
        np.testing.assert_array_equal(t_ring.numpy(), np.asarray(j_ring), err_msg=f"step {step}")
        assert int(t_cur) == int(j_cur) == (step + 1) % d1 and t_cur.dtype == torch.int32
        _assert_stats_equal(ts, js, f"step {step}")
    if link_capacity == 1:
        assert int(ts.link_dropped.sum()) > 0


def test_ring_step_per_link_stats_match_repro():
    rng = np.random.default_rng(21)
    nc, cs, k = 6, 4, 8
    n = nc * cs
    src_tag, src_dest, cam_tag, cam_syn = _random_tables(rng, n, nc, k, e=4)
    jm, tm = _model_pair((3, 1, 2, 1.0), nc, 2)
    jent = jops.build_fabric_entries(src_tag, src_dest, cs, k, jm)
    tent = tops.build_fabric_entries(src_tag, src_dest, cs, k, tm, device="cpu")
    spikes = (rng.random((2, n)) < 0.6).astype(np.float32)
    kw = dict(max_delay=jm.max_delay, link_capacity=2, per_link_stats=True, n_tiles=jm.n_tiles)
    d1 = jm.max_delay + 1
    _, _, _, js = jops.fabric_deliver_ring(
        jnp.asarray(spikes), jent, jnp.asarray(cam_tag), jnp.asarray(cam_syn), cs, k,
        jnp.zeros((2, d1, nc, k)), jnp.int32(0), **kw)
    _, _, _, ts = tops.fabric_deliver_ring(
        _t(spikes), tent, _t(cam_tag), _t(cam_syn), cs, k, torch.zeros((2, d1, nc, k)),
        torch.tensor(0, dtype=torch.int32), **kw)
    assert ts.link_dropped.shape == (2, jm.n_tiles**2) and ts.delivered.shape == (2, nc * nc)
    _assert_stats_equal(ts, js, "per-link")
    assert int(ts.link_dropped.sum()) > 0


def test_kernel_false_takes_the_plain_version():
    """``kernel=False`` and the CPU path agree bit for bit (both plain)."""
    rng = np.random.default_rng(2)
    nc, cs, k = 4, 4, 8
    src_tag, src_dest, cam_tag, cam_syn = _random_tables(rng, nc * cs, nc, k)
    _, tm = _model_pair((2, 1, 2, 2.0), nc, 2)
    tent = tops.build_fabric_entries(src_tag, src_dest, cs, k, tm, device="cpu")
    spikes = _t((rng.random((2, nc * cs)) < 0.5).astype(np.float32))
    ring = torch.zeros((2, tm.max_delay + 1, nc, k))
    cur = torch.tensor(1, dtype=torch.int32)
    before = tops.fabric_deliver.launches
    outs = [
        tops.fabric_deliver_ring(spikes, tent, _t(cam_tag), _t(cam_syn), cs, k, ring, cur,
                                 max_delay=tm.max_delay, link_capacity=2, kernel=kernel)
        for kernel in (True, False)
    ]
    assert tops.fabric_deliver.launches == before  # CPU tensors never launch
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ring == roll == ring oracle, in the port and against repro's oracle
# ---------------------------------------------------------------------------
def _ring_vs_roll(seed, grid, cores_per_tile, cluster_size, k_tags, link_capacity,
                  queue_frac, latency_mult, batch):
    gx, gy = grid
    tfab = _fabric(trouting, gx, gy, cores_per_tile, latency_mult)
    nc = tfab.n_cores
    n = nc * cluster_size
    rng = np.random.default_rng(seed)
    src_tag, src_dest, cam_tag, cam_syn = _random_tables(rng, n, nc, k_tags)
    tabs = [_t(a) for a in (src_tag, src_dest, cam_tag, cam_syn)]
    jtabs = [jnp.asarray(a) for a in (src_tag, src_dest, cam_tag, cam_syn)]
    qcap = max(1, int(queue_frac * n))
    be = tdispatch.FabricBackend(fabric=tfab, dt=DT, link_capacity=link_capacity)
    model = be.model_for(nc)
    arrs = be.arrays_for(nc, torch.device("cpu"))
    jm = jrouting.build_delivery_model(_fabric(jrouting, gx, gy, cores_per_tile, latency_mult),
                                       nc, DT, link_capacity=link_capacity)
    entries = be.build_entries(src_tag, src_dest, cluster_size, k_tags, device="cpu")
    d1 = model.max_delay + 1
    inflight = be.init_inflight(nc, k_tags, batch=batch, device="cpu")
    ring_f, cur_f = be.init_ring(nc, k_tags, batch=batch, device="cpu")
    ring_r, cur_r = be.init_ring(nc, k_tags, batch=batch, device="cpu")
    ring_j, cur_j = jnp.asarray(ring_r.numpy()), jnp.int32(0)
    lead = () if batch is None else (batch,)
    oracle_kw = dict(n_tiles=model.n_tiles, max_delay=model.max_delay,
                     link_capacity=model.link_capacity, queue_capacity=qcap)
    for step in range(2 * d1 + 1):  # the cursor wraps twice
        spikes = ((rng.random((*lead, n)) < 0.4) * rng.integers(1, 3, (*lead, n))).astype(np.float32)
        d_roll, inflight, s_roll = be.deliver_fabric(
            _t(spikes), *tabs, cluster_size, k_tags, inflight=inflight, queue_capacity=qcap)
        d_fast, ring_f, cur_f, s_fast = be.deliver_fabric_ring(
            _t(spikes), entries, tabs[2], tabs[3], cluster_size, k_tags, ring_f, cur_f,
            queue_capacity=qcap)
        d_ref, ring_r, cur_r, s_ref = t_ring_ref(
            _t(spikes), *tabs, cluster_size, k_tags, ring_r, cur_r,
            cluster_tile=arrs["cluster_tile"], delay_steps=arrs["delay_steps"],
            mesh_hops=arrs["mesh_hops"], latency_s=arrs["latency_s"],
            energy_j=arrs["energy_j"], **oracle_kw)
        d_j, ring_j, cur_j, s_j = j_ring_ref(
            jnp.asarray(spikes), *jtabs, cluster_size, k_tags, ring_j, cur_j,
            cluster_tile=jnp.asarray(jm.tile_of_cluster),
            delay_steps=jnp.asarray(jm.delay_steps), mesh_hops=jnp.asarray(jm.mesh_hops),
            latency_s=jnp.asarray(jm.latency_s), energy_j=jnp.asarray(jm.energy_j),
            **oracle_kw)
        for name, d in (("fast", d_fast), ("oracle", d_ref)):
            assert torch.equal(d, d_roll), f"step {step}: roll vs {name} drive"
        np.testing.assert_array_equal(d_ref.numpy(), np.asarray(d_j), err_msg=f"step {step}")
        assert torch.equal(ring_f, ring_r), f"step {step}: ring fast vs oracle"
        np.testing.assert_array_equal(ring_r.numpy(), np.asarray(ring_j), err_msg=f"step {step}")
        for s in (s_fast, s_ref):
            _assert_stats_equal(s, s_roll, f"step {step}")
        _assert_stats_equal(s_ref, s_j, f"step {step}: port oracle vs repro oracle")
    assert int(cur_f) == int(cur_r) == int(cur_j) == (2 * d1 + 1) % d1
    # the ring holds exactly the roll's in-flight tail, phase-rotated
    order = (int(cur_f) + torch.arange(d1 - 1)) % d1
    assert torch.equal(ring_f.index_select(ring_f.ndim - 3, order), inflight)


@settings(max_examples=4, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    grid=st.sampled_from([(1, 2), (2, 2), (3, 2)]),
    cores_per_tile=st.integers(1, 2),
    cluster_size=st.integers(2, 5),
    k_tags=st.sampled_from([4, 8, 16]),
    link_capacity=st.sampled_from([None, 1, 2, 4]),
    queue_frac=st.sampled_from([0.25, 0.6, 1.0]),
    latency_mult=st.sampled_from([0.5, 1.0, 2.0]),
    batch=st.sampled_from([None, 2]),
)
def test_ring_matches_roll_property(seed, grid, cores_per_tile, cluster_size, k_tags,
                                    link_capacity, queue_frac, latency_mult, batch):
    """Random geometry, delay and capacity: the port's ring step, its ring
    oracle and its roll step agree bit for bit over whole runs, and the
    oracle equals repro's ``fabric_deliver_ring_ref``."""
    _ring_vs_roll(seed, grid, cores_per_tile, cluster_size, k_tags, link_capacity,
                  queue_frac, latency_mult, batch)


@pytest.mark.parametrize("link_capacity", [None, 1])
def test_ring_matches_roll_fixed_cases(link_capacity):
    """Two fixed draws of the property above (they run without hypothesis)."""
    _ring_vs_roll(7, (3, 2), 1, 3, 8, link_capacity, 0.6, 2.0, 2)


# ---------------------------------------------------------------------------
# the fabric EventEngine against repro's
# ---------------------------------------------------------------------------
def _engine_pair(ring, link_capacity=2, seed=11):
    jspec, _ = _spec_pair(seed, n=48, cluster=8, k=32, edges=120)
    fab_args = dict(grid_x=3, grid_y=1, cores_per_tile=2)
    jtables = j_compile(jspec, fabric=jrouting.Fabric(**fab_args))
    opts = {"ring": ring, "link_capacity": link_capacity}
    jfab = jrouting.Fabric(**fab_args, constants=jrouting.ChipConstants(latency_across_chip_s=2 * DT))
    tfab = trouting.Fabric(**fab_args, constants=trouting.ChipConstants(latency_across_chip_s=2 * DT))
    jeng = jee.EventEngine(jtables, queue_capacity=30, fabric=jfab, fabric_options=opts)
    teng = tee.EventEngine(tables_from_numpy(jtables), params_from_jax(jeng.params),
                           queue_capacity=30, fabric=tfab, fabric_options=opts, device="cpu")
    assert teng.fabric_model.max_delay == jeng.fabric_model.max_delay == 4
    return jtables, jeng, teng


def _inputs(tables, steps, b, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, (steps, b, tables.n_clusters, tables.k_tags))
    return (counts * (rng.random(counts.shape) < 0.3) * 8.0).astype(np.float32)


@pytest.mark.parametrize("ring", [True, False])
def test_fabric_engine_steps_match_repro(ring):
    """Each port step starts from repro's carry of that step (carried across
    with ``carry_from_numpy``): spikes, the delay line and every integer stat
    equal, neuron state within the tolerance."""
    tables, jeng, teng = _engine_pair(ring)
    b = 3
    inp = _inputs(tables, 14, b, seed=12)
    jc = jeng.init_state(batch=b)
    assert len(jc) == (4 if ring else 3)
    totals = np.zeros(2)
    for t in range(inp.shape[0]):
        tc, (tspk, tst) = teng.step(carry_from_numpy(jc, device="cpu"), inp[t])
        jc, (jspk, jst) = jeng.step(jc, jnp.asarray(inp[t]))
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk), err_msg=f"step {t}")
        for got, want in zip(tc[1:], jc[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {t}")
        _assert_stats_equal(tst, jst, f"step {t}")
        for name in ("v", "w", "refrac", "i_syn"):
            np.testing.assert_allclose(getattr(tc[0], name).numpy(), np.asarray(getattr(jc[0], name)),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        totals += [int(tspk.sum()), int(tst.link_dropped.sum())]
    assert totals.min() > 0  # spikes flowed and links dropped


@pytest.mark.parametrize("ring", [True, False])
def test_fabric_engine_run_matches_repro(ring):
    """Free-running over T steps: spikes and integer stats equal at every step."""
    tables, jeng, teng = _engine_pair(ring, seed=13)
    b, steps = 2, 12
    inp = _inputs(tables, steps, b, seed=14)
    jc, (jspk, jst) = jeng.run(jeng.init_state(batch=b), jnp.asarray(inp))
    tc, (tspk, tst) = teng.run(teng.init_state(batch=b), inp)
    assert tspk.shape == (steps, b, tables.n_neurons) and tst.delivered.shape == (steps, b)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    _assert_stats_equal(tst, jst, "run")
    assert int(tspk.sum()) > 0 and int(tst.delivered.sum()) > 0
    if ring:
        assert int(tc[3]) == int(jc[3]) == steps % (teng.fabric_model.max_delay + 1)


@pytest.mark.parametrize("phase", range(5))
def test_reset_slots_at_every_cursor_phase(phase):
    """An evicted slot's whole ring is zeroed at any cursor position: it
    leaks nothing to the next occupant, the survivor keeps its traffic, and
    the result equals repro's reset of the same carry."""
    tables, jeng, teng = _engine_pair(True, link_capacity=None, seed=17)
    d1 = teng.fabric_model.max_delay + 1
    b = 2
    hot = _inputs(tables, 1, b, seed=18)[0] + 8.0
    carry = teng.init_state(batch=b)
    for _ in range(d1 + phase):
        carry, _ = teng.step(carry, hot)
    assert int(carry[3]) == (d1 + phase) % d1 == phase
    assert float(carry[2][0].abs().sum()) > 0  # slot 0 has events in transit
    out = teng.reset_slots(carry, np.array([True, False]))
    assert out[3] is carry[3]  # the shared cursor passes through
    assert float(out[2][0].abs().sum()) == 0.0 and torch.equal(out[2][1], carry[2][1])
    jstate = type(jeng.init_state()[0])(
        *(jnp.asarray(getattr(carry[0], k).numpy()) for k in ("v", "w", "refrac", "i_syn")))
    jout = jeng.reset_slots((jstate, *(jnp.asarray(x.numpy()) for x in carry[1:])),
                            np.array([True, False]))
    for got, want in zip(out[1:], jout[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zero = np.zeros_like(hot)
    survivor = 0
    for _ in range(2 * d1):
        out, (spikes, stats) = teng.step(out, zero)
        assert float(spikes[0].abs().sum()) == 0.0 and int(stats.delivered[0]) == 0
        survivor += int(stats.delivered[1])
    assert survivor > 0


def test_fabric_engine_checks_like_repro():
    tables, _, _ = _engine_pair(True)
    tt = tables_from_numpy(tables)
    fab = trouting.Fabric(grid_x=3, grid_y=1, cores_per_tile=2)
    with pytest.raises(ValueError, match="fabric_options ignored"):
        tee.EventEngine(tt, fabric=tdispatch.FabricBackend(fabric=fab), fabric_options={"ring": False},
                        device="cpu")
    with pytest.raises(ValueError, match="dt="):
        tee.EventEngine(tt, fabric=tdispatch.FabricBackend(fabric=fab, dt=2e-3), device="cpu")
    with pytest.raises(ValueError, match="placement differs"):
        tee.EventEngine(tt, fabric=tdispatch.FabricBackend(
            fabric=fab, tile_of_cluster=[1, 1, 0, 0, 2, 2]), device="cpu")
    with pytest.raises(ValueError, match="need fabric"):
        tee.EventEngine(tt, fabric_options={"ring": False}, device="cpu")
    eng = tee.EventEngine(tt, fabric=tdispatch.FabricBackend(fabric=fab), device="cpu")
    assert eng.fabric_ring and eng._fabric_entries.src.device.type == "cpu"


def test_carry_from_numpy_round_trip():
    tables, jeng, _ = _engine_pair(True)
    jc = jeng.init_state(batch=2)
    jc, _ = jeng.step(jc, jnp.asarray(_inputs(tables, 1, 2, seed=3)[0]))
    tc = carry_from_numpy(jc, device="cpu")
    assert tc[3].dtype == torch.int32 and tc[3].ndim == 0 and int(tc[3]) == int(jc[3])
    for got, want in zip(tc[1:3], jc[1:3]):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(carry_from_numpy(jc[:2], device="cpu")) == 2
    with pytest.raises(ValueError, match="2, 3 or 4"):
        carry_from_numpy((*jc, jc[3]), device="cpu")


# ---------------------------------------------------------------------------
# the port's entry points default to the card
# ---------------------------------------------------------------------------
def _on_card_or_raises(make):
    if torch.cuda.is_available():
        return make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


def test_state_helpers_default_to_cuda():
    p = tneuron.NeuronParams()
    _on_card_or_raises(lambda: tneuron.init_state(4, p))
    z = np.zeros(4, np.float32)
    _on_card_or_raises(lambda: state_from_numpy(z, z, z, np.zeros((4, 4), np.float32)))
    be = tdispatch.FabricBackend()
    _on_card_or_raises(lambda: be.init_ring(6, 8))
    _on_card_or_raises(lambda: carry_from_numpy(
        (tneuron.init_state(4, p, device="cpu"), z), ))
    assert tneuron.init_state(4, p, device="cpu").v.device.type == "cpu"
