"""Fault injection in the port against repro: the fault model, both fabric
delivery paths under every fault class, and repair_placement.

The fault model (``core/faults.py``) is numpy in both packages and draws
from ``np.random.default_rng`` in the reference's order, so the tile and
pair fault matrices, ``entry_alive_mask``, ``apply_table_faults`` (tables
and flip report) and ``fault_blast_radius`` are held byte-equal to repro's.
The fabric paths are held to equal integer counts (link drops, delivered
events, spikes) on repro's own two-tile chaos net (tests/test_faults.py),
on the ring and on the roll path, with and without per-link stats; the
Table-V placement repair around 25% dead links is held byte-equal.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiler as jcomp
from repro.core import faults as jfaults
from repro.core import routing as jrouting
from repro.core.cnn import compile_poker_cnn as j_compile_poker
from repro.core.tags import NetworkSpec as JSpec, compile_network as j_compile
from repro.kernels.fabric_deliver import ops as jops
from repro_torch.core import compiler as tcomp
from repro_torch.core import faults as tfaults
from repro_torch.core import routing as trouting
from repro_torch.core.cnn import compile_poker_cnn as t_compile_poker
from repro_torch.core.event_engine import EventEngine
from repro_torch.core.neuron import NeuronParams
from repro_torch.core.tags import NetworkSpec as TSpec, compile_network as t_compile
from repro_torch.core.two_stage import compact_events, stage1_route_events_fabric
from repro_torch.kernels.fabric_deliver import ops as tops
from tests.test_faults import DEAD25, DT, _run_faulted

REPO = pathlib.Path(__file__).resolve().parents[1]

# every fault class, each as keyword arguments of FaultSpec
FAULTS = {
    "dead-tile": {"dead_tiles": (1,)},
    "dead-link": {"dead_links": ((0, 1),)},
    "dead25": {"dead_links": DEAD25},
    "lossy": {"link_drop_rate": 0.05, "seed": 3},
    "lossy-map": {"link_drop_rate": {(0, 1): 0.3, (4, 5): 0.6, (5, 4): 0.1}, "seed": 9},
    "stuck": {"stuck_clusters": (0, 3)},
    "mixed": {"dead_tiles": (8,), "dead_links": ((3, 4),), "link_drop_rate": 0.2,
              "stuck_clusters": (5,), "seed": 17},
}
# on the two-tile (1x2) chaos net
TWO_TILE_FAULTS = {
    "dead-link": {"dead_links": ((0, 1),)},
    "lossy-link": {"link_drop_rate": 0.5, "seed": 3},
    "lossy-map": {"link_drop_rate": {(0, 1): 0.7, (1, 0): 0.4}, "seed": 2},
    "stuck-cluster": {"stuck_clusters": (0,)},
    "dead-tile": {"dead_tiles": (1,)},
}


def _fabrics(pkg):
    return [pkg.Fabric(), pkg.Fabric(grid_x=2, grid_y=1, cores_per_tile=1),
            pkg.Fabric(grid_x=4, grid_y=2, cores_per_tile=2)]


def _two_tile(spec_cls, compile_fn, routing):
    """repro's 8-neuron, 2-cluster chaos net on a 1x2 mesh (tests/test_faults.py)."""
    const = routing.ChipConstants(latency_across_chip_s=2 * DT)
    fab = routing.Fabric(grid_x=2, grid_y=1, cores_per_tile=1, constants=const)
    spec = spec_cls(n_neurons=8, cluster_size=4, k_tags=8, max_cam_words=64)
    spec.connect_group([0], [(4, 0)], shared_tag=False, copies=32)
    spec.connect_group([1], [(5, 0)], shared_tag=False, copies=32)
    spec.connect_group([2], [(3, 1)], shared_tag=False, copies=2)  # same-tile
    return compile_fn(spec, fabric=fab), fab


@pytest.fixture(scope="module")
def table_v():
    return j_compile_poker().tables, t_compile_poker().tables


def _tables_equal(a, b):
    for name in ("src_tag", "src_dest", "cam_tag", "cam_syn"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert np.asarray(getattr(a, name)).dtype == np.asarray(getattr(b, name)).dtype


# ---------------------------------------------------------------------------
# the fault model, byte-equal
# ---------------------------------------------------------------------------
def test_mesh_links_and_xy_paths_equal_repro():
    for jf, tf in zip(_fabrics(jrouting), _fabrics(trouting)):
        assert tfaults.mesh_links(tf) == jfaults.mesh_links(jf)
        for a in range(tf.n_tiles):
            for b in range(tf.n_tiles):
                assert tfaults.xy_path(tf, a, b) == jfaults.xy_path(jf, a, b)


@pytest.mark.parametrize("kind", list(FAULTS))
def test_fault_matrices_equal_repro(kind):
    kw = FAULTS[kind]
    jspec, tspec = jfaults.FaultSpec(**kw), tfaults.FaultSpec(**kw)
    assert tspec.routes_faulted == jspec.routes_faulted
    jfab, tfab = jrouting.Fabric(), trouting.Fabric()
    for link in tfaults.mesh_links(tfab):
        assert tspec.rate_of(link) == jspec.rate_of(link)
    for got, want in zip(tfaults.tile_fault_matrices(tfab, tspec),
                         jfaults.tile_fault_matrices(jfab, jspec)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    placement = np.array([4, 5, 4, 4, 4, 1], np.int32)
    for got, want in zip(tfaults.pair_fault_matrices(tfab, placement, tspec),
                         jfaults.pair_fault_matrices(jfab, placement, jspec)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    jm = jrouting.build_delivery_model(jfab, 6, DT, tile_of_cluster=placement, faults=jspec)
    tm = trouting.build_delivery_model(tfab, 6, DT, tile_of_cluster=placement, faults=tspec)
    for name in ("pair_alive", "pair_drop_rate", "delay_steps", "mesh_hops"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert (tm.faults is None) == (jm.faults is None)


def _raises_same(fn_j, fn_t):
    with pytest.raises(Exception) as want:
        fn_j()
    with pytest.raises(type(want.value)) as got:
        fn_t()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    {"cam_bit_flips": -1},
    {"sram_bit_flips": -2},
    {"link_drop_rate": 1.5},
    {"link_drop_rate": -0.1},
    {"link_drop_rate": {(0, 1): 2.0}},
], ids=["cam", "sram", "rate-high", "rate-low", "rate-map"])
def test_fault_spec_construction_errors_equal_repro(kw):
    _raises_same(lambda: jfaults.FaultSpec(**kw), lambda: tfaults.FaultSpec(**kw))


@pytest.mark.parametrize("kw", [
    {"dead_tiles": (9,)},
    {"dead_tiles": (-1,)},
    {"dead_links": ((0, 4),)},
    {"dead_links": ((0, 0),)},
    {"link_drop_rate": {(2, 3): 0.1}},
], ids=["tile-high", "tile-low", "diagonal-link", "self-link", "rate-map-link"])
def test_fault_spec_validate_errors_equal_repro(kw):
    _raises_same(lambda: jfaults.FaultSpec(**kw).validate(jrouting.Fabric()),
                 lambda: tfaults.FaultSpec(**kw).validate(trouting.Fabric()))


def test_stuck_cluster_out_of_range_equal_repro():
    placement = np.arange(3, dtype=np.int32)
    _raises_same(
        lambda: jfaults.pair_fault_matrices(
            jrouting.Fabric(), placement, jfaults.FaultSpec(stuck_clusters=(3,))),
        lambda: tfaults.pair_fault_matrices(
            trouting.Fabric(), placement, tfaults.FaultSpec(stuck_clusters=(3,))),
    )


@pytest.mark.parametrize("kind", list(FAULTS))
def test_entry_alive_mask_equal_repro(kind, table_v):
    jt, tt = table_v
    kw = FAULTS[kind]
    jm = jrouting.build_delivery_model(jrouting.Fabric(), jt.n_clusters, DT,
                                       faults=jfaults.FaultSpec(**kw))
    tm = trouting.build_delivery_model(trouting.Fabric(), tt.n_clusters, DT,
                                       faults=tfaults.FaultSpec(**kw))
    want = jfaults.entry_alive_mask(jt.src_tag, jt.src_dest, jt.cluster_size, jm)
    got = tfaults.entry_alive_mask(tt.src_tag, tt.src_dest, tt.cluster_size, tm)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert not got.all()  # every class severs something on Table-V


def test_entry_alive_mask_healthy_is_none(table_v):
    _, tt = table_v
    tm = trouting.build_delivery_model(trouting.Fabric(), tt.n_clusters, DT,
                                       faults=tfaults.FaultSpec(cam_bit_flips=3))
    assert tm.pair_alive is None and tm.faults is None
    assert tfaults.entry_alive_mask(tt.src_tag, tt.src_dest, tt.cluster_size, tm) is None


@pytest.mark.parametrize("flips", [(0, 0, 0), (4, 4, 5), (64, 64, 11), (7, 1, 2)],
                         ids=["none", "few", "chip-smoke", "odd"])
def test_apply_table_faults_and_blast_radius_equal_repro(flips, table_v):
    cam, sram, seed = flips
    for jt, tt in (table_v, (_two_tile(JSpec, j_compile, jrouting)[0],
                             _two_tile(TSpec, t_compile, trouting)[0])):
        jc, jrep = jfaults.apply_table_faults(
            jt, jfaults.FaultSpec(cam_bit_flips=cam, sram_bit_flips=sram, seed=seed))
        tc, trep = tfaults.apply_table_faults(
            tt, tfaults.FaultSpec(cam_bit_flips=cam, sram_bit_flips=sram, seed=seed))
        assert trep == jrep
        assert len(trep) == cam + sram
        _tables_equal(jc, tc)
        _tables_equal(jt, tt)  # the input tables are untouched
        assert tfaults.fault_blast_radius(tt, tc) == jfaults.fault_blast_radius(jt, jc)


# ---------------------------------------------------------------------------
# both fabric paths under faults
# ---------------------------------------------------------------------------
def _run_port(tables, fab, faults, ring, per_link_stats=False, steps=8, seed=0):
    """tests/test_faults.py's _run_faulted on the port (CPU), with the
    per-link bins checked against the scalar totals of the same step."""
    opts = {"dt": DT, "ring": ring, "per_link_stats": per_link_stats}
    if faults is not None:
        opts["faults"] = faults
    eng = EventEngine(tables, NeuronParams(input_gain=3.0, dt=DT), fabric=fab,
                      queue_capacity=8, device="cpu", fabric_options=opts)
    carry = eng.init_state(batch=2)
    rng = np.random.default_rng(seed)
    link_dropped = delivered = n_spikes = 0
    for _ in range(steps):
        i_ext = torch.as_tensor((rng.random((2, 8)) < 0.5) * 5e3, dtype=torch.float32)
        carry, (spikes, stats) = eng.step(carry, torch.zeros((2, 2, 8)), i_ext)
        if per_link_stats:
            assert stats.link_dropped.shape == (2, fab.n_tiles ** 2)
            assert stats.delivered.shape == (2, 4)
        link_dropped += int(stats.link_dropped.sum())
        delivered += int(stats.delivered.sum())
        n_spikes += int(spikes.sum())
    return link_dropped, delivered, n_spikes


@pytest.mark.parametrize("kind", list(TWO_TILE_FAULTS))
def test_ring_and_roll_counts_equal_repro(kind):
    kw = TWO_TILE_FAULTS[kind]
    jt, jfab = _two_tile(JSpec, j_compile, jrouting)
    tt, tfab = _two_tile(TSpec, t_compile, trouting)
    want = _run_faulted(jt, jfab, jfaults.FaultSpec(**kw), ring=True)
    assert want == _run_faulted(jt, jfab, jfaults.FaultSpec(**kw), ring=False)
    for ring in (True, False):
        for per_link in (False, True):
            got = _run_port(tt, tfab, tfaults.FaultSpec(**kw), ring, per_link)
            assert got == want, (ring, per_link)
    healthy = _run_port(tt, tfab, None, ring=True)
    assert healthy == _run_faulted(jt, jfab, None, ring=True)
    if kind != "lossy-map":  # this seed's draw severs nothing
        assert want[0] > healthy[0] == 0


def test_per_link_bins_sum_to_scalar_totals():
    """One faulted step's per-link drop bins and per-pair delivered bins sum
    to the scalar counters of the same step, on both paths."""
    tt, tfab = _two_tile(TSpec, t_compile, trouting)
    fs = tfaults.FaultSpec(dead_links=((0, 1),), link_drop_rate=0.3, seed=4)
    spikes = torch.tensor([[1, 1, 1, 0, 1, 1, 0, 0], [1, 0, 1, 1, 0, 1, 1, 1]],
                          dtype=torch.float32)
    out = {}
    for ring in (True, False):
        for per_link in (False, True):
            eng = EventEngine(tt, NeuronParams(dt=DT), fabric=tfab, queue_capacity=8,
                              device="cpu", fabric_options={
                                  "dt": DT, "ring": ring, "faults": fs,
                                  "per_link_stats": per_link})
            state, _, *delay = eng.init_state(batch=2)
            _, (_, stats) = eng.step((state, spikes, *delay), torch.zeros((2, 2, 8)))
            out[ring, per_link] = (stats.link_dropped.reshape(2, -1).sum(-1).tolist(),
                                   stats.delivered.reshape(2, -1).sum(-1).tolist())
    assert len(set(map(str, out.values()))) == 1
    assert sum(out[True, False][0]) > 0


def test_fault_drops_counted_without_link_capacity():
    """With ``link_capacity=None`` the severed entries' events still count in
    ``link_dropped``: on the ring step, on the roll path's stage 1, and in
    repro's ring step, per stream and per link."""
    jt, jfab = _two_tile(JSpec, j_compile, jrouting)
    tt, tfab = _two_tile(TSpec, t_compile, trouting)
    jfs = jfaults.FaultSpec(dead_links=((1, 0),), link_drop_rate=0.4, seed=6)
    tfs = tfaults.FaultSpec(dead_links=((1, 0),), link_drop_rate=0.4, seed=6)
    jm = jrouting.build_delivery_model(jfab, 2, DT, tile_of_cluster=jt.tile_of_cluster,
                                       faults=jfs)
    tm = trouting.build_delivery_model(tfab, 2, DT, tile_of_cluster=tt.tile_of_cluster,
                                       faults=tfs)
    alive = tfaults.entry_alive_mask(tt.src_tag, tt.src_dest, 4, tm)
    assert not alive.all()
    spikes_np = np.array([[1, 1, 1, 1, 1, 1, 1, 1], [0, 1, 1, 0, 1, 0, 0, 1]], np.float32)
    spikes = torch.as_tensor(spikes_np)
    cam_tag, cam_syn = torch.as_tensor(tt.cam_tag), torch.as_tensor(tt.cam_syn)
    jentries = jops.build_fabric_entries(jt.src_tag, jt.src_dest, 4, 8, jm)
    tentries = tops.build_fabric_entries(tt.src_tag, tt.src_dest, 4, 8, tm, device="cpu")
    for name in ("src", "dstk", "delay", "cross", "link_start", "link", "valid", "alive"):
        np.testing.assert_array_equal(getattr(tentries, name).numpy(),
                                      np.asarray(getattr(jentries, name)))
    d1 = tm.max_delay + 1
    for per_link in (False, True):
        got = tops.fabric_deliver_ring(
            spikes, tentries, cam_tag, cam_syn, 4, 8, torch.zeros((2, d1, 2, 8)),
            torch.zeros((), dtype=torch.int32), max_delay=tm.max_delay, link_capacity=None,
            per_link_stats=per_link, n_tiles=2, kernel=False)[3]
        want = jops.fabric_deliver_ring(
            jnp.asarray(spikes_np), jentries, jnp.asarray(jt.cam_tag), jnp.asarray(jt.cam_syn),
            4, 8, jnp.zeros((2, d1, 2, 8)), jnp.int32(0), max_delay=jm.max_delay,
            link_capacity=None, per_link_stats=per_link, n_tiles=2)[3]
        np.testing.assert_array_equal(got.link_dropped.numpy(), np.asarray(want.link_dropped))
        np.testing.assert_array_equal(got.delivered.numpy(), np.asarray(want.delivered))
        queue = compact_events(spikes, 8)
        route = stage1_route_events_fabric(
            queue, torch.as_tensor(tt.src_tag), torch.as_tensor(tt.src_dest), 2, 8, 4,
            torch.as_tensor(tm.tile_of_cluster), torch.as_tensor(tm.delay_steps), 2,
            tm.max_delay, None, entry_alive=torch.as_tensor(alive), per_link_stats=per_link)
        np.testing.assert_array_equal(route.link_dropped.numpy(), got.link_dropped.numpy())
        np.testing.assert_array_equal(route.delivered.numpy(), got.delivered.numpy())
    # the scalar count: every active severed entry, nothing else
    src_of = tentries.src.numpy()
    active = spikes_np[:, src_of] != 0
    assert got.link_dropped.sum(-1).tolist() == (active & ~tentries.alive.numpy()).sum(-1).tolist()


def test_severed_entries_reach_the_kernel_as_weight_zero():
    """The ring step hands the kernel (here its plain version) weight 0 on
    every severed entry: cluster 1 (tile 1) hears only the dead tile-0 ->
    tile-1 link, and its neurons get no drive; the same-tile route still
    drives neuron 3. Healthy, cluster 1 is driven."""
    tt, tfab = _two_tile(TSpec, t_compile, trouting)
    drive = {}
    for dead in ((), ((0, 1),)):
        tm = trouting.build_delivery_model(
            tfab, 2, DT, tile_of_cluster=tt.tile_of_cluster,
            faults=tfaults.FaultSpec(dead_links=dead))
        entries = tops.build_fabric_entries(tt.src_tag, tt.src_dest, 4, 8, tm, device="cpu")
        assert bool(entries.alive.all()) == (not dead) and entries.severed == bool(dead)
        d1 = tm.max_delay + 1
        ring = torch.zeros((1, d1, 2, 8))
        cursor = torch.zeros((), dtype=torch.int32)
        total = torch.zeros((1, 8, 4))
        for _ in range(d1 + 1):
            out, ring, cursor, _ = tops.fabric_deliver_ring(
                torch.ones((1, 8)), entries, torch.as_tensor(tt.cam_tag),
                torch.as_tensor(tt.cam_syn), 4, 8, ring, cursor, max_delay=tm.max_delay,
                link_capacity=None, kernel=False)
            total += out
        drive[dead] = total
    assert float(drive[()][0, 4:].sum()) > 0.0
    assert float(drive[((0, 1),)][0, 4:].sum()) == 0.0
    assert float(drive[((0, 1),)][0, 3].sum()) > 0.0


# ---------------------------------------------------------------------------
# repair_placement, byte-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    {"dead_links": DEAD25},
    {"dead_tiles": (0, 1)},
    {"dead_links": ((1, 4), (4, 1)), "link_drop_rate": 0.1, "seed": 2},
], ids=["dead25", "dead-tiles", "lossy"])
def test_repair_placement_equals_repro(kw, table_v):
    jt, tt = table_v
    jp, jrep = jcomp.repair_placement(jt, jrouting.Fabric(), jfaults.FaultSpec(**kw), seed=0)
    tp, trep = tcomp.repair_placement(tt, trouting.Fabric(), tfaults.FaultSpec(**kw), seed=0)
    assert tp.dtype == jp.dtype and tp.tobytes() == jp.tobytes()
    assert trep == jrep
    assert trep["feasible"]


def test_repair_placement_capacity_error_equals_repro(table_v):
    jt, tt = table_v
    kw = {"dead_tiles": tuple(range(1, 9))}  # one 4-core tile left for 6 clusters
    _raises_same(
        lambda: jcomp.repair_placement(jt, jrouting.Fabric(), jfaults.FaultSpec(**kw)),
        lambda: tcomp.repair_placement(tt, trouting.Fabric(), tfaults.FaultSpec(**kw)),
    )


def test_repaired_placement_builds_an_engine(table_v):
    """The repaired tables serve on the fabric: the engine accepts the new
    placement and its delivery model carries the faults."""
    _, tt = table_v
    fs = tfaults.FaultSpec(dead_links=DEAD25)
    placement, _ = tcomp.repair_placement(tt, trouting.Fabric(), fs, seed=0)
    tables_r = dataclasses.replace(tt, tile_of_cluster=placement)
    eng = EventEngine(tables_r, NeuronParams(), fabric=trouting.Fabric(), queue_capacity=1536,
                      device="cpu", fabric_options={"faults": fs})
    assert eng.fabric_model.faults is fs
    np.testing.assert_array_equal(eng.fabric_model.tile_of_cluster, placement)


def test_no_module_says_faults_are_not_ported():
    hits = [str(p.relative_to(REPO)) for p in (REPO / "src" / "repro_torch").rglob("*.py")
            if "Faults and recovery" in p.read_text()]
    assert hits == []
