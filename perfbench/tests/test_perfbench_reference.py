"""The reference network, worked out from the Table-V CNN's definition and
the board's geometry, equals what the port compiles."""

import json

import numpy as np
import pytest
from conftest import ROOT

from perfbench.reference import table_v


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def compiled():
    from repro_torch.core.cnn import compile_poker_cnn

    return compile_poker_cnn()


@pytest.mark.parametrize("name", ["tablev-fused", "tablev-fabric"])
def test_internal_connectivity_equals_dense_equivalent(compiled, name):
    net = table_v.build(_config(name))
    n = net.layout.n
    ours = sum(w.numpy() for w in net.w_int).reshape(n, n, 4)
    theirs = np.zeros((n, n, 4), np.float32)
    for src, dst, syn in compiled.tables.dense_equivalent():
        theirs[src, dst, syn] += 1.0
    np.testing.assert_array_equal(ours, theirs)


def test_external_taps_equal_the_conv_cams(compiled):
    net = table_v.build(_config("tablev-fused"))
    t = compiled.tables
    cs = t.cluster_size
    theirs = np.zeros((t.n_clusters, t.k_tags, cs, 4), np.float32)
    lo, hi = net.layout.conv
    for n in range(lo, hi):
        for tag, syn in zip(t.cam_tag[n], t.cam_syn[n]):
            if tag >= 0:
                theirs[n // cs, tag, n % cs, syn] += 1.0
    np.testing.assert_array_equal(net.w_ext.numpy().reshape(theirs.shape), theirs)


def test_sram_entries_and_cam_words_equal_the_tables(compiled):
    cfg = _config("tablev-fused")
    net = table_v.build(cfg)
    t = compiled.tables
    np.testing.assert_array_equal(net.entries.numpy(), (t.src_tag >= 0).sum(1))
    assert table_v.cam_words(cfg["network"]) == int((t.cam_tag >= 0).sum())


def test_board_delays_hops_and_links_equal_the_fabric_model(compiled):
    from repro_torch.core.routing import Fabric, build_delivery_model

    cfg = _config("tablev-fabric")
    board = cfg["delivery"]["board"]
    net = table_v.build(cfg)
    cs, nc = net.cluster_size, net.n_clusters
    model = build_delivery_model(Fabric(), nc, cfg["neuron"]["dt"],
                                 link_capacity=board["link_capacity"])
    tiles = table_v.board_tiles(nc, board)
    np.testing.assert_array_equal(tiles, model.tile_of_cluster)
    assert len(net.w_int) == model.max_delay + 1
    assert net.link_capacity == model.link_capacity
    for d, w in enumerate(net.w_int):
        src, col = np.nonzero(w.numpy())
        a, b = src // cs, (col // 4) // cs
        assert (model.delay_steps[a, b] == d).all()
    t = compiled.tables
    hops = np.zeros(net.layout.n)
    for s, e in zip(*np.nonzero(t.src_tag >= 0)):
        hops[s] += model.mesh_hops[s // cs, t.src_dest[s, e]]
    np.testing.assert_array_equal(net.hops.numpy(), hops)


def test_fused_configuration_is_one_chip():
    net = table_v.build(_config("tablev-fused"))
    assert len(net.w_int) == 1 and net.link_capacity is None
