"""The port's compiler, Table-V CNN and DVS streams against repro.

Everything here is host-side numpy in both packages, so every comparison is
exact: tables byte-equal, fingerprints equal, activity arrays equal, the
same errors raised.
"""

import numpy as np
import pytest

from repro.core import cnn as jcnn
from repro.core import tags as jtags
from repro.data import pipeline as jpipe
from repro_torch.convert import tables_from_numpy
from repro_torch.core import cnn as tcnn
from repro_torch.core import tags as ttags
from repro_torch.data import pipeline as tpipe

_TABLE_FIELDS = ("src_tag", "src_dest", "cam_tag", "cam_syn")


def _assert_tables_equal(j, t):
    for name in _TABLE_FIELDS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert (j.cluster_size, j.k_tags) == (t.cluster_size, t.k_tags)
    assert j.tile_of_cluster is None and t.tile_of_cluster is None
    assert j.fingerprint() == t.fingerprint()


def _random_spec(spec_cls, seed, n=64, cluster=16, k=96, edges=40, groups=12):
    """tests/test_compiler.py's ``_random_spec``, connection by connection,
    into either package's NetworkSpec."""
    rng = np.random.default_rng(seed)
    spec = spec_cls(
        n_neurons=n, cluster_size=cluster, k_tags=k,
        max_cam_words=64, max_sram_entries=16,
    )
    for _ in range(edges):
        spec.connect(int(rng.integers(n)), int(rng.integers(n)), int(rng.integers(4)))
    pops = [
        tuple(int(s) for s in rng.choice(n, size=int(rng.integers(1, 5)), replace=False))
        for _ in range(4)
    ]
    for _ in range(groups):
        srcs = pops[int(rng.integers(len(pops)))]
        tgts = [
            (int(rng.integers(n)), int(rng.integers(4)))
            for _ in range(int(rng.integers(1, 4)))
        ]
        spec.connect_group(
            srcs, tgts,
            shared_tag=bool(rng.integers(2)),
            copies=int(rng.integers(1, 3)),
        )
    return spec


def _compile_both(seed):
    """(repro tables or error, port tables or error) for one random spec."""
    out = []
    for mod in (jtags, ttags):
        try:
            out.append(mod.compile_network(_random_spec(mod.NetworkSpec, seed)))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 42, 115, 2024])
def test_compile_network_byte_equal_or_same_error(seed):
    j, t = _compile_both(seed)
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError) and str(t) == str(j)
    else:
        _assert_tables_equal(j, t)
        np.testing.assert_array_equal(j.dense_equivalent(), t.dense_equivalent())


def test_random_spec_115_raises_sram_fanout_error():
    """The spec Hypothesis found for test_compiler.py (seed 115) cannot be
    compiled by the greedy allocator: both packages raise the F/M error."""
    j, t = _compile_both(115)
    assert isinstance(j, ValueError) and isinstance(t, ValueError)
    assert "stage-1 fan-out exceeds F/M" in str(t) and str(t) == str(j)


def test_compile_errors_match_for_tag_and_cam_overflow():
    for mod in (jtags, ttags):
        spec = mod.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=2, max_cam_words=4)
        for s in range(4):
            spec.connect(s, 4)
        with pytest.raises(ValueError, match="tag overflow in cluster 1"):
            mod.compile_network(spec)
        spec = mod.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=16, max_cam_words=2)
        spec.connect_group([0], [(5, 0)], copies=3)
        with pytest.raises(ValueError, match="CAM capacity 2 exceeded"):
            mod.compile_network(spec)


def test_later_slices_raise_not_implemented():
    """``repair_placement`` (ported with faults and recovery) places this
    small net around a dead tile as repro's does; the compile refusals stay
    repro's."""
    from repro.core import compiler as jcomp
    from repro.core import faults as jfaults
    from repro.core.routing import Fabric as JFabric
    from repro_torch.core import compiler as tcomp
    from repro_torch.core import faults as tfaults
    from repro_torch.core.routing import Fabric

    spec = ttags.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=8)
    spec.connect(0, 5)
    jspec = jtags.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=8)
    jspec.connect(0, 5)
    got = tcomp.repair_placement(ttags.compile_network(spec), Fabric(),
                                 tfaults.FaultSpec(dead_tiles=(0,)))
    want = jcomp.repair_placement(jtags.compile_network(jspec), JFabric(),
                                  jfaults.FaultSpec(dead_tiles=(0,)))
    assert got[0].tobytes() == want[0].tobytes() and got[1] == want[1]
    # a placement is compiled now; without a fabric it is refused, as in repro
    with pytest.raises(ValueError, match="requires a fabric"):
        ttags.compile_network(spec, tile_of_cluster=[0, 1])
    with pytest.raises(ValueError, match="unknown allocator"):
        ttags.compile_network(spec, allocator="nope")


def test_reuse_allocator_and_table_v_report_match_repro():
    """Compiler v2's reuse allocator and the Table-V report equal repro's."""
    spec = ttags.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=8)
    spec.connect(0, 5)
    jspec = jtags.NetworkSpec(n_neurons=8, cluster_size=4, k_tags=8)
    jspec.connect(0, 5)
    _assert_tables_equal(jtags.compile_network(jspec, allocator="reuse"),
                         ttags.compile_network(spec, allocator="reuse"))
    t = tcnn.compile_poker_cnn(allocator="reuse", with_report=True)
    j = jcnn.compile_poker_cnn(allocator="reuse", with_report=True)
    _assert_tables_equal(j.tables, t.tables)
    assert t.report.summary() == j.report.summary()


@pytest.fixture(scope="module")
def poker_pair():
    return jcnn.compile_poker_cnn(), tcnn.compile_poker_cnn()


def test_compile_poker_cnn_default_byte_equal(poker_pair):
    j, t = poker_pair
    _assert_tables_equal(j.tables, t.tables)
    assert (j.conv, j.pool, j.out, j.conv_clusters) == (t.conv, t.pool, t.out, t.conv_clusters)
    assert j.cfg == jcnn.CnnConfig() and t.cfg == tcnn.CnnConfig()
    assert t.tables.n_neurons == 1536 and t.tables.n_clusters == 6
    # tables_from_numpy carries repro's tables across unchanged
    _assert_tables_equal(j.tables, tables_from_numpy(j.tables))


def test_compile_poker_cnn_with_fc_select_byte_equal():
    """A Hebbian-style selection that picks some pool neurons for several
    classes (so tags are shared across classes) compiles identically."""
    rng = np.random.default_rng(5)
    rates = rng.integers(0, 30, (4, 256)).astype(np.float64)
    sel_j = jcnn.hebbian_readout_select(rates)
    sel_t = tcnn.hebbian_readout_select(rates)
    np.testing.assert_array_equal(sel_j, sel_t)
    _assert_tables_equal(
        jcnn.compile_poker_cnn(fc_select=sel_j).tables,
        tcnn.compile_poker_cnn(fc_select=sel_t).tables,
    )


def test_neuron_params_and_kernels_equal():
    assert jcnn.poker_neuron_params().__dict__ == tcnn.poker_neuron_params().__dict__
    np.testing.assert_array_equal(jcnn.edge_kernels(), tcnn.edge_kernels())


@pytest.mark.parametrize("on_invalid", ["raise", "clip", "drop"])
def test_input_activity_on_invalid_matrix(poker_pair, on_invalid):
    j, t = poker_pair
    rng = np.random.default_rng(11)
    good = rng.integers(0, 32, (40, 2))
    bad = good.copy()
    bad[3] = (5, -1)
    bad[17] = (32, 4)
    all_bad = np.array([[-1, 0], [40, 40]])
    for events in (good, bad, all_bad, np.zeros((0, 2), np.int64)):
        try:
            ja = j.input_activity(events, on_invalid=on_invalid)
        except ValueError as e:
            with pytest.raises(ValueError, match="outside the 32x32 sensor") as te:
                t.input_activity(events, on_invalid=on_invalid)
            assert str(te.value) == str(e)
            continue
        ta = t.input_activity(events, on_invalid=on_invalid)
        assert ta.dtype == ja.dtype == np.float32
        np.testing.assert_array_equal(ja, ta)
    streams = [good, good[:5]] if on_invalid == "raise" else [good, bad, all_bad]
    np.testing.assert_array_equal(
        j.input_activity(streams, on_invalid=on_invalid),
        t.input_activity(streams, on_invalid=on_invalid),
    )
    with pytest.raises(ValueError, match="on_invalid must be"):
        t.input_activity(good, on_invalid="ignore")
    with pytest.raises(ValueError, match=r"\[n_ev, 2\]"):
        t.input_activity(np.zeros((3, 3)), on_invalid=on_invalid)


def test_dvs_streams_bit_identical():
    for symbol in range(4):
        for session in (0, 3):
            jcfg = jpipe.DvsStreamConfig(symbol=symbol, events_per_step=16, seed=9)
            tcfg = tpipe.DvsStreamConfig(symbol=symbol, events_per_step=16, seed=9)
            js = jpipe.DvsStreamSource(jcfg, session_id=session)
            ts = tpipe.DvsStreamSource(tcfg, session_id=session)
            for step in (0, 1, 24):
                np.testing.assert_array_equal(js.events(step), ts.events(step))
        np.testing.assert_array_equal(
            jpipe.symbol_dvs_events(symbol, 400, np.random.default_rng(7)),
            tpipe.symbol_dvs_events(symbol, 400, np.random.default_rng(7)),
        )
    with pytest.raises(ValueError, match="symbol must be"):
        tpipe.symbol_dvs_events(4, 10, np.random.default_rng(0))
