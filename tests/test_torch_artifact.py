"""Compiled-network artifacts in the port against repro: files written by
either package load in the other with an equal fingerprint, tampered files
are refused, ``retarget`` names the same binding constraint at the same
utilisation, ``artifact_from_tables`` keeps post-processed (spliced)
tables, and ``entry_table`` rebuilds repro's fabric entry columns."""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import compiler as jcomp
from repro.core import tags as jtags
from repro_torch.core import cnn as tcnn
from repro_torch.core import compiler as tcomp
from repro_torch.core import tags as ttags
from repro_torch.core.event_engine import EventEngine, dense_weights_from_tables
from repro_torch.core.neuron import neuron_step
from repro_torch.core.two_stage import stage2_cam_match
from tests.test_torch_compiler import shuffle_spec

_TABLES = ("src_tag", "src_dest", "cam_tag", "cam_syn", "tile_of_cluster")
_GEO = {"grid_x": 2, "grid_y": 2, "cores_per_tile": 1, "neurons_per_core": 16, "k_tags": 96}


def _spec(tags, seed, n=64, cluster=16, k=96, edges=40, groups=8):
    """tests/test_artifact.py's ``_random_spec`` into either package."""
    rng = np.random.default_rng(seed)
    spec = tags.NetworkSpec(n_neurons=n, cluster_size=cluster, k_tags=k,
                            max_cam_words=64, max_sram_entries=16)
    for _ in range(edges):
        spec.connect(int(rng.integers(n)), int(rng.integers(n)), int(rng.integers(4)))
    for _ in range(groups):
        srcs = [int(s) for s in rng.choice(n, size=int(rng.integers(1, 4)), replace=False)]
        tgts = [(int(rng.integers(n)), int(rng.integers(4)))
                for _ in range(int(rng.integers(1, 4)))]
        spec.connect_group(srcs, tgts, shared_tag=bool(rng.integers(2)))
    return spec


def _assert_artifacts_equal(a, b):
    assert a.fingerprint() == b.fingerprint()
    for name in _TABLES:
        x, y = np.asarray(getattr(a.tables, name)), np.asarray(getattr(b.tables, name))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert a.geometry.asdict() == b.geometry.asdict()
    assert a.feasibility.asdict() == b.feasibility.asdict()
    if a.report is None:
        assert b.report is None
        return
    for name in ("tags_used", "tags_v1", "sram_fill", "cam_fill", "tile_of_cluster"):
        np.testing.assert_array_equal(getattr(a.report, name), getattr(b.report, name))
    for name in ("k_tags", "cluster_size", "sram_bits", "cam_bits", "eq2_bits_per_neuron",
                 "measured_bits_per_neuron", "mean_hops"):
        assert getattr(a.report, name) == getattr(b.report, name), name


@pytest.fixture(scope="module")
def retargeted():
    kw = {"anneal_steps": 50}
    return (jcomp.retarget(_spec(jtags, 3), jcomp.Geometry(**_GEO), **kw),
            tcomp.retarget(_spec(ttags, 3), tcomp.Geometry(**_GEO), **kw))


def test_retarget_equal_to_repro(retargeted):
    _assert_artifacts_equal(*retargeted)


def test_repro_artifact_loads_in_port_and_back(retargeted, tmp_path):
    j, t = retargeted
    back_t = tcomp.CompiledArtifact.load(j.save(str(tmp_path / "from_repro")))
    _assert_artifacts_equal(j, back_t)
    back_j = jcomp.CompiledArtifact.load(t.save(str(tmp_path / "from_port")))
    _assert_artifacts_equal(t, back_j)
    files = {}
    for who in ("from_repro", "from_port"):
        with open(tmp_path / who / "artifact.json") as f:
            files[who] = json.load(f)
        with np.load(tmp_path / who / "tables.npz") as z:
            files[who + "_npz"] = {k: z[k] for k in z.files}
    assert files["from_repro"] == files["from_port"]
    assert files["from_port"]["format"] == 1
    npz_j, npz_t = files["from_repro_npz"], files["from_port_npz"]
    assert sorted(npz_j) == sorted(npz_t)
    for k in npz_j:
        assert npz_j[k].dtype == npz_t[k].dtype and npz_j[k].tobytes() == npz_t[k].tobytes(), k


@pytest.mark.parametrize("what", ["npz", "json"])
def test_tampered_artifact_refused(retargeted, tmp_path, what):
    j, t = retargeted
    for art, comp in ((t, tcomp), (j, tcomp), (t, jcomp)):
        path = art.save(str(tmp_path / f"{comp.__name__}_{id(art)}"))
        if what == "npz":
            npz = os.path.join(path, "tables.npz")
            with np.load(npz) as z:
                arrays = {k: z[k] for k in z.files}
            arrays["cam_syn"] = arrays["cam_syn"].copy()
            arrays["cam_syn"].flat[0] ^= 1
            np.savez(npz, **arrays)
        else:
            meta_path = os.path.join(path, "artifact.json")
            with open(meta_path) as f:
                meta = json.load(f)
            meta["geometry"]["max_cam_words"] += 1
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        with pytest.raises(ValueError, match="corrupt"):
            comp.CompiledArtifact.load(path)


@pytest.mark.parametrize(
    "geo, binding",
    [
        ({"grid_x": 1, "grid_y": 1, "cores_per_tile": 2, "neurons_per_core": 16,
          "k_tags": 96}, "cores"),
        ({**_GEO, "max_cam_words": 1}, "cam"),
        ({**_GEO, "max_sram_entries": 1}, "sram"),
        ({**_GEO, "k_tags": 2}, "tags"),
    ],
)
def test_retarget_names_binding_constraint_as_repro(geo, binding):
    errs = []
    for tags, comp in ((jtags, jcomp), (ttags, tcomp)):
        with pytest.raises(comp.InfeasibleGeometryError) as ei:
            comp.retarget(_spec(tags, 5), comp.Geometry(**geo))
        errs.append(ei.value)
    j, t = errs
    assert isinstance(t, ValueError)
    assert t.report.binding == j.report.binding == binding and not t.report.feasible
    assert t.report.asdict() == j.report.asdict()
    assert str(t) == str(j)


@pytest.mark.parametrize("seed, geo", [
    (6, {**_GEO, "cores_per_tile": 2}),
    (8, {**_GEO, "grid_x": 4, "grid_y": 1}),
    (9, {"grid_x": 2, "grid_y": 2, "cores_per_tile": 2, "neurons_per_core": 8, "k_tags": 96}),
])
@pytest.mark.parametrize("optimize", [False, True])
def test_retarget_feasible_utilisation_equal(seed, geo, optimize):
    j = jcomp.retarget(_spec(jtags, seed), jcomp.Geometry(**geo), optimize=optimize,
                       anneal_steps=100)
    t = tcomp.retarget(_spec(ttags, seed), tcomp.Geometry(**geo), optimize=optimize,
                       anneal_steps=100)
    _assert_artifacts_equal(j, t)
    fz = t.feasibility
    assert fz.feasible and set(fz.utilization) == {"tags", "cam", "sram", "cores", "link"}
    assert fz.binding == max(fz.utilization, key=fz.utilization.get)


def test_artifact_from_tables_keeps_spliced_table_v_taps():
    """Table-V's input taps are spliced into the conv CAMs after compiling,
    so a recompile would lose them: the placement-only retarget binds the
    tables as they are, on the paper's prototype geometry."""
    j = jcnn.compile_poker_cnn(allocator="reuse", with_report=True)
    t = tcnn.compile_poker_cnn(allocator="reuse", with_report=True)
    aj = jcomp.artifact_from_tables(jcomp.CompileResult(j.tables, j.report), jcomp.Geometry())
    at = tcomp.artifact_from_tables(tcomp.CompileResult(t.tables, t.report), tcomp.Geometry())
    _assert_artifacts_equal(aj, at)
    for name in ("src_tag", "src_dest", "cam_tag", "cam_syn"):
        np.testing.assert_array_equal(getattr(at.tables, name), getattr(t.tables, name))
    assert at.report is t.report
    # wrong cluster size cannot be fixed by placement alone
    with pytest.raises(tcomp.InfeasibleGeometryError) as ei:
        tcomp.artifact_from_tables(t.tables, tcomp.Geometry(neurons_per_core=32))
    assert ei.value.report.binding == "cores"


def test_entry_table_equal_to_repro_columns(retargeted):
    j, t = retargeted
    ej, et = j.entry_table(), t.entry_table(device="cpu")
    for name in ("src", "dstk", "delay", "cross", "link_start", "link", "hops",
                 "latency_s", "energy_j", "valid", "alive"):
        a, b = np.asarray(getattr(ej, name)), getattr(et, name).numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    eng = EventEngine(t, fabric=t.geometry.fabric(), queue_capacity=t.tables.n_neurons,
                      device="cpu")
    for name in ("src", "dstk", "delay", "cluster_start", "cluster_order"):
        assert getattr(eng._fabric_entries, name).equal(getattr(et, name)), name


def delayed_dense_weights(tables, model) -> list[torch.Tensor]:
    """The dense oracle's ``[N, N, 4]`` weights split by fabric arrival
    delay: ``w[d]`` holds the connections whose cluster pair arrives ``d``
    steps late."""
    dense = torch.as_tensor(dense_weights_from_tables(tables))
    cl = torch.arange(tables.n_neurons) // tables.cluster_size
    delay = torch.as_tensor(np.asarray(model.delay_steps))[cl[:, None], cl[None, :]]  # [dst, src]
    return [dense * (delay == d)[..., None] for d in range(model.max_delay + 1)]


def test_retargeted_shuffle_network_steps_like_the_dense_oracle(tmp_path):
    """The chip smoke's retarget phase at smoke size: the shuffle network
    retargeted to 2x2 tiles of 4 cores of 8 neurons, saved and loaded, and
    stepped through the fabric ring at lossless links equals the dense
    oracle whose connections arrive at their cluster pair's delay, spikes
    step for step."""
    geo = tcomp.Geometry(grid_x=2, grid_y=2, cores_per_tile=4, neurons_per_core=8, k_tags=64)
    art = tcomp.retarget(shuffle_spec(ttags, cluster=8), geo)
    back = tcomp.CompiledArtifact.load(art.save(str(tmp_path / "art")))
    assert back.fingerprint() == art.fingerprint()
    assert back.feasibility.binding == "cores" and back.feasibility.utilization["cores"] == 1.0
    t = back.tables
    eng = EventEngine(back, fabric=geo.fabric(), queue_capacity=t.n_neurons, device="cpu",
                      fabric_options={"link_capacity": t.n_neurons})
    w = delayed_dense_weights(t, eng.fabric_model)
    assert len(w) == 2  # cross-tile events arrive a step late
    rng = np.random.default_rng(0)
    state, _, ring, cursor = eng.init_state(batch=2)
    spikes = torch.as_tensor((rng.random((2, t.n_neurons)) < 0.5).astype(np.float32))
    carry = (state, spikes, ring, cursor)
    history = [spikes] + [torch.zeros_like(spikes)] * (len(w) - 1)  # newest first
    o_state = state
    for step in range(4):
        ext = torch.as_tensor((rng.integers(0, 3, (2, t.n_clusters, t.k_tags)) * 8.0)
                              .astype(np.float32))
        carry, (got, stats) = eng.step(carry, ext)
        drive = stage2_cam_match(ext, eng.tables.cam_tag, eng.tables.cam_syn, t.cluster_size)
        for d, wd in enumerate(w):
            drive = drive + torch.einsum("dst,bs->bdt", wd, history[d])
        o_state, o_spikes = neuron_step(o_state, drive, eng.params)
        assert int(stats.link_dropped.sum()) == 0
        assert torch.equal(got, o_spikes), step
        torch.testing.assert_close(carry[0].v, o_state.v, rtol=1e-5, atol=1e-7)
        history = [o_spikes] + history[:-1]
