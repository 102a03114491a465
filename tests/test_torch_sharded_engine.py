"""The port's multi-device engine against repro (DESIGN.md §2, §17).

The port's mesh is one process's array of ``torch.device`` s, and a device
may repeat: its multi-cell cases run here in-process on ``["cpu"] * k``.
repro's multi-device cases need fake XLA devices, which a process fixes at
its first JAX call, so they run once per module in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) that writes every
reference output to a temporary ``.npz``; repro's 1x1 cases run in-process.

Covered: the mesh collectives (``psum``, ``psum_scatter``, every cell's
slab), ``stage1_route_events_fabric(src_cluster_offset=)``,
``get_backend(**options)`` / ``EventEngine(backend_options=)``,
``ShardedBackend``, ``make_sharded_step`` queued and on the fabric (ring and
roll, per-link stats, link capacity 1 and 2, a lossy per-slab queue,
batched and unbatched, 1-D, 1x2 and 2x2 meshes), ``ShardedEventEngine`` on
1x1 and 2x2 meshes with its refusals, ``carry_pspecs``, ``place_carry``,
``reshard_tree`` and ``Checkpointer.restore(shardings=)``.

Tolerances: spikes, drive, delay lines, cursors and integer stats are
bit-exact (every sum is an integer count, exact in float32 in any order);
neuron state, taken each step from repro's carry, and the float latency /
energy sums are ``allclose(rtol=1e-5, atol=1e-7)``.
"""

import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as jdispatch
from repro.core import event_engine as jee
from repro.core import routing as jrouting
from repro.core import two_stage as jts
from repro.core.faults import FaultSpec as JFaultSpec
from repro.core.tags import NetworkSpec as JSpec
from repro.core.tags import compile_network as j_compile
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.convert import carry_from_numpy, params_from_jax, tables_from_numpy
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import event_engine as tee
from repro_torch.core import routing as trouting
from repro_torch.core import two_stage as tts
from repro_torch.core.faults import FaultSpec as TFaultSpec
from repro_torch.core.neuron import NeuronState
from repro_torch.distributed import mesh as tmesh
from repro_torch.distributed.elastic import reshard_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 1e-3
FAB = dict(grid_x=2, grid_y=2, cores_per_tile=2)  # 8 cores in 4 tiles, max_delay 4
INT_STATS = ("dropped", "link_dropped", "delivered", "hops")
STAT_FIELDS = (*INT_STATS, "latency_s", "energy_j")
STEPS = 6  # more than the ring's 5 slots: the cursor wraps
# make_sharded_step cases: the mesh, its cluster and batch axes, the carry's
# batch, the delivery mode and its options; each runs STEPS steps
CASES = {
    "queued_model4": dict(mesh=(4,), axes=("model",), batch=None, mode="queued", qc=None,
                          seed=1),
    "queued_lossy_2x2": dict(mesh=(2, 2), axes=("data", "model"), batch=4, mode="queued",
                             qc=20, seed=2),
    "ring_cap1_1x2": dict(mesh=(1, 2), axes=("data", "model"), batch=2, mode="ring", link=1,
                          seed=3),
    "ring_cap2_links_2x2": dict(mesh=(2, 2), axes=("data", "model"), batch=4, mode="ring",
                                link=2, per_link=True, qc=20, seed=4),
    "roll_cap2_model4": dict(mesh=(4,), axes=("model",), batch=None, mode="roll", link=2,
                             seed=5),
}
BACKEND_ACTIVITY = (0.0, 0.1, 1.0)


def _spec(mod, seed=0, n=64, cluster=8, k=32, edges=160):
    rng = np.random.default_rng(seed)
    spec = mod(n_neurons=n, cluster_size=cluster, k_tags=k, max_cam_words=32,
               max_sram_entries=16)
    seen = set()
    for _ in range(edges):
        s, d = int(rng.integers(n)), int(rng.integers(n))
        if (s, d) not in seen:
            seen.add((s, d))
            spec.connect(s, d, int(rng.integers(4)))
    return spec


def _fabric(mod):
    return mod.Fabric(**FAB, constants=mod.ChipConstants(latency_across_chip_s=2 * DT))


def _j_tables():
    return j_compile(_spec(JSpec), fabric=jrouting.Fabric(**FAB))


def _j_engine(tables, case):
    kw = {"queue_capacity": case.get("qc")}
    if case["mode"] != "queued":
        kw.update(fabric=_fabric(jrouting), fabric_options={
            "dt": DT, "ring": case["mode"] == "ring", "link_capacity": case.get("link"),
            "per_link_stats": case.get("per_link", False)})
    return jee.EventEngine(tables, **kw)


def _t_engine(jeng, tables, case, cls=tee.EventEngine, **extra):
    kw = {"queue_capacity": case.get("qc")}
    if case["mode"] != "queued":
        kw.update(fabric=_fabric(trouting), fabric_options={
            "dt": DT, "ring": case["mode"] == "ring", "link_capacity": case.get("link"),
            "per_link_stats": case.get("per_link", False)})
    if cls is tee.EventEngine:
        kw["device"] = "cpu"
    return cls(tables_from_numpy(tables), params_from_jax(jeng.params), **kw, **extra)


def _axes(case):
    """(cluster axis, batch axis) of a case's mesh."""
    return "model", ("data" if case["batch"] is not None else None)


def _inputs(case, tables):
    rng = np.random.default_rng(case["seed"])
    lead = () if case["batch"] is None else (case["batch"],)
    prev = (rng.random((*lead, tables.n_neurons)) < 0.4).astype(np.float32)
    shape = (STEPS, *lead, tables.n_clusters, tables.k_tags)
    counts = rng.integers(0, 3, shape) * (rng.random(shape) < 0.3)
    return prev, (counts * 8.0).astype(np.float32)


def _flat(carry) -> list[np.ndarray]:
    state, *rest = carry
    return [np.asarray(x) for x in (state.v, state.w, state.refrac, state.i_syn, *rest)]


def _carry(leaves):
    """The port's carry from ``_flat``'s leaves, on the CPU."""
    state = NeuronState(*(torch.as_tensor(x) for x in leaves[:4]))
    return (state, *(torch.as_tensor(x) for x in leaves[4:]))


def _backend_inputs(activity, tables, seed=7):
    rng = np.random.default_rng(seed)
    spikes = (rng.random((4, tables.n_neurons)) < activity).astype(np.float32)
    ext = (rng.integers(0, 3, (4, tables.n_clusters, tables.k_tags)) * 8.0).astype(np.float32)
    return spikes, ext


def _reference(path):
    """repro's multi-device outputs, on 8 fake CPU devices (run by the
    ``reference`` fixture in a subprocess)."""
    assert len(jax.devices()) >= 8, jax.devices()
    out = {}
    tables = _j_tables()
    for name, case in CASES.items():
        eng = _j_engine(tables, case)
        axis, batch_axis = _axes(case)
        # jitted: an eager shard_map call compiles anew on every call
        step = jax.jit(eng.make_sharded_step(jax.make_mesh(case["mesh"], case["axes"]), axis,
                                             batch_axis=batch_axis))
        prev, inputs = _inputs(case, tables)
        carry = eng.init_state(batch=case["batch"])
        carry = (carry[0], jnp.asarray(prev), *carry[2:])
        for t in range(STEPS):
            for i, x in enumerate(_flat(carry)):
                out[f"{name}/{t}/in{i}"] = x
            res = step(eng.tables, *carry, jnp.asarray(inputs[t]), jnp.zeros_like(carry[1]))
            if case["mode"] == "queued":
                carry = res[:2]
                if len(res) == 3:
                    out[f"{name}/{t}/stat_dropped"] = np.asarray(res[2])
            else:
                carry = res[:-1]
                for f in STAT_FIELDS:
                    out[f"{name}/{t}/stat_{f}"] = np.asarray(getattr(res[-1], f))
            for i, x in enumerate(_flat(carry)):
                out[f"{name}/{t}/out{i}"] = x
    backend = jdispatch.ShardedBackend(jax.make_mesh((2, 2), ("data", "model")))
    deliver = jax.jit(lambda spikes, ext: backend.deliver(
        spikes, tables.src_tag, tables.src_dest, tables.cam_tag, tables.cam_syn,
        tables.cluster_size, tables.k_tags, external_activity=ext, queue_capacity=20,
        with_stats=True))
    for act in BACKEND_ACTIVITY:
        spikes, ext = _backend_inputs(act, tables)
        drive, stats = deliver(jnp.asarray(spikes), jnp.asarray(ext))
        out[f"backend/{act}/drive"] = np.asarray(drive)
        out[f"backend/{act}/dropped"] = np.asarray(stats.dropped)
    case = CASES["ring_cap2_links_2x2"]
    eng = jee.ShardedEventEngine(tables, devices=jax.devices()[:4], cluster_devices=2,
                                 batch_devices=2, queue_capacity=20, fabric=_fabric(jrouting),
                                 fabric_options={"dt": DT, "link_capacity": 2})
    prev, inputs = _inputs(case, tables)
    carry = eng.init_state(batch=4)
    _, (spikes, stats) = eng.run((carry[0], jnp.asarray(prev), *carry[2:]), jnp.asarray(inputs))
    out["engine/spikes"] = np.asarray(spikes)
    for f in STAT_FIELDS:
        out[f"engine/stat_{f}"] = np.asarray(getattr(stats, f))
    split = jee.EventEngine(tables, fabric=_fabric(jrouting), fabric_options={"dt": DT})
    try:
        split.make_sharded_step(jax.make_mesh((8,), ("model",)), "model")
    except ValueError as e:
        out["error/tile_split"] = np.array(json.dumps(str(e)))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_engine") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}]; "
            f"import test_torch_sharded_engine as m; m._reference({str(path)!r})")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stdout + "\n" + done.stderr
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU side here is many small ops: one intra-op thread, so
    test workers running side by side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(shape, axes=tmesh.AXES):
    return tmesh.make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


def _assert_stats(got, want: dict, msg):
    for f, w in want.items():
        g = getattr(got, f).numpy()
        if f in INT_STATS:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}: {f}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=f"{msg}: {f}")


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 4])
def test_collectives_hand_every_cell_its_sum(n):
    """Every cell's slab of ``psum_scatter`` and every cell's ``psum``, on
    cells that share one device, against numpy; the inputs are untouched
    (sums go into fresh tensors, never into a cell's own buffer)."""
    rng = np.random.default_rng(n)
    parts_np = [rng.integers(0, 5, (3, 4 * n, 2)).astype(np.float32) for _ in range(n)]
    parts = [torch.as_tensor(p.copy()) for p in parts_np]
    total = np.sum(parts_np, axis=0)
    scattered = tmesh.psum_scatter(parts, dim=-2)
    summed = tmesh.psum(parts)
    for j in range(n):
        np.testing.assert_array_equal(scattered[j].numpy(), total[:, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(summed[j].numpy(), total)
        np.testing.assert_array_equal(parts[j].numpy(), parts_np[j])
    flat = tmesh.psum_scatter([p[:, :n] for p in parts], dim=1, tiled=False)
    for j in range(n):
        np.testing.assert_array_equal(flat[j].numpy(), total[:, j])
    with pytest.raises(ValueError, match="does not scatter"):
        tmesh.psum_scatter([p[:, :1] for p in parts] * 2, dim=1)


def test_mesh_shards_and_joins_like_a_partition_spec():
    mesh = _cpu_mesh((2, 3))
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert mesh.groups("model") == [[(0, 0), (0, 1), (0, 2)], [(1, 0), (1, 1), (1, 2)]]
    assert mesh.groups("data") == [[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(0, 2), (1, 2)]]
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    s = tmesh.NamedSharding(mesh, tmesh.P("data", "model"))
    parts = s.shard(x)
    np.testing.assert_array_equal(parts[(1, 2)].numpy(), x[2:4, 4:6].numpy())
    assert parts[(0, 0)].data_ptr() == x.data_ptr()  # a view on the same device
    assert torch.equal(s.unshard(parts, torch.device("cpu")), x)
    rep = tmesh.NamedSharding(mesh, tmesh.P())
    assert rep.unshard(rep.shard(x), torch.device("cpu")) is x
    with pytest.raises(ValueError, match="does not divide over the 3 devices"):
        tmesh.NamedSharding(mesh, tmesh.P(None, None, "model")).shard(x)
    with pytest.raises(ValueError, match="mesh needs 2 devices, only 1 visible"):
        tmesh.make_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError, match="got 3 devices for a 1 x 2 mesh"):
        tmesh.make_mesh((1, 2), devices=["cpu"] * 3)


# ---------------------------------------------------------------------------
# building blocks against repro in-process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_link_stats", [False, True])
@pytest.mark.parametrize("cursor", [None, 3])
@pytest.mark.parametrize("slab", [0, 1])
def test_stage1_route_events_fabric_offset_matches_repro(slab, cursor, per_link_stats):
    """One cell's stage 1 on its own slab (half of the 8 clusters): source
    clusters shift by ``src_cluster_offset``, tiles, delays and the stats
    stay indexed by global cluster."""
    tables = _j_tables()
    rng = np.random.default_rng(10 + slab)
    lo, hi = slab * 32, slab * 32 + 32
    spikes = (rng.random((3, 32)) < 0.6).astype(np.float32)
    m = jrouting.build_delivery_model(_fabric(jrouting), 8, DT, link_capacity=1)
    tm = trouting.build_delivery_model(_fabric(trouting), 8, DT, link_capacity=1)
    kw = dict(n_clusters=8, k_tags=32, cluster_size=8, n_tiles=m.n_tiles,
              max_delay=m.max_delay, link_capacity=1, per_link_stats=per_link_stats,
              src_cluster_offset=4 * slab)
    st, sd = np.asarray(tables.src_tag)[lo:hi], np.asarray(tables.src_dest)[lo:hi]
    j = jts.stage1_route_events_fabric(
        jts.compact_events(jnp.asarray(spikes), 20), jnp.asarray(st), jnp.asarray(sd),
        cluster_tile=jnp.asarray(m.tile_of_cluster), delay_steps=jnp.asarray(m.delay_steps),
        mesh_hops=jnp.asarray(m.mesh_hops), latency_s=jnp.asarray(m.latency_s),
        energy_j=jnp.asarray(m.energy_j),
        cursor=None if cursor is None else jnp.int32(cursor), **kw)
    t = tts.stage1_route_events_fabric(
        tts.compact_events(torch.as_tensor(spikes), 20), torch.as_tensor(st),
        torch.as_tensor(sd), cluster_tile=torch.as_tensor(tm.tile_of_cluster),
        delay_steps=torch.as_tensor(tm.delay_steps), mesh_hops=torch.as_tensor(tm.mesh_hops),
        latency_s=torch.as_tensor(tm.latency_s), energy_j=torch.as_tensor(tm.energy_j),
        cursor=None if cursor is None else torch.tensor(cursor, dtype=torch.int32), **kw)
    np.testing.assert_array_equal(t.buffer.numpy(), np.asarray(j.buffer))
    _assert_stats(t, {f: np.asarray(getattr(j, f)) for f in STAT_FIELDS[1:]}, "stage 1")
    assert int(t.link_dropped.sum()) > 0 and int(t.buffer.sum()) > 0


def test_get_backend_options_and_engine_backend_options():
    mesh = _cpu_mesh((1, 2))
    be = tdispatch.get_backend("sharded", mesh=mesh)
    assert isinstance(be, tdispatch.ShardedBackend) and be.mesh is mesh
    with pytest.raises(ValueError) as want:
        jdispatch.get_backend(jdispatch.ReferenceBackend(), mesh=None)
    with pytest.raises(ValueError) as got:
        tdispatch.get_backend(tdispatch.ReferenceBackend(), mesh=mesh)
    assert str(got.value) == str(want.value)
    tables = _j_tables()
    with pytest.raises(ValueError, match="passed as an instance"):
        tee.EventEngine(tables_from_numpy(tables), backend=be, backend_options={"mesh": mesh},
                        device="cpu")
    with pytest.raises(ValueError, match="lack 'data'"):
        tdispatch.ShardedBackend(tmesh.make_mesh((2,), ("model",), devices=["cpu"] * 2))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 2)])
def test_engine_on_sharded_backend_matches_repro(mesh_shape):
    """``EventEngine(backend="sharded", backend_options={"mesh": ...})`` on a
    lossless queue against repro's sharded backend on its 1x1 default mesh
    (the same drive on any mesh), each step from repro's carry."""
    tables = _j_tables()
    jeng = jee.EventEngine(tables, backend="sharded", queue_capacity=64)
    teng = tee.EventEngine(tables_from_numpy(tables), params_from_jax(jeng.params),
                           backend="sharded", queue_capacity=64, device="cpu",
                           backend_options={"mesh": _cpu_mesh(mesh_shape)})
    prev, inputs = _inputs(dict(CASES["ring_cap1_1x2"], batch=2), tables)
    jc = jeng.init_state(batch=2)
    jc = (jc[0], jnp.asarray(prev))
    for t in range(3):
        tc, (tspk, tst) = teng.step(carry_from_numpy(jc, device="cpu"), inputs[t])
        jc, (jspk, jst) = jeng.step(jc, jnp.asarray(inputs[t]))
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk), err_msg=f"step {t}")
        np.testing.assert_array_equal(tst.dropped.numpy(), np.asarray(jst.dropped))
        np.testing.assert_allclose(tc[0].v.numpy(), np.asarray(jc[0].v), rtol=1e-5, atol=1e-7)


@functools.cache
def _j_default_mesh_deliver():
    """repro's sharded backend on its default 1x1 mesh, jitted once for the
    module (an eager shard_map call compiles anew on every call)."""
    t = _j_tables()
    be = jdispatch.get_backend("sharded")
    return jax.jit(lambda spikes, ext: be.deliver(
        spikes, t.src_tag, t.src_dest, t.cam_tag, t.cam_syn, t.cluster_size, t.k_tags,
        external_activity=ext, queue_capacity=20, with_stats=True))


@pytest.mark.parametrize("activity", BACKEND_ACTIVITY)
def test_sharded_backend_default_mesh_matches_repro(activity):
    """The default 1x1 mesh on the spikes' device, a lossy queue and a 2-D
    batch shape: drive and drops equal repro's."""
    tables = _j_tables()
    spikes, ext = _backend_inputs(activity, tables)
    spikes, ext = spikes.reshape(2, 2, -1), ext.reshape(2, 2, *ext.shape[1:])
    args = (tables.cluster_size, tables.k_tags)
    jd, jst = _j_default_mesh_deliver()(jnp.asarray(spikes), jnp.asarray(ext))
    tt = tables_from_numpy(tables)
    td, tst = tdispatch.get_backend("sharded").deliver(
        torch.as_tensor(spikes), *(torch.as_tensor(getattr(tt, f)) for f in
                                   ("src_tag", "src_dest", "cam_tag", "cam_syn")),
        *args, external_activity=torch.as_tensor(ext), queue_capacity=20, with_stats=True)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tst.dropped.numpy(), np.asarray(jst.dropped))


# ---------------------------------------------------------------------------
# multi-device: the port on ["cpu"] * k against repro on fake devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_repro(reference, name):
    """Each step from repro's carry of that step: spikes, the delay line,
    the cursor and every integer stat (per link where asked) equal; neuron
    state and float stats within the tolerance."""
    case = CASES[name]
    tables = _j_tables()
    teng = _t_engine(_j_engine(tables, case), tables, case)
    axis, batch_axis = _axes(case)
    step = teng.make_sharded_step(_cpu_mesh(case["mesh"], case["axes"]), axis,
                                  batch_axis=batch_axis)
    _, inputs = _inputs(case, tables)
    n_leaves = {"queued": 5, "roll": 6, "ring": 7}[case["mode"]]
    busy = []
    for t in range(STEPS):
        carry = _carry([reference[f"{name}/{t}/in{i}"] for i in range(n_leaves)])
        res = step(teng.tables, *carry, torch.as_tensor(inputs[t]), None)
        got_carry = res[:2] if case["mode"] == "queued" else res[:-1]
        got = _flat(got_carry)
        for i in range(4, n_leaves):  # spikes, delay line, cursor: exact
            np.testing.assert_array_equal(got[i], reference[f"{name}/{t}/out{i}"],
                                          err_msg=f"{name} step {t} leaf {i}")
        for i in range(4):
            np.testing.assert_allclose(got[i], reference[f"{name}/{t}/out{i}"], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} step {t} state leaf {i}")
        prefix = f"{name}/{t}/stat_"
        want = {k[len(prefix):]: v for k, v in reference.items() if k.startswith(prefix)}
        if case["mode"] == "queued":
            if want:
                np.testing.assert_array_equal(res[2].numpy(), want["dropped"])
                busy.append(int(want["dropped"].sum()))
        else:
            _assert_stats(res[-1], want, f"{name} step {t}")
            busy.append(int(want["link_dropped"].sum()) if case.get("link") else 1)
            busy.append(int(reference[f"{name}/{t}/out5"].sum()))  # the delay line
    if case.get("qc") or case.get("link"):
        assert sum(busy) > 0  # drops and arrivals really happened


def test_sharded_backend_2x2_matches_repro(reference):
    tables = _j_tables()
    tt = tables_from_numpy(tables)
    be = tdispatch.ShardedBackend(_cpu_mesh((2, 2)))
    dropped = 0
    for act in BACKEND_ACTIVITY:
        spikes, ext = _backend_inputs(act, tables)
        drive, stats = be.deliver(
            torch.as_tensor(spikes), *(torch.as_tensor(getattr(tt, f)) for f in
                                       ("src_tag", "src_dest", "cam_tag", "cam_syn")),
            tt.cluster_size, tt.k_tags, external_activity=torch.as_tensor(ext),
            queue_capacity=20, with_stats=True)
        np.testing.assert_array_equal(drive.numpy(), reference[f"backend/{act}/drive"])
        np.testing.assert_array_equal(stats.dropped.numpy(), reference[f"backend/{act}/dropped"])
        dropped += int(stats.dropped.sum())
    assert dropped > 0


def test_sharded_engine_2x2_run_matches_repro(reference):
    """``ShardedEventEngine`` on a 2x2 mesh of one repeated device, fabric
    ring at link capacity 2, free-running: spikes and stats equal repro's
    engine on 4 fake devices at every step."""
    tables = _j_tables()
    case = CASES["ring_cap2_links_2x2"]
    jeng = jee.EventEngine(tables)
    eng = tee.ShardedEventEngine(tables_from_numpy(tables), params_from_jax(jeng.params),
                                 devices=["cpu"] * 4, cluster_devices=2, batch_devices=2,
                                 queue_capacity=20, fabric=_fabric(trouting),
                                 fabric_options={"dt": DT, "link_capacity": 2})
    assert eng.device == torch.device("cpu") and eng.mesh.shape == {"data": 2, "model": 2}
    prev, inputs = _inputs(case, tables)
    carry = eng.init_state(batch=4)
    _, (spikes, stats) = eng.run((carry[0], torch.as_tensor(prev), *carry[2:]), inputs)
    np.testing.assert_array_equal(spikes.numpy(), reference["engine/spikes"])
    _assert_stats(stats, {f: reference[f"engine/stat_{f}"] for f in STAT_FIELDS}, "run")
    assert int(stats.link_dropped.sum()) > 0


def test_fabric_step_refuses_a_split_tile_like_repro(reference):
    tables = _j_tables()
    teng = _t_engine(jee.EventEngine(tables), tables, dict(mode="roll"))
    with pytest.raises(ValueError) as got:
        teng.make_sharded_step(tmesh.make_mesh((8,), ("model",), devices=["cpu"] * 8), "model")
    assert json.dumps(str(got.value)) == str(reference["error/tile_split"])


# ---------------------------------------------------------------------------
# ShardedEventEngine against repro's 1x1 engine, refusals, placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["queued", "ring", "roll"])
def test_sharded_engine_1x1_matches_repro(mode):
    tables = _j_tables()
    case = dict(mode=mode, qc=24, link=2, batch=2, seed=20)
    opts = {} if mode == "queued" else dict(fabric=_fabric(jrouting), fabric_options={
        "dt": DT, "ring": mode == "ring", "link_capacity": 2})
    jeng = jee.ShardedEventEngine(tables, queue_capacity=24, **opts)
    teng = _t_engine(jeng, tables, case, cls=tee.ShardedEventEngine, devices=["cpu"])
    prev, inputs = _inputs(case, tables)
    jc = jeng.init_state(batch=2)
    jc = (jc[0], jnp.asarray(prev), *jc[2:])
    for t in range(4):
        tc, (tspk, tst) = teng.step(carry_from_numpy(jc, device="cpu"), inputs[t])
        jc, (jspk, jst) = jeng.step(jc, jnp.asarray(inputs[t]))
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk), err_msg=f"step {t}")
        for got, want in zip(tc[1:], jc[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {t}")
        fields = ("dropped",) if mode == "queued" else STAT_FIELDS
        _assert_stats(tst, {f: np.asarray(getattr(jst, f)) for f in fields}, f"step {t}")


def test_sharded_engine_refusals_match_repro():
    tables = _j_tables()
    tt = tables_from_numpy(tables)
    faults = dict(dead_links=((0, 1),))
    with pytest.raises(NotImplementedError) as want:
        jee.ShardedEventEngine(tables, fabric=_fabric(jrouting), fabric_options={
            "dt": DT, "faults": JFaultSpec(**faults)})
    with pytest.raises(NotImplementedError) as got:
        tee.ShardedEventEngine(tt, devices=["cpu"], fabric=_fabric(trouting), fabric_options={
            "dt": DT, "faults": TFaultSpec(**faults)})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jee.ShardedEventEngine(tables, cluster_devices=2)
    with pytest.raises(ValueError) as got:  # one CPU: only an explicit list may repeat it
        tee.ShardedEventEngine(tt, cluster_devices=2, device="cpu")
    assert str(want.value).startswith("mesh needs 2 devices, only 1 visible")
    assert str(got.value).startswith("mesh needs 2 devices, only 1 visible")
    with pytest.raises(ValueError, match="mesh extents must be positive, got 0 x 1"):
        tee.ShardedEventEngine(tt, batch_devices=0, device="cpu")
    with pytest.raises(ValueError, match="8 clusters do not divide over 3 cluster devices"):
        tee.ShardedEventEngine(tt, cluster_devices=3, devices=["cpu"] * 3)
    eng = tee.ShardedEventEngine(tt, devices=["cpu"] * 2, batch_devices=2, queue_capacity=8)
    with pytest.raises(ValueError, match="does not divide over the 2 devices"):
        eng.step(eng.init_state(batch=3), np.zeros((3, 8, 32), np.float32))
    if torch.cuda.is_available():  # the card by default
        assert tee.ShardedEventEngine(tt).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tee.ShardedEventEngine(tt)


@pytest.mark.parametrize("ring", [True, False, None])
def test_carry_pspecs_and_place_carry(ring):
    """``carry_pspecs`` is repro's tree for the queued, ring and roll
    carries; ``place_carry`` lands numpy leaves as tensors on the mesh's
    home device and refuses a batch that does not divide."""
    tables = _j_tables()
    fab = {} if ring is None else dict(fabric_options={"dt": DT, "ring": ring})
    jeng = jee.ShardedEventEngine(tables, queue_capacity=64,
                                  **(dict(fabric=_fabric(jrouting), **fab) if fab else {}))
    teng = tee.ShardedEventEngine(tables_from_numpy(tables), devices=["cpu"] * 4,
                                  cluster_devices=2, batch_devices=2, queue_capacity=64,
                                  **(dict(fabric=_fabric(trouting), **fab) if fab else {}))
    want = jeng.carry_pspecs()
    got = teng.carry_pspecs()
    assert len(got) == len(want) == {None: 2, True: 4, False: 3}[ring]
    assert [tuple(getattr(got[0], f)) for f in ("v", "w", "refrac", "i_syn")] == \
        [tuple(getattr(want[0], f)) for f in ("v", "w", "refrac", "i_syn")]
    assert [tuple(g) for g in got[1:]] == [tuple(w) for w in want[1:]]
    host = tmesh.tree_map(lambda x: x.numpy(), teng.init_state(batch=4))
    placed = teng.place_carry(host)
    assert all(isinstance(x, torch.Tensor) and x.device == teng.mesh.home
               for x in (*placed[0].__dict__.values(), *placed[1:]))
    np.testing.assert_array_equal(placed[1].numpy(), host[1])
    with pytest.raises(ValueError, match="does not divide over the 2 devices"):
        teng.place_carry(teng.init_state(batch=3))


def test_reshard_tree_and_restore_with_shardings(tmp_path):
    """A tree round-trips across meshes of another shape without a value
    change, and a checkpointed carry restores onto a mesh through
    ``named(mesh, carry_pspecs())``."""
    mesh_a, mesh_b = _cpu_mesh((2, 4)), _cpu_mesh((4, 2))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": np.arange(8, dtype=np.float32), "nested": {"scale": np.float32(3.5)}}
    specs = {"w": tmesh.P("data", "model"), "b": tmesh.P("model"), "nested": {"scale": tmesh.P()}}
    back = reshard_tree(reshard_tree(reshard_tree(tree, specs, mesh_a), specs, mesh_b), specs,
                        mesh_a)
    assert torch.equal(back["w"], tree["w"]) and back["b"].numpy().tolist() == list(range(8))
    assert float(back["nested"]["scale"]) == 3.5
    with pytest.raises(ValueError, match="does not divide"):
        reshard_tree({"b": np.zeros(6)}, {"b": tmesh.P("model")}, mesh_a)
    tables = _j_tables()
    eng = tee.ShardedEventEngine(tables_from_numpy(tables), devices=["cpu"] * 2,
                                 cluster_devices=2, fabric=_fabric(trouting),
                                 fabric_options={"dt": DT}, queue_capacity=64)
    carry = eng.init_state(batch=2)
    carry, _ = eng.step(carry, np.full((2, 8, 32), 8.0, np.float32))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"carry": carry}, blocking=True)
    out = ck.restore(1, {"carry": carry}, shardings={"carry": tmesh.named(eng.mesh, eng.carry_pspecs())})
    for got, want in zip(out["carry"][1:], carry[1:]):
        assert torch.equal(got, want) and got.device == eng.mesh.home
    assert torch.equal(out["carry"][0].v, carry[0].v)
    with pytest.raises(ValueError, match="does not divide"):
        ck.restore(1, {"carry": carry}, shardings={"carry": tmesh.named(
            _cpu_mesh((3, 1)), eng.carry_pspecs())})
