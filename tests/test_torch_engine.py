"""The port's dispatch backends and EventEngine against repro and the dense oracle.

The backend matrix of tests/test_dispatch.py, on the CPU, where the ``cuda``
and ``fused`` backends run their kernels' plain versions. Tolerances:
  * drive, ``dropped`` and spikes are bit-exact: spikes are 0/1 and the
    external activity is an integer count times 8.0, so every sum is an
    integer below 2**24, exact in float32 in any order;
  * float neuron state is ``allclose(rtol=1e-5, atol=1e-7)`` for a step taken
    from the same carry; a free-running run is held by its spikes and drops
    (tests/test_torch_two_stage.py says why its state is not).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import event_engine as jee
from repro.core.tags import NetworkSpec, compile_network
from repro.core.two_stage import two_stage_deliver
from repro_torch.convert import params_from_jax, state_from_numpy, tables_from_numpy
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import event_engine as tee
from repro_torch.core.neuron import NeuronState

PORT_BACKENDS = ["reference", "cuda", "fused"]


def _tables(seed, n=48, cluster=16, k=48, edges=60):
    rng = np.random.default_rng(seed)
    spec = NetworkSpec(n_neurons=n, cluster_size=cluster, k_tags=k,
                       max_cam_words=24, max_sram_entries=16)
    seen = set()
    for _ in range(edges):
        s, d = int(rng.integers(n)), int(rng.integers(n))
        if (s, d) in seen:
            continue
        seen.add((s, d))
        spec.connect(s, d, int(rng.integers(4)))
    return compile_network(spec)


def _table_tensors(tables):
    t = tables_from_numpy(tables)
    return [torch.as_tensor(getattr(t, k)) for k in ("src_tag", "src_dest", "cam_tag", "cam_syn")]


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def _j_deliver(spikes, ext, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k, cap):
    return two_stage_deliver(
        spikes, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k,
        external_activity=ext, queue_capacity=cap, with_stats=True,
    )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_registry():
    assert set(tdispatch.available_backends()) == {"reference", "cuda", "fused", "fabric",
                                                   "sharded"}
    with pytest.raises(ValueError, match="unknown dispatch backend"):
        tdispatch.get_backend("pallas")
    inst = tdispatch.FusedBackend()
    assert tdispatch.get_backend(inst) is inst
    assert isinstance(tdispatch.get_backend(None), tdispatch.ReferenceBackend)
    assert isinstance(tdispatch.get_backend("cuda"), tdispatch.CudaBackend)


# ---------------------------------------------------------------------------
# backend matrix vs repro and the dense oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("activity", [0.01, 0.1, 1.0])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_backend_matches_repro_and_dense_oracle(backend, b, activity):
    tables = _tables(31)
    n, nc, k, cs = tables.n_neurons, tables.n_clusters, tables.k_tags, tables.cluster_size
    dense = dense_w = tee.dense_weights_from_tables(tables_from_numpy(tables))
    np.testing.assert_array_equal(dense, jee.dense_weights_from_tables(tables))
    rng = np.random.default_rng(int(activity * 100) + b)
    spikes = (rng.random((b, n)) < activity).astype(np.float32)
    ext = rng.integers(0, 3, (b, nc, k)).astype(np.float32) * 8.0
    tt = _table_tensors(tables)
    jt = [jnp.asarray(a) for a in (tables.src_tag, tables.src_dest, tables.cam_tag, tables.cam_syn)]
    bk = tdispatch.get_backend(backend)
    oracle = np.einsum("dst,bs->bdt", dense_w, spikes)
    for cap in (None, n, max(1, int(spikes.sum(-1).max()) // 2)):
        drive, stats = bk.deliver(
            torch.as_tensor(spikes), *tt, cs, k, external_activity=torch.as_tensor(ext),
            queue_capacity=cap, with_stats=True,
        )
        j_drive, j_stats = _j_deliver(jnp.asarray(spikes), jnp.asarray(ext), *jt, cs, k, cap)
        assert drive.shape == (b, n, 4)
        np.testing.assert_array_equal(drive.numpy(), np.asarray(j_drive), err_msg=f"cap={cap}")
        np.testing.assert_array_equal(stats.dropped.numpy(), np.asarray(j_stats.dropped))
        if cap is None or cap == n:  # lossless: the dense oracle sees every event
            assert int(stats.dropped.max()) == 0
            no_ext = bk.deliver(torch.as_tensor(spikes), *tt, cs, k, queue_capacity=cap)
            np.testing.assert_array_equal(no_ext.numpy(), oracle)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_backend_unbatched_and_multidim_shapes(backend):
    tables = _tables(23)
    tt = _table_tensors(tables)
    dense = tee.dense_weights_from_tables(tables_from_numpy(tables))
    rng = np.random.default_rng(24)
    bk = tdispatch.get_backend(backend)
    for shape, eq in (((tables.n_neurons,), "dst,s->dt"), ((2, 3, tables.n_neurons), "dst,bcs->bcdt")):
        spikes = (rng.random(shape) < 0.3).astype(np.float32)
        drive = bk.deliver(torch.as_tensor(spikes), *tt, tables.cluster_size, tables.k_tags)
        assert drive.shape == (*shape, 4)
        np.testing.assert_array_equal(drive.numpy(), np.einsum(eq, dense, spikes))


# ---------------------------------------------------------------------------
# engine: step / run / reset_slots vs repro's engine
# ---------------------------------------------------------------------------
def _inputs(tables, steps, b, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, (steps, b, tables.n_clusters, tables.k_tags))
    return (counts * (rng.random(counts.shape) < 0.2) * 8.0).astype(np.float32)


def _assert_state_close(t_state: NeuronState, j_state):
    for name in ("v", "w", "refrac", "i_syn"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), np.asarray(getattr(j_state, name)),
            rtol=1e-5, atol=1e-7, err_msg=name,
        )


def _port_carry(j_carry):
    state, spikes = j_carry
    return (
        state_from_numpy(state.v, state.w, state.refrac, state.i_syn, device="cpu"),
        torch.as_tensor(np.array(spikes)),
    )


@pytest.mark.parametrize("capacity", [None, "n", "small"])
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_engine_steps_match_repro(backend, capacity):
    """Each port step starts from repro's carry of that step: spikes and
    drops equal, state within the tolerance."""
    tables = _tables(11)
    cap = {None: None, "n": tables.n_neurons, "small": 6}[capacity]
    jeng = jee.EventEngine(tables, queue_capacity=cap)
    teng = tee.EventEngine(
        tables_from_numpy(tables), params_from_jax(jeng.params), backend=backend,
        queue_capacity=cap, device="cpu",
    )
    b = 3
    inp = _inputs(tables, 12, b, seed=12)
    jc = jeng.init_state(batch=b)
    n_spikes = 0
    for t in range(inp.shape[0]):
        tc, tout = teng.step(_port_carry(jc), inp[t])
        jc, jout = jeng.step(jc, jnp.asarray(inp[t]))
        if cap is None:
            jspk, tspk = jout, tout
        else:
            (jspk, jst), (tspk, tst) = jout, tout
            np.testing.assert_array_equal(tst.dropped.numpy(), np.asarray(jst.dropped))
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk), err_msg=f"step {t}")
        _assert_state_close(tc[0], jc[0])
        n_spikes += int(tspk.sum())
    assert n_spikes > 0


def test_engine_run_matches_repro_run_with_time_varying_current():
    """Free-running: spikes and drops equal at every step."""
    tables = _tables(13)
    cap = 1
    jeng = jee.EventEngine(tables, queue_capacity=cap)
    teng = tee.EventEngine(tables_from_numpy(tables), params_from_jax(jeng.params),
                           backend="fused", queue_capacity=cap, device="cpu")
    b, steps = 2, 10
    inp = _inputs(tables, steps, b, seed=14)
    i_ext = (np.random.default_rng(15).random((steps, b, tables.n_neurons)) * 2.0).astype(np.float32)
    jc, (jspk, jst) = jeng.run(jeng.init_state(batch=b), jnp.asarray(inp), jnp.asarray(i_ext))
    tc, (tspk, tst) = teng.run(teng.init_state(batch=b), inp, i_ext)
    assert tspk.shape == (steps, b, tables.n_neurons) and tst.dropped.shape == (steps, b)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    np.testing.assert_array_equal(tst.dropped.numpy(), np.asarray(jst.dropped))
    assert int(tspk.sum()) > 0 and int(tst.dropped.sum()) > 0
    # no queue: run returns the spikes alone
    teng2 = tee.EventEngine(tables_from_numpy(tables), device="cpu")
    _, spk = teng2.run(teng2.init_state(batch=b), inp)
    assert isinstance(spk, torch.Tensor) and spk.shape == (steps, b, tables.n_neurons)


def test_reset_slots_bit_exact():
    """Masked slots return to fresh state, unmasked slots are untouched bit
    for bit, and the result equals repro's reset of the same carry."""
    tables = _tables(17)
    jeng = jee.EventEngine(tables)
    teng = tee.EventEngine(tables_from_numpy(tables), device="cpu")
    b = 4
    inp = _inputs(tables, 6, b, seed=18)
    tc = teng.init_state(batch=b)
    for t in range(inp.shape[0]):
        tc, _ = teng.step(tc, inp[t])
    mask = np.array([True, False, True, False])
    out = teng.reset_slots(tc, mask)
    fresh = teng.init_state(batch=b)
    for name in ("v", "w", "refrac", "i_syn"):
        got, before, new = (getattr(c[0], name) for c in (out, tc, fresh))
        assert torch.equal(got[mask], new[mask]) and torch.equal(got[~mask], before[~mask])
    assert torch.equal(out[1][~mask], tc[1][~mask]) and not out[1][mask].any()
    # repro's reset of the same carry
    jstate = type(jeng.init_state()[0])(
        *(jnp.asarray(getattr(tc[0], k).numpy()) for k in ("v", "w", "refrac", "i_syn"))
    )
    jout = jeng.reset_slots((jstate, jnp.asarray(tc[1].numpy())), mask)
    for name in ("v", "w", "refrac", "i_syn"):
        np.testing.assert_array_equal(getattr(out[0], name).numpy(), np.asarray(getattr(jout[0], name)))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    with pytest.raises(ValueError, match="does not match"):
        teng.reset_slots(tc, np.array([True, False]))
    with pytest.raises(ValueError, match="batched carry"):
        teng.reset_slots(tc, np.array(True))


def test_engine_step_equals_dense_oracle():
    tables = _tables(19)
    teng = tee.EventEngine(tables_from_numpy(tables), backend="cuda", device="cpu")
    dense = torch.as_tensor(tee.dense_weights_from_tables(tables_from_numpy(tables)))
    b = 2
    inp = _inputs(tables, 8, b, seed=20)
    rng = np.random.default_rng(21)
    v0 = rng.uniform(-0.07, -0.045, (b, tables.n_neurons)).astype(np.float32)
    zeros = np.zeros_like(v0)
    state = state_from_numpy(v0, zeros, zeros, np.zeros((*v0.shape, 4), np.float32),
                             device="cpu")
    spikes = torch.as_tensor((rng.random(v0.shape) < 0.5).astype(np.float32))
    carry, oracle = (state, spikes), (state, spikes)
    for t in range(inp.shape[0]):
        carry, out = teng.step(carry, inp[t])
        # the oracle reads external tag activity through the CAM as drive
        ext_drive = teng.backend.cam_match(
            torch.as_tensor(inp[t]), teng.tables.cam_tag, teng.tables.cam_syn, tables.cluster_size
        )
        ostate, ospk = tee.dense_reference_step(dense, oracle[1], oracle[0], teng.params, ext_drive)
        oracle = (ostate, ospk)
        assert torch.equal(out, ospk), f"step {t}"
        for name in ("v", "w", "refrac", "i_syn"):
            assert torch.equal(getattr(carry[0], name), getattr(ostate, name)), name


def test_engine_defaults_to_cuda():
    tables = tables_from_numpy(_tables(3))
    if torch.cuda.is_available():
        assert tee.EventEngine(tables).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tee.EventEngine(tables)
    with pytest.raises(ValueError, match="queue_capacity must be positive"):
        tee.EventEngine(tables, queue_capacity=0, device="cpu")
