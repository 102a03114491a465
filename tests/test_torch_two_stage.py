"""repro_torch.core.two_stage / neuron against repro on the same inputs.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
  * queue ``src/weight/dropped``, stage-1 activity and stage-2 drive are
    bit-exact: spikes are 0/1, so every sum is an integer below 2**24 and
    exact in float32 whatever the order;
  * ``neuron_step`` state is ``allclose(rtol=1e-5, atol=1e-7)`` for a step
    taken from the same state (XLA's and PyTorch's ``exp`` may differ by an
    ULP), and spikes are equal over 50 free-running steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import neuron as jneuron
from repro.core import two_stage as jts
from repro.core.cnn import poker_neuron_params as j_poker_params
from repro.core.tags import NetworkSpec, compile_network
from repro_torch.convert import params_from_jax, state_from_numpy, tables_from_numpy
from repro_torch.core import neuron as tneuron
from repro_torch.core import two_stage as tts
from repro_torch.core.dispatch import _stage1_activity


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


def _both(tables):
    """(jax arrays, torch tensors) of (src_tag, src_dest, cam_tag, cam_syn)."""
    t = tables_from_numpy(tables)
    names = ("src_tag", "src_dest", "cam_tag", "cam_syn")
    return (
        [jnp.asarray(getattr(tables, k)) for k in names],
        [torch.as_tensor(getattr(t, k)) for k in names],
    )


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _jax_path(spikes, src_tag, src_dest, cam_tag, cam_syn, cap, nc, k, cluster_size):
    """repro's queue, stage 1 (queued and dense) and stage 2, in one jit."""
    q = jts.compact_events(spikes, cap)
    a = jts.stage1_route_events(q, src_tag, src_dest, nc, k)
    dense = jts.stage1_route(spikes, src_tag, src_dest, nc, k)
    return q.src, q.weight, q.dropped, a, dense, jts.stage2_cam_match(a, cam_tag, cam_syn, cluster_size)


@pytest.mark.parametrize("capacity", ["n", "overflow"])
@pytest.mark.parametrize("activity", [0.01, 0.1, 1.0])
@pytest.mark.parametrize("b", [1, 4])
def test_queue_activity_and_drive_bit_exact(b, activity, capacity):
    tables = _tables(31)
    n, nc, k = tables.n_neurons, tables.n_clusters, tables.k_tags
    jtab, (ts, td, tct, tcs) = _both(tables)
    rng = np.random.default_rng(int(activity * 100) + b)
    spikes = (rng.random((b, n)) < activity).astype(np.float32)
    cap = n if capacity == "n" else max(1, int(spikes.sum(-1).max()) // 2)
    j_src, j_w, j_drop, ja, j_dense, j_drive = _jax_path(
        jnp.asarray(spikes), *jtab, cap, nc, k, tables.cluster_size
    )

    tq = tts.compact_events(torch.as_tensor(spikes), cap)
    _eq(j_src, tq.src)
    _eq(j_w, tq.weight)
    _eq(j_drop, tq.dropped)
    assert tq.src.dtype == torch.int32 and tq.dropped.dtype == torch.int32
    if capacity == "overflow" and activity == 1.0:
        assert int(tq.dropped.min()) > 0  # the overflow case really drops

    ta = tts.stage1_route_events(tq, ts, td, nc, k)
    _eq(ja, ta)
    _eq(j_dense, tts.stage1_route(torch.as_tensor(spikes), ts, td, nc, k))
    # the engine's stage-1 entry point: dense shortcut at capacity >= N
    ta2, tdrop = _stage1_activity(torch.as_tensor(spikes), ts, td, nc, k, cap)
    _eq(ja if capacity == "overflow" else j_dense, ta2)
    _eq(j_drop, tdrop)

    tdrive = tts.stage2_cam_match(ta, tct, tcs, tables.cluster_size)
    assert tdrive.shape == (b, n, 4)
    _eq(j_drive, tdrive)


def test_gather_event_entries_and_unbatched_shapes():
    tables = _tables(5)
    n, nc, k = tables.n_neurons, tables.n_clusters, tables.k_tags
    (js, jd, jct, jcs), (ts, td, tct, tcs) = _both(tables)
    spikes = (np.random.default_rng(6).random(n) < 0.3).astype(np.float32)
    jq = jts.compact_events(jnp.asarray(spikes), 10)
    tq = tts.compact_events(torch.as_tensor(spikes), 10)
    for j, t in zip(jts.gather_event_entries(jq, js, jd), tts.gather_event_entries(tq, ts, td)):
        _eq(j, t)
    ta = tts.stage1_route(torch.as_tensor(spikes), ts, td, nc, k)
    assert ta.shape == (nc, k)
    _eq(jts.stage1_route(jnp.asarray(spikes), js, jd, nc, k), ta)
    tdrive = tts.stage2_cam_match(ta, tct, tcs, tables.cluster_size)
    assert tdrive.shape == (n, 4)
    with pytest.raises(ValueError, match="capacity must be positive"):
        tts.compact_events(torch.as_tensor(spikes), 0)


def test_stage2_float_activity_and_syn_onehot():
    """Random float activity: the plain stage 2 agrees with repro's to
    rtol=1e-6 (sums over the same words, possibly in another order); the
    one-hot plane is equal, including out-of-range types (all-zero rows)."""
    tables = _tables(2)
    (_, _, jct, jcs), (_, _, tct, tcs) = _both(tables)
    rng = np.random.default_rng(3)
    act = rng.random((3, tables.n_clusters, tables.k_tags)).astype(np.float32)
    np.testing.assert_allclose(
        tts.stage2_cam_match(torch.as_tensor(act), tct, tcs, tables.cluster_size).numpy(),
        np.asarray(jts.stage2_cam_match(jnp.asarray(act), jct, jcs, tables.cluster_size)),
        rtol=1e-6, atol=1e-6,
    )
    syn = rng.integers(-1, 6, (10, 7)).astype(np.int32)
    _eq(jts.precompute_syn_onehot(jnp.asarray(syn)),
        tts.precompute_syn_onehot(torch.as_tensor(syn)))


def _neuron_inputs(b, scale, n=256, steps=50):
    rng = np.random.default_rng(40 + b)
    counts = rng.integers(0, 3, (steps, b, n, 4)) * (rng.random((steps, b, n, 4)) < 0.3)
    drives = (counts * scale).astype(np.float32)
    i_ext = (rng.random((b, n)) * 0.2).astype(np.float32)
    return drives, i_ext


_j_neuron_step = jax.jit(jneuron.neuron_step, static_argnums=2)


def _state_np(state):
    return [np.array(getattr(state, k)) for k in ("v", "w", "refrac", "i_syn")]


@pytest.mark.parametrize("b", [1, 4])
def test_neuron_step_one_step_tolerance_over_50_steps(b):
    """Along a 50-step reference trajectory, each port step taken from the
    reference's own state agrees to allclose(rtol=1e-5, atol=1e-7), spikes
    equal. The drive is strong enough that neurons spike, reset and sit out
    refractory periods."""
    jp = j_poker_params()
    tp = params_from_jax(jp)
    drives, i_ext = _neuron_inputs(b, scale=2.0)
    jstate = jneuron.init_state(drives.shape[2], jp, batch=b)
    n_spikes = 0
    for t in range(drives.shape[0]):
        tstate = state_from_numpy(*_state_np(jstate), device="cpu")
        jstate, jspk = _j_neuron_step(jstate, jnp.asarray(drives[t]), jp, jnp.asarray(i_ext))
        tstate, tspk = tneuron.neuron_step(tstate, torch.as_tensor(drives[t]), tp, torch.as_tensor(i_ext))
        np.testing.assert_array_equal(np.asarray(jspk), tspk.numpy(), err_msg=f"step {t}")
        for name in ("v", "w", "refrac", "i_syn"):
            np.testing.assert_allclose(
                getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
                rtol=1e-5, atol=1e-7, err_msg=f"{name} at step {t}",
            )
        n_spikes += int(tspk.sum())
    assert n_spikes > 100


@pytest.mark.parametrize("b", [1, 4])
def test_neuron_step_free_running_spikes_equal_50_steps(b):
    """Each package runs 50 steps on its own state: spikes equal at every
    step. The free-running state is held by the one-step test above and not
    here: XLA's float32 ``exp`` differs from PyTorch's by one ULP on about a
    tenth of inputs, and near spike onset the AdExp exponential multiplies a
    membrane difference by up to ``dt/tau_m * e^10`` per step, so two correct
    runs drift apart in ``v`` and ``w`` without changing a spike."""
    jp = j_poker_params()
    tp = params_from_jax(jp)
    drives, i_ext = _neuron_inputs(b, scale=1.0)
    n = drives.shape[2]
    jstate = jneuron.init_state(n, jp, batch=b)
    tstate = tneuron.init_state(n, tp, batch=b, device="cpu")
    n_spikes = 0
    for t in range(drives.shape[0]):
        jstate, jspk = _j_neuron_step(jstate, jnp.asarray(drives[t]), jp, jnp.asarray(i_ext))
        tstate, tspk = tneuron.neuron_step(tstate, torch.as_tensor(drives[t]), tp, torch.as_tensor(i_ext))
        np.testing.assert_array_equal(np.asarray(jspk), tspk.numpy(), err_msg=f"step {t}")
        n_spikes += int(tspk.sum())
    assert n_spikes > 0


def test_state_from_numpy_round_trip():
    jp = j_poker_params()
    js = jneuron.init_state(8, jp, batch=2)
    ts = state_from_numpy(js.v, js.w, js.refrac, js.i_syn, device="cpu")
    ref = tneuron.init_state(8, params_from_jax(jp), batch=2, device="cpu")
    for name in ("v", "w", "refrac", "i_syn"):
        assert torch.equal(getattr(ts, name), getattr(ref, name))
    assert params_from_jax(jp) == tneuron.NeuronParams(
        refrac=1e-3, b_adapt=1e-3, input_gain=0.3, w_syn=(1.0, 3.0, 1.0, 1.0)
    )
    jax.clear_caches()
