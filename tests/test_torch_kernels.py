"""The port's kernel modules: cam_match and fused_deliver.

The plain versions against repro's Pallas kernels in interpret mode, on the
CPU, at the small shapes tests/test_dispatch.py uses (block_c=8): bit-exact
on integer-valued activity; allclose(rtol=1e-5, atol=1e-5) on random floats,
as test_dispatch holds the Pallas kernels to their reference. The CUDA legs,
kernel against plain version on the card, are in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.two_stage import compact_events as j_compact_events
from repro.kernels.cam_match.cam_match import cam_match_pallas
from repro.kernels.fused_deliver import fused_deliver as j_fused_deliver
from repro_torch.core.two_stage import compact_events
from repro_torch.kernels import _build
from repro_torch.kernels.cam_match import ops as cam_ops
from repro_torch.kernels.fused_deliver import ops as fused_ops


def _cam_inputs(b, integer, seed, ncl=3, c=16, s=8, k=32):
    rng = np.random.default_rng(seed)
    n = ncl * c
    if integer:
        act = rng.integers(0, 20, (b, ncl, k)).astype(np.float32) * 8.0
    else:
        act = rng.random((b, ncl, k)).astype(np.float32)
    tag = rng.integers(-1, k, (n, s)).astype(np.int32)
    syn = rng.integers(0, 4, (n, s)).astype(np.int32)
    return act, tag, syn, c


def _fused_inputs(b, integer, seed, ncl=3, c=16, s=8, k=32, e=4, cap=24):
    rng = np.random.default_rng(seed)
    n = ncl * c
    src_tag = rng.integers(-1, k, (n, e)).astype(np.int32)
    src_dest = rng.integers(0, ncl, (n, e)).astype(np.int32)
    cam_tag = rng.integers(-1, k, (n, s)).astype(np.int32)
    cam_syn = rng.integers(0, 4, (n, s)).astype(np.int32)
    active = rng.random((b, n)) < 0.4
    if integer:
        spikes = active.astype(np.float32)
        ext = rng.integers(0, 5, (b, ncl, k)).astype(np.float32) * 8.0
    else:
        spikes = (active * rng.random((b, n))).astype(np.float32)
        ext = rng.random((b, ncl, k)).astype(np.float32)
    return spikes, ext, src_tag, src_dest, cam_tag, cam_syn, c, k, cap


def _t(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode), CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("b", [1, 4])
def test_plain_cam_match_matches_pallas_interpret(b, integer):
    act, tag, syn, c = _cam_inputs(b, integer, seed=b)
    ref = np.asarray(cam_match_pallas(
        jnp.asarray(act), jnp.asarray(tag), jnp.asarray(syn), c, block_c=8, interpret=True
    ))
    before = cam_ops.cam_match.launches
    out = cam_ops.cam_match(*_t(act, tag, syn), c).numpy()
    assert cam_ops.cam_match.launches == before  # CPU tensors: plain version, no launch
    assert out.shape == (b, tag.shape[0], 4)
    if integer:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_fused_deliver_matches_pallas_interpret(b, integer):
    spikes, ext, src_tag, src_dest, cam_tag, cam_syn, c, k, cap = _fused_inputs(
        b, integer, seed=b + 40
    )
    jq = j_compact_events(jnp.asarray(spikes), cap)
    ref = np.asarray(j_fused_deliver(
        jq, *(jnp.asarray(a) for a in (src_tag, src_dest, cam_tag, cam_syn)), c, k,
        external_activity=jnp.asarray(ext), block_c=8, interpret=True,
    ))
    tq = compact_events(torch.as_tensor(spikes), cap)
    before = fused_ops.fused_deliver.launches
    out = fused_ops.fused_deliver(
        tq, *_t(src_tag, src_dest, cam_tag, cam_syn), c, k,
        external_activity=torch.as_tensor(ext),
    ).numpy()
    assert fused_ops.fused_deliver.launches == before
    assert out.shape == (b, cam_tag.shape[0], 4)
    if integer:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_kernel_sources_found_and_flags_target_hopper():
    assert set(_build.sources()) == {"cam_match", "fused_deliver", "fabric_deliver", "neuron_step",
                                     "rwkv6_chunk", "mla_attention"}
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert _build.build_dir().name == "kernels" and _build.build_dir().parent.name == "build"


def test_wrappers_refuse_other_devices():
    act, tag, syn, c = _cam_inputs(1, True, seed=0)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cam_ops.cam_match(*_t(act, tag, syn, device="meta"), c)
