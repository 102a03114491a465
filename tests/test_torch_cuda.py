"""CUDA legs of the port: each kernel against its plain version on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): marked
``cuda`` and skipped without one. The file imports neither JAX nor repro, so
it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bit-exact on integer-valued inputs (sums below 2**24 are exact
in float32 in any order); allclose(rtol=1e-6, atol=1e-6) on random floats,
where the order of the shared-memory atomics and of the per-type sums may
differ from the plain version's. TF32 is off (the plain stage 2 contracts a
one-hot with a float32 matmul).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.cnn import compile_poker_cnn
from repro_torch.core.two_stage import compact_events
from repro_torch.data.pipeline import DvsStreamConfig, DvsStreamSource
from repro_torch.kernels.cam_match import ops as cam_ops
from repro_torch.kernels.fused_deliver import ops as fused_ops
from repro_torch.serve.aer import AerServeConfig, AerSessionPool, DvsSession, build_poker_engine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


def _t(*arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("b", [1, 4])
def test_cuda_cam_match_matches_plain(cuda, b, integer):
    act, tag, syn, c = _cam_inputs(b, integer, seed=b + 10)
    args = _t(act, tag, syn, device=cuda)
    before = cam_ops.cam_match.launches
    out = cam_ops.cam_match(*args, c)
    torch.cuda.synchronize()
    assert cam_ops.cam_match.launches == before + 1
    plain = cam_ops.cam_match_ref(*args, c)
    if integer:
        assert torch.equal(out, plain)
    else:
        torch.testing.assert_close(out, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_fused_deliver_matches_plain(cuda, b, integer):
    spikes, ext, src_tag, src_dest, cam_tag, cam_syn, c, k, cap = _fused_inputs(
        b, integer, seed=b + 50
    )
    tables = _t(src_tag, src_dest, cam_tag, cam_syn, device=cuda)
    q = compact_events(torch.as_tensor(spikes, device=cuda), cap)
    ext_t = torch.as_tensor(ext, device=cuda)
    before = fused_ops.fused_deliver.launches
    out = fused_ops.fused_deliver(q, *tables, c, k, external_activity=ext_t)
    out_no_ext = fused_ops.fused_deliver(q, *tables, c, k)
    torch.cuda.synchronize()
    assert fused_ops.fused_deliver.launches == before + 2
    plain = fused_ops.fused_deliver_ref(q, *tables, c, k, external_activity=ext_t)
    plain_no_ext = fused_ops.fused_deliver_ref(q, *tables, c, k)
    if integer:
        assert torch.equal(out, plain) and torch.equal(out_no_ext, plain_no_ext)
    else:
        torch.testing.assert_close(out, plain, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out_no_ext, plain_no_ext, rtol=1e-6, atol=1e-6)


def test_cuda_wrappers_raise_on_bad_arguments(cuda):
    act, tag, syn, c = _cam_inputs(2, True, seed=3)
    a, t, s = _t(act, tag, syn, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        cam_ops.cam_match(a.double(), t, s, c)
    with pytest.raises(ValueError, match="contiguous"):
        cam_ops.cam_match(a.transpose(-1, -2).contiguous().transpose(-1, -2), t, s, c)
    with pytest.raises(ValueError, match="is on"):
        cam_ops.cam_match(a, t.cpu(), s, c)
    with pytest.raises(ValueError, match="clusters"):
        cam_ops.cam_match(a, t, s, c + 1)


def test_cuda_pool_backends_agree_and_launch_once_per_step(cuda):
    """A full-width Table-V pool on the card: the kernel backends serve the
    same sessions as the reference backend, one launch per engine step."""
    cc = compile_poker_cnn()
    summaries = {}
    for backend in ("reference", "cuda", "fused"):
        pool = AerSessionPool(cc, build_poker_engine(cc.tables, backend=backend, device=cuda),
                              AerServeConfig(pool_size=4, max_steps=25))
        sessions = [
            DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=i % 4, seed=9), session_id=i),
                       label=i % 4)
            for i in range(6)
        ]
        before = (cam_ops.cam_match.launches, fused_ops.fused_deliver.launches)
        results = pool.serve(sessions)
        after = (cam_ops.cam_match.launches, fused_ops.fused_deliver.launches)
        launched = (after[0] - before[0], after[1] - before[1])
        assert launched == {"reference": (0, 0), "cuda": (pool.n_steps, 0),
                            "fused": (0, pool.n_steps)}[backend]
        summaries[backend] = [
            (r.session_id, r.prediction, r.decided, r.latency_steps, r.counts.tolist(), r.dropped)
            for r in results
        ]
    assert summaries["cuda"] == summaries["reference"] == summaries["fused"]
