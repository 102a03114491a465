"""CUDA legs of the port: each kernel against its plain version on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): marked
``cuda`` and skipped without one. The file imports neither JAX nor repro, so
it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bit-exact on integer-valued inputs (sums below 2**24 are exact
in float32 in any order); allclose(rtol=1e-6, atol=1e-6) on random floats,
where the order of the shared-memory atomics and of the per-type sums may
differ from the plain version's. TF32 is off (the plain stage 2 contracts a
one-hot with a float32 matmul). ``rwkv6_chunk`` is held to
allclose(rtol=1e-4, atol=1e-5), the tolerance repro's own kernel test holds
its Pallas kernel to (tests/test_kernels.py): float32 sums of up to 128
terms with exponentials, taken in another order. ``mla_attention`` is held
to float32 ``attend_dense`` on the same bf16 inputs within
allclose(rtol=2**-7, atol=2**-7) (its tests give the reason).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.cnn import compile_poker_cnn
from repro_torch.core.compiler import optimize_placement
from repro_torch.core.dispatch import FabricBackend
from repro_torch.core.routing import ChipConstants, Fabric
from repro_torch.core.two_stage import compact_events, two_stage_deliver
from repro_torch.data.pipeline import DvsStreamConfig, DvsStreamSource
from repro_torch.kernels.cam_match import ops as cam_ops
from repro_torch.kernels.fabric_deliver import ops as fabric_ops
from repro_torch.kernels.fused_deliver import ops as fused_ops
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.models import attention as at
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.model import build_model
from repro_torch.serve.aer import AerServeConfig, AerSessionPool, DvsSession, build_poker_engine
from repro_torch.serve.engine import Engine, ServeConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cam_inputs(b, integer, seed, ncl=3, c=16, s=8, k=32, wild=False):
    """Activity and CAM tables; ``wild`` draws a few tags past K - 1 and
    types outside [0, 4)."""
    rng = np.random.default_rng(seed)
    n = ncl * c
    if integer:
        act = rng.integers(0, 20, (b, ncl, k)).astype(np.float32) * 8.0
    else:
        act = rng.random((b, ncl, k)).astype(np.float32)
    tag = rng.integers(-1, k + 4 if wild else k, (n, s)).astype(np.int32)
    syn = rng.integers(*((-1, 5) if wild else (0, 4)), (n, s)).astype(np.int32)
    return act, tag, syn, c


def _fused_inputs(b, integer, seed, ncl=3, c=16, s=8, k=32, e=4, cap=24, act=0.4):
    rng = np.random.default_rng(seed)
    n = ncl * c
    src_tag = rng.integers(-1, k, (n, e)).astype(np.int32)
    src_dest = rng.integers(0, ncl, (n, e)).astype(np.int32)
    cam_tag = rng.integers(-1, k + 4, (n, s)).astype(np.int32)  # a few tags past K - 1
    cam_syn = rng.integers(-1, 5, (n, s)).astype(np.int32)  # a few types outside [0, 4)
    active = rng.random((b, n)) < act
    if integer:
        spikes = active.astype(np.float32)
        ext = rng.integers(0, 5, (b, ncl, k)).astype(np.float32) * 8.0
    else:
        spikes = (active * rng.random((b, n))).astype(np.float32)
        ext = rng.random((b, ncl, k)).astype(np.float32)
    return spikes, ext, src_tag, src_dest, cam_tag, cam_syn, c, k, cap


def _t(*arrays, device):
    return [torch.as_tensor(a, device=device) for a in arrays]


# name: (batch, integer inputs, keywords of _cam_inputs)
CAM_CASES = {
    "b1-int": (1, True, {}),
    "b4-int": (4, True, {}),
    "b1-float": (1, False, {}),
    "b4-float": (4, False, {}),
    "tags and types out of range": (4, True, {"wild": True}),
    "tags and types out of range, floats": (4, False, {"wild": True}),
    "S = 5": (3, True, {"s": 5, "wild": True}),
    "S = 5, floats": (3, False, {"s": 5, "wild": True}),
    "odd cluster of 13": (5, True, {"c": 13, "wild": True}),
    "cluster of 130, three parts": (3, True, {"ncl": 2, "c": 130, "wild": True}),
    "K = 16384, shared-memory opt-in": (5, True, {"ncl": 2, "c": 64, "s": 64, "k": 16384,
                                                   "wild": True}),
    "Table-V tile at B = 33": (33, True, {"ncl": 6, "c": 256, "s": 64, "k": 1024, "wild": True}),
    "Table-V at B = 32, floats": (32, False, {"ncl": 6, "c": 256, "s": 64, "k": 1024}),
}


@pytest.mark.parametrize("case", sorted(CAM_CASES))
def test_cuda_cam_match_matches_plain(cuda, case):
    """The kernel against its plain version: the original small cases, tags
    past K - 1 and types outside [0, 4), S = 5 (single-word reads), clusters
    that the split does not divide, a K whose rows need the shared-memory
    opt-in, a ragged last batch tile, and the Table-V shape."""
    b, integer, kw = CAM_CASES[case]
    act, tag, syn, c = _cam_inputs(b, integer, seed=b + 10, **kw)
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


# name: (batch, integer inputs, keywords of _fused_inputs)
FUSED_CASES = {
    "b1-int": (1, True, {}),
    "b3-int": (3, True, {}),
    "b1-float": (1, False, {}),
    "b3-float": (3, False, {}),
    "activity 0%": (4, True, {"act": 0.0, "cap": 48}),
    "activity 100%": (4, True, {"act": 1.0, "cap": 48}),
    "activity 100% floats": (4, False, {"act": 1.0, "cap": 48}),
    "capacity below the active count": (4, True, {"act": 0.6, "cap": 10}),
    "S = 5, E = 5": (3, True, {"s": 5, "e": 5, "cap": 48}),
    "cluster of 130, two parts": (3, True, {"ncl": 2, "c": 130, "cap": 260, "act": 0.2}),
    "odd cluster of 13": (5, True, {"c": 13, "cap": 39}),
    "K = 16384, shared-memory opt-in": (5, True, {"ncl": 2, "c": 64, "s": 64, "k": 16384,
                                                   "e": 16, "cap": 128}),
    "Table-V tile at B = 33": (33, True, {"ncl": 6, "c": 256, "s": 64, "k": 1024, "e": 16,
                                          "cap": 1536, "act": 0.1}),
    "several chunks of queue slots": (4, True, {"ncl": 41, "c": 100, "cap": 4100, "act": 0.5}),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_cuda_fused_deliver_matches_plain(cuda, case):
    """The kernel against its plain version, with and without ext: the
    original small cases, 0% and 100% activity, a queue shorter than the
    active count, S = 5, clusters that the split does not divide, a K whose
    rows need the shared-memory opt-in, a ragged last batch tile, and a
    share of slots that takes several chunks."""
    b, integer, kw = FUSED_CASES[case]
    spikes, ext, src_tag, src_dest, cam_tag, cam_syn, c, k, cap = _fused_inputs(
        b, integer, seed=b + 50, **kw
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


def test_cuda_cam_match_raises_past_int32_and_on_a_split_that_does_not_fit(cuda):
    """The kernel indexes in 32 bits and has no fallback: activity past
    2**31 - 1 elements, and rows too long for a block's shared memory, are
    refused before any launch."""
    _, tag, syn, c = _cam_inputs(1, True, seed=4, ncl=2)
    t, s = _t(tag, syn, device=cuda)
    before = cam_ops.cam_match.launches
    huge = torch.empty((1, 2, 2**30 + 1), dtype=torch.float32, device=cuda)  # 8.6 GB, not written
    with pytest.raises(ValueError, match="activity has 2147483650 elements.*no fallback"):
        cam_ops.cam_match(huge, t, s, c)
    del huge
    long_rows = torch.zeros((1, 2, 60000), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="cam_match: a block needs 240004 bytes.*no fallback"):
        cam_ops.cam_match(long_rows, t, s, c)
    assert cam_ops.cam_match.launches == before


def test_cuda_cam_match_reports_no_spills_and_one_device_op(cuda):
    """At the Table-V split the kernel compiles without spills into blocks
    that fit on an SM, its library gives a block the shared bytes the
    wrapper counts, and one call is one device operation (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    split = cam_ops.work_split(32, 256, 1024)
    info = cam_ops.kernel_info(split, 1024)
    assert 0 < info["registers"] <= 255 and info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1 and info["shared_bytes"] == split.shared_bytes, info
    act, tag, syn, c = _cam_inputs(32, False, seed=6, ncl=6, c=256, s=64, k=1024)
    args = _t(act, tag, syn, device=cuda)
    cam_ops.cam_match(*args, c)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cam_ops.cam_match(*args, c)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device_ops) == 1 and "cam_match_kernel" in device_ops[0], device_ops


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


# ---------------------------------------------------------------------------
# fabric_deliver: the time-wheel ring step
# ---------------------------------------------------------------------------
def _random_fabric(dev, seed, nc, cs, k, s, m, d1):
    """Random static entry columns (with their per-cluster ranges) and CAM
    tables, tags past K - 1 and types outside [0, 4) among them."""
    rng = np.random.default_rng(seed)
    n = nc * cs
    dstk = torch.as_tensor(rng.integers(0, nc * k, m).astype(np.int32), device=dev)
    delay = torch.as_tensor(rng.integers(0, d1, m).astype(np.int32), device=dev)
    cam_tag = torch.as_tensor(rng.integers(-1, k + 4, (n, s)).astype(np.int32), device=dev)
    cam_syn = torch.as_tensor(rng.integers(-1, 5, (n, s)).astype(np.int32), device=dev)
    return dstk, delay, cam_tag, cam_syn


# name: (integer inputs, share of entries carrying weight, geometry: None = the
#        Table-V network on its default fabric at B = 32, else (nc, cluster
#        size, K, S, M, D1, B) of random entry columns)
FABRIC_CASES = {
    "serving-int": (True, 0.3, None),
    "serving-float": (False, 1.0, None),
    "serving activity 0%": (True, 0.0, None),
    "serving activity 10%": (True, 0.1, None),
    "serving activity 100%": (True, 1.0, None),
    "S = 5": (True, 0.5, (3, 16, 32, 5, 200, 3, 5)),
    "cluster of 130, two parts": (True, 0.5, (2, 130, 40, 8, 300, 2, 3)),
    "odd cluster of 13": (True, 0.5, (3, 13, 32, 8, 50, 3, 3)),
    "K = 8192, shared-memory opt-in": (True, 0.5, (2, 64, 8192, 64, 500, 2, 8)),
    "1000 entries per cluster": (True, 0.5, (2, 32, 64, 8, 2000, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(FABRIC_CASES))
def test_cuda_fabric_deliver_matches_plain_at_serving_shape(cuda, case):
    """B = 32 slots of the Table-V network on its default fabric (M = 1280
    entries, D1 = 2) at 0%, 10%, 30% and 100% of the entries carrying weight,
    and random entry columns at S = 5, at clusters the split does not
    divide, at a K whose rows need the shared-memory opt-in and with more
    entries per cluster than a block has threads; at every
    cursor phase, with and without ext, with the static per-cluster ranges
    and with the ranges the wrapper derives itself."""
    integer, share, geom = FABRIC_CASES[case]
    if geom is None:
        cc = compile_poker_cnn()
        t = cc.tables
        be = FabricBackend()
        entries = be.build_entries(t.src_tag, t.src_dest, t.cluster_size, t.k_tags, device=cuda)
        d1 = be.model_for(t.n_clusters).max_delay + 1
        assert entries.dstk.shape == (1280,) and d1 == 2
        dstk, delay = entries.dstk, entries.delay
        ranges = {"cluster_start": entries.cluster_start, "cluster_order": entries.cluster_order}
        cam_tag, cam_syn = (torch.as_tensor(a, device=cuda) for a in (t.cam_tag, t.cam_syn))
        nc, cs, k, b = t.n_clusters, t.cluster_size, t.k_tags, 32
    else:
        nc, cs, k, s, m, d1, b = geom
        dstk, delay, cam_tag, cam_syn = _random_fabric(cuda, len(case), nc, cs, k, s, m, d1)
        start, order = fabric_ops.entry_cluster_ranges(dstk, nc, k)
        ranges = {"cluster_start": start, "cluster_order": order}
    gen = torch.Generator(device=cuda).manual_seed(3)
    m = dstk.shape[0]
    carries = (torch.rand((b, m), generator=gen, device=cuda) < share).float()
    if integer:
        w = carries * torch.randint(1, 3, (b, m), generator=gen, device=cuda).float()
        ring = torch.randint(0, 4, (b, d1, nc, k), generator=gen, device=cuda).float()
        ext = torch.randint(0, 3, (b, nc, k), generator=gen, device=cuda).float() * 8.0
    else:
        w = carries * torch.rand((b, m), generator=gen, device=cuda)
        ring = torch.rand((b, d1, nc, k), generator=gen, device=cuda)
        ext = torch.rand((b, nc, k), generator=gen, device=cuda)
    for cursor in range(d1):
        cur = torch.tensor(cursor, dtype=torch.int32, device=cuda)
        for e, kw in ((ext, ranges), (None, ranges), (ext, {})):
            args = (dstk, delay, w, ring, cur, e, cam_tag, cam_syn, cs, k)
            before = fabric_ops.fabric_deliver.launches
            drive, new_ring = fabric_ops.fabric_deliver(*args, **kw)
            torch.cuda.synchronize()
            assert fabric_ops.fabric_deliver.launches == before + 1
            p_drive, p_ring = fabric_ops.fabric_deliver_ref(*args)
            assert not new_ring[:, cursor].any()
            if integer:
                assert torch.equal(drive, p_drive) and torch.equal(new_ring, p_ring)
            else:
                torch.testing.assert_close(drive, p_drive, rtol=1e-6, atol=1e-6)
                torch.testing.assert_close(new_ring, p_ring, rtol=1e-6, atol=1e-6)


def test_cuda_delivery_kernels_report_registers_spills_and_occupancy(cuda):
    """At the Table-V split both delivery kernels compile without spills
    into blocks that fit at least once on an SM, and each library gives a
    block the shared bytes its wrapper counts against the card's limit."""
    for ops, split, shape in ((fused_ops, fused_ops.work_split(32, 1536, 256, 1024), (1024,)),
                              (fabric_ops, fabric_ops.work_split(32, 256, 1024, 2), (1024, 2))):
        info = ops.kernel_info(split, *shape)
        assert 0 < info["registers"] <= 255 and info["local_bytes"] == 0, info
        assert info["blocks_per_sm"] >= 1 and info["shared_bytes"] == split.shared_bytes, info


def test_cuda_fused_deliver_puts_one_kernel_on_the_device(cuda):
    """The SRAM gather is inside the kernel: one call is one device
    operation (torch.profiler), and the launch count says so."""
    from torch.profiler import ProfilerActivity, profile

    spikes, ext, src_tag, src_dest, cam_tag, cam_syn, c, k, cap = _fused_inputs(4, True, seed=5)
    tables = _t(src_tag, src_dest, cam_tag, cam_syn, device=cuda)
    q = compact_events(torch.as_tensor(spikes, device=cuda), cap)
    ext_t = torch.as_tensor(ext, device=cuda)
    fused_ops.fused_deliver(q, *tables, c, k, external_activity=ext_t)
    torch.cuda.synchronize()
    before = fused_ops.fused_deliver.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_ops.fused_deliver(q, *tables, c, k, external_activity=ext_t)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device_ops) == 1 and "fused_deliver_kernel" in device_ops[0], device_ops
    assert fused_ops.fused_deliver.launches == before + 1


def test_cuda_fabric_ring_kernel_matches_plain_over_wrapped_steps(cuda):
    """max_delay = 2, link capacity 2, a queue shorter than N: the kernel
    and plain legs carry equal rings, drives and stats over 2*(D1)+1 steps."""
    rng = np.random.default_rng(5)
    fab = Fabric(grid_x=2, grid_y=1, cores_per_tile=2,
                 constants=ChipConstants(latency_across_chip_s=2e-3))
    nc, cs, k = fab.n_cores, 16, 64
    n = nc * cs
    src_tag = rng.integers(-1, k, (n, 4)).astype(np.int32)
    src_dest = rng.integers(0, nc, (n, 4)).astype(np.int32)
    cam_tag = torch.as_tensor(rng.integers(-1, k, (n, 8)).astype(np.int32), device=cuda)
    cam_syn = torch.as_tensor(rng.integers(0, 4, (n, 8)).astype(np.int32), device=cuda)
    legs = {kernel: FabricBackend(fabric=fab, link_capacity=2, kernel=kernel)
            for kernel in (True, False)}
    entries = legs[True].build_entries(src_tag, src_dest, cs, k, device=cuda)
    d1 = legs[True].model_for(nc).max_delay + 1
    assert d1 == 3
    carry = {kernel: be.init_ring(nc, k, batch=3, device=cuda) for kernel, be in legs.items()}
    before = fabric_ops.fabric_deliver.launches
    for step in range(2 * d1 + 1):
        spikes = torch.as_tensor((rng.random((3, n)) < 0.5).astype(np.float32), device=cuda)
        ext = torch.as_tensor((rng.integers(0, 3, (3, nc, k)) * 8.0).astype(np.float32), device=cuda)
        outs = {}
        for kernel, be in legs.items():
            drive, ring, cur, stats = be.deliver_fabric_ring(
                spikes, entries, cam_tag, cam_syn, cs, k, *carry[kernel],
                external_activity=ext, queue_capacity=n // 2)
            carry[kernel] = (ring, cur)
            outs[kernel] = (drive, ring, cur, stats)
        torch.cuda.synchronize()
        for a, b in zip(outs[True][:3], outs[False][:3]):
            assert torch.equal(a, b), f"step {step}"
        for f in ("dropped", "link_dropped", "delivered", "hops"):
            assert torch.equal(getattr(outs[True][3], f), getattr(outs[False][3], f))
    assert fabric_ops.fabric_deliver.launches == before + 2 * d1 + 1
    assert int(outs[True][3].link_dropped.sum()) > 0


def test_cuda_fabric_deliver_raises_on_bad_arguments(cuda):
    m, nc, k, cs = 8, 2, 16, 4
    dstk = torch.zeros(m, dtype=torch.int32, device=cuda)
    delay = torch.zeros(m, dtype=torch.int32, device=cuda)
    w = torch.zeros((1, m), device=cuda)
    cam = torch.zeros((nc * cs, 4), dtype=torch.int32, device=cuda)
    cur = torch.tensor(0, dtype=torch.int32, device=cuda)
    ring = torch.zeros((1, 2, nc, k), device=cuda)
    with pytest.raises(ValueError, match="cursor"):
        fabric_ops.fabric_deliver(dstk, delay, w, ring, cur.long(), None, cam, cam, cs, k)
    with pytest.raises(ValueError, match="ring"):
        fabric_ops.fabric_deliver(dstk, delay, w, ring[..., :8], cur, None, cam, cam, cs, k)
    # a ring column larger than a block's shared memory is refused, not run elsewhere
    big = torch.zeros((1, 60, nc, 1024), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fabric_ops.fabric_deliver(dstk, delay, w, big, cur, None, cam, cam, cs, 1024)


def test_cuda_fabric_pool_kernel_and_plain_legs_agree(cuda):
    """The Table-V pool over the fabric on the card, at the default link
    capacity and at 8: the kernel leg launches fabric_deliver once per
    engine step, the plain leg never, and both serve the same sessions."""
    cc = compile_poker_cnn()
    for cap in (None, 8):
        summaries = {}
        for kernel in (True, False):
            opts = {"kernel": kernel, **({} if cap is None else {"link_capacity": cap})}
            pool = AerSessionPool(cc, build_poker_engine(cc.tables, "fabric", device=cuda,
                                                         fabric_options=opts),
                                  AerServeConfig(pool_size=4, max_steps=25))
            sessions = [
                DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=i % 4, seed=9), session_id=i),
                           label=i % 4)
                for i in range(6)
            ]
            before = fabric_ops.fabric_deliver.launches
            results = pool.serve(sessions)
            launched = fabric_ops.fabric_deliver.launches - before
            assert launched == (pool.n_steps if kernel else 0)
            summaries[kernel] = [
                (r.session_id, r.prediction, r.decided, r.latency_steps, r.counts.tolist(),
                 r.dropped, r.link_dropped)
                for r in results
            ]
        assert summaries[True] == summaries[False]
        assert (sum(r[-1] for r in summaries[True]) > 0) == (cap is not None)



def test_cuda_two_stage_deliver_without_external_activity(cuda):
    """The cuda backend on the dense stage-1 scatter alone (a strided view
    of the activity slabs, no external activity added to it) launches
    cam_match and equals the reference backend; so does fused."""
    cc = compile_poker_cnn()
    t = cc.tables
    tabs = [torch.as_tensor(getattr(t, f), device=cuda)
            for f in ("src_tag", "src_dest", "cam_tag", "cam_syn")]
    rng = np.random.default_rng(4)
    spikes = torch.as_tensor((rng.random((3, t.n_neurons)) < 0.2).astype(np.float32), device=cuda)
    want = two_stage_deliver(spikes, *tabs, t.cluster_size, t.k_tags, backend="reference")
    for backend, wrapper in (("cuda", cam_ops.cam_match), ("fused", fused_ops.fused_deliver)):
        before = wrapper.launches
        got = two_stage_deliver(spikes, *tabs, t.cluster_size, t.k_tags, backend=backend)
        assert wrapper.launches == before + 1
        assert torch.equal(got, want), backend


def test_cuda_pool_profile_equals_the_cpu_pool(cuda):
    """A profiled fabric pool (per_link_stats, link capacity 2, the stale
    corners-first placement) on the card: its traffic profile, summed over
    the slots on the device, equals the same pool's on the CPU, and a
    placement optimized on it is the CPU's."""
    cc = compile_poker_cnn()
    stale = np.array([0, 8, 2, 6, 4, 5], np.int32)
    tables = dataclasses.replace(cc.tables, tile_of_cluster=stale)
    profiles = {}
    for dev in (cuda, torch.device("cpu")):
        engine = build_poker_engine(tables, "fabric", device=dev,
                                    fabric_options={"link_capacity": 2, "per_link_stats": True})
        pool = AerSessionPool(dataclasses.replace(cc, tables=tables), engine,
                              AerServeConfig(pool_size=4, max_steps=10**6))
        for i in range(3):  # one slot stays empty
            pool.admit(DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=i, seed=23),
                                                     session_id=i), label=i))
        for _ in range(6):
            pool.step()
        profiles[dev.type] = pool.profile
    got, want = profiles["cuda"], profiles["cpu"]
    for name in ("pair_delivered", "link_dropped", "last"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes(), name
    assert (got.dropped, got.steps) == (want.dropped, want.steps)
    assert got.total_link_dropped > 0
    placements = [optimize_placement(p.matrix(), Fabric(), init=stale, seed=0)[0]
                  for p in (got, want)]
    assert placements[0].tobytes() == placements[1].tobytes()


def test_cuda_autotuner_times_on_the_card(cuda):
    """backend="auto" on the card: every candidate timed (the lossless
    queue's queued figure is dense's), the engine built on the winner's
    kernel backend, and the pool launching the winner's kernel once per
    step: cam_match for dense, fused_deliver for fused."""
    cc = compile_poker_cnn()
    engine = build_poker_engine(cc.tables, "auto", device=cuda,
                                autotune={"activity": 0.1, "batch": 8, "iters": 2})
    d = engine.autotune_decision
    m = dict(d.measurements)
    assert set(m) == {"dense", "queued", "fused"} and all(us > 0 for us in m.values())
    assert m["queued"] == m["dense"] and d.winner in ("dense", "fused")
    assert d.backend == engine.backend.name == {"dense": "cuda", "fused": "fused"}[d.winner]
    pool = AerSessionPool(cc, engine, AerServeConfig(pool_size=4, max_steps=25))
    sessions = [DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=i % 4, seed=9),
                                              session_id=i), label=i % 4) for i in range(6)]
    before = {op: op.launches for op in (fused_ops.fused_deliver, cam_ops.cam_match)}
    results = pool.serve(sessions)
    kernel = fused_ops.fused_deliver if d.winner == "fused" else cam_ops.cam_match
    for op, n in before.items():
        assert op.launches - n == (pool.n_steps if op is kernel else 0)
    assert len(results) == 6 and d.token() in ("autotune:fused:act0.1:B8",
                                               "autotune:dense:act0.1:B8")


def test_cuda_injected_dense_decision_serves_through_cam_match(cuda):
    """A decision tuned on the CPU (dense, plain stage 2 there) builds a
    card engine on the cam_match kernel."""
    from repro_torch.core.dispatch import autotune_backend

    t = compile_poker_cnn().tables
    d = autotune_backend(t.src_tag, t.src_dest, t.cam_tag, t.cam_syn, t.cluster_size,
                         t.k_tags, measure={"dense": 1.0, "queued": 2.0, "fused": 3.0},
                         device="cpu")
    assert d.backend == "reference"
    engine = build_poker_engine(t, "auto", device=cuda, autotune={"decision": d})
    assert engine.backend.name == "cuda" and engine._autotune_dense
    carry = engine.init_state(batch=2)
    before = cam_ops.cam_match.launches
    engine.step(carry, torch.zeros((2, t.n_clusters, t.k_tags), device=cuda))
    assert cam_ops.cam_match.launches == before + 1


# ---------------------------------------------------------------------------
# rwkv6_chunk: one chunk of RWKV-6 WKV linear attention
# ---------------------------------------------------------------------------
def _rwkv_inputs(dev, b, t, h, p, decay, seed, chunks=1):
    """r/k/v/log_w [B, T, H, P] as repro's kernel test draws them; with
    ``chunks`` > 1 they are the last chunk sliced out of a longer sequence
    (a batch stride of chunks * T * H * P, as the chunked core passes them)."""
    rng = np.random.default_rng(seed)
    shape = (b, chunks * t, h, p)
    r, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32) * 0.5, device=dev)
               for _ in range(3))
    if decay == "deep":  # log_w at its floor, -e: cum reaches -e * T
        lw = torch.full(shape, -np.e, dtype=torch.float32, device=dev)
    elif decay == "extreme":  # -exp(U[-20, 4.5]): down to -90 per token, cum to about -300
        lw = -torch.as_tensor(np.exp(rng.uniform(-20.0, 4.5, size=shape)).astype(np.float32),
                              device=dev)
    else:
        lw = -torch.as_tensor(rng.uniform(0.01, 1.0, size=shape).astype(np.float32), device=dev)
    if decay == "padded":  # the chunked core's padded tail: r = k = v = 0, log_w = 0
        for x in (r, k, v, lw):
            x[:, -(t // 3):] = 0.0
    u = torch.as_tensor(rng.normal(size=(h, p)).astype(np.float32) * 0.1, device=dev)
    s0 = torch.as_tensor(rng.normal(size=(b, h, p, p)).astype(np.float32) * 0.2, device=dev)
    last = [x.reshape(b, chunks, t, h, p)[:, -1] for x in (r, k, v, lw)]
    return (*last, u, s0)


@pytest.mark.parametrize(
    "b,t,h,p,decay,chunks",
    [
        (2, 8, 4, 12, "uniform", 1),  # the rwkv6-3b smoke config's chunk
        (2, 5, 3, 10, "uniform", 1),  # P not a multiple of 4: 4-byte copies
        (8, 64, 40, 64, "uniform", 1),  # rwkv6-3b at B = 8
        (8, 64, 40, 64, "deep", 1),  # log_w = -e everywhere
        (8, 8, 40, 64, "uniform", 1),  # a short tail chunk
        (3, 64, 4, 64, "uniform", 3),  # a chunk sliced out of a sequence
        (8, 17, 40, 64, "uniform", 1),  # a ragged last sub-chunk of one token
        (8, 37, 40, 64, "uniform", 1),  # a ragged last sub-chunk of five tokens
        (8, 64, 40, 64, "extreme", 1),  # decays down to -90 per token
        (8, 64, 40, 64, "padded", 1),  # a tail of 21 padding tokens
    ],
)
def test_cuda_rwkv6_chunk_matches_plain(cuda, b, t, h, p, decay, chunks):
    args = _rwkv_inputs(cuda, b, t, h, p, decay, seed=b * 100 + t, chunks=chunks)
    before = rwkv_ops.rwkv6_chunk.launches
    y, s1 = rwkv_ops.rwkv6_chunk(*args)
    torch.cuda.synchronize()
    assert rwkv_ops.rwkv6_chunk.launches == before + 1
    y_ref, s1_ref = rwkv_ops.rwkv6_chunk_ref(*args)
    assert y.shape == (b, t, h, p) and s1.shape == (b, h, p, p)
    assert torch.isfinite(y).all() and torch.isfinite(s1).all()
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s1, s1_ref, rtol=1e-4, atol=1e-5)


def test_cuda_rwkv6_chunk_fits_two_blocks_per_sm(cuda):
    """At least two blocks on an SM (the kernel is sized for three); the
    library reports its registers and spill bytes beside."""
    info = rwkv_ops.kernel_info()
    assert info["blocks_per_sm"] >= 2, info
    assert 0 < info["registers"] <= 255 and info["local_bytes"] >= 0, info
    assert info["shared_bytes"] == rwkv_ops.shared_bytes(64, 64)


def test_cuda_rwkv6_chunk_raises_on_bad_arguments(cuda):
    r, k, v, lw, u, s0 = _rwkv_inputs(cuda, 2, 8, 4, 16, "uniform", seed=1)
    with pytest.raises(ValueError, match="dtype"):
        rwkv_ops.rwkv6_chunk(r.double(), k, v, lw, u, s0)
    with pytest.raises(ValueError, match="strides"):
        rwkv_ops.rwkv6_chunk(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, lw, u, s0)
    with pytest.raises(ValueError, match="is on"):
        rwkv_ops.rwkv6_chunk(r, k, v, lw, u.cpu(), s0)
    # shapes past the kernel's tiles are refused, not run elsewhere
    big = _rwkv_inputs(cuda, 1, 65, 1, 16, "uniform", seed=2)
    with pytest.raises(ValueError, match="no fallback"):
        rwkv_ops.rwkv6_chunk(*big)
    wide = _rwkv_inputs(cuda, 1, 8, 1, 128, "uniform", seed=3)
    with pytest.raises(ValueError, match="no fallback"):
        rwkv_ops.rwkv6_chunk(*wide)


def test_cuda_rwkv6_chunk_refuses_inputs_that_require_grad(cuda):
    """The kernel has no backward: with gradients on, an input that requires
    them raises instead of coming back cut from the graph; a model built with
    the kernel cannot train, one without it trains on the plain core."""
    args = _rwkv_inputs(cuda, 2, 8, 4, 16, "uniform", seed=4)
    before = rwkv_ops.rwkv6_chunk.launches
    for i in range(len(args)):
        grad_args = [a.detach().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="no backward"):
            rwkv_ops.rwkv6_chunk(*grad_args)
    with torch.no_grad():
        rwkv_ops.rwkv6_chunk(*[a.detach().requires_grad_() for a in args])
    assert rwkv_ops.rwkv6_chunk.launches == before + 1
    cfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True), param_dtype="float32",
                              compute_dtype="float32")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    with pytest.raises(RuntimeError, match="no backward"):
        build_model(cfg, device=cuda, requires_grad=True).loss(batch)
    loss, _ = build_model(cfg, device=cuda, rwkv_kernel=False, requires_grad=True).loss(batch)
    loss.backward()
    assert rwkv_ops.rwkv6_chunk.launches == before + 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v3-671b", "rwkv6-3b", "zamba2-2.7b"])
def test_cuda_train_step_matches_the_cpu(cuda, arch):
    """One float32 train step of a smoke config on the card and on the CPU,
    from the same weights and batch: loss rel 1e-5, gradient norm rel 1e-4,
    no kernel launched."""
    from repro_torch.train.loop import init_train_state, make_train_step
    from repro_torch.train.optimizer import OptConfig

    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="float32",
                              compute_dtype="float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cpu = build_model(cfg, device="cpu", rwkv_kernel=False, seed=2)
    gpu = build_model(cfg, device=cuda, rwkv_kernel=False, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    before = rwkv_ops.rwkv6_chunk.launches
    metrics = [make_train_step(m, OptConfig())(init_train_state(m, OptConfig()), batch)[1]
               for m in (cpu, gpu)]
    assert rwkv_ops.rwkv6_chunk.launches == before
    np.testing.assert_allclose(float(metrics[1]["loss"]), float(metrics[0]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics[1]["grad_norm"]), float(metrics[0]["grad_norm"]),
                               rtol=1e-4)


def test_cuda_rwkv6_3b_two_layers_fp32_chunked_prefill_equals_sequential(cuda):
    """rwkv6-3b at full width, 2 layers, float32: prefill on the kernel (a
    61-token prompt: one chunk of 64, padded) against the sequential oracle.
    Logits allclose(rtol=1e-3, atol=1e-4) and states allclose(rtol=1e-3,
    atol=1e-3): float32 sums over 61 tokens and 2560 channels taken in two
    orders, in states that reach about 100."""
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_periods=2, param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, device=cuda, seed=3)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 61)), device=cuda)
    with torch.inference_mode():
        before = rwkv_ops.rwkv6_chunk.launches
        logits, caches = model.prefill(toks, model.init_caches(2, 64))
        torch.cuda.synchronize()
        assert rwkv_ops.rwkv6_chunk.launches == before + 2
        seq_logits, seq_caches = model.prefill(toks, model.init_caches(2, 64), sequential=True)
    assert rwkv_ops.rwkv6_chunk.launches == before + 2
    assert torch.isfinite(logits).all()
    torch.testing.assert_close(logits, seq_logits, rtol=1e-3, atol=1e-4)
    for got, want in zip(caches["stack"], seq_caches["stack"]):
        torch.testing.assert_close(got["wkv"], want["wkv"], rtol=1e-3, atol=1e-3)


def test_cuda_kernel_info_leaves_larger_launches_runnable(cuda):
    """``kernel_info`` at a small shared-memory footprint, then a launch of
    the same kernel instance at a larger one under 48 KB, for each stage-2
    kernel: the launch runs and equals the plain version bit for bit.
    ``kernel_info`` used to set the instance's dynamic shared-memory cap to
    its own footprint, and such a launch (the Table-V pool's
    ``fused_deliver`` after two models made its queue 3072 slots long)
    failed with "invalid argument"."""
    t = compile_poker_cnn().tables
    src_tag, src_dest, cam_tag, cam_syn = (torch.as_tensor(getattr(t, f), device=cuda)
                                           for f in ("src_tag", "src_dest", "cam_tag", "cam_syn"))
    cs, k, n, nc = t.cluster_size, t.k_tags, t.n_neurons, t.n_clusters
    gen = torch.Generator(device=cuda).manual_seed(0)
    spikes = (torch.rand((32, n), generator=gen, device=cuda) < 0.1).float()
    ext = torch.randint(0, 3, (32, nc, k), generator=gen, device=cuda).float() * 8.0

    small, big = fused_ops.work_split(32, 64, cs, k), fused_ops.work_split(32, n, cs, k)
    assert (small.batch_tile, small.parts) == (big.batch_tile, big.parts)
    assert small.shared_bytes < big.shared_bytes < 48 * 1024
    fused_ops.kernel_info(small, k)
    q = compact_events(spikes, n)
    tabs = (src_tag, src_dest, cam_tag, cam_syn)
    assert torch.equal(fused_ops.fused_deliver(q, *tabs, cs, k, external_activity=ext),
                       fused_ops.fused_deliver_ref(q, *tabs, cs, k, external_activity=ext))

    cam_ops.kernel_info(cam_ops.work_split(32, cs, 64), 64)
    assert torch.equal(cam_ops.cam_match(ext, cam_tag, cam_syn, cs),
                       cam_ops.cam_match_ref(ext, cam_tag, cam_syn, cs))

    be = FabricBackend()
    entries = be.build_entries(t.src_tag, t.src_dest, cs, k, device=cuda)
    d1 = be.model_for(nc).max_delay + 1
    fabric_ops.kernel_info(fabric_ops.work_split(32, cs, 64, d1), 64, d1)
    m = entries.dstk.shape[0]
    w = (torch.rand((32, m), generator=gen, device=cuda) < 0.1).float()
    ring = torch.randint(0, 3, (32, d1, nc, k), generator=gen, device=cuda).float()
    cur = torch.zeros((), dtype=torch.int32, device=cuda)
    args = (entries.dstk, entries.delay, w, ring, cur, ext, cam_tag, cam_syn, cs, k)
    got = fabric_ops.fabric_deliver(*args, cluster_start=entries.cluster_start,
                                    cluster_order=entries.cluster_order)
    want = fabric_ops.fabric_deliver_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# multi-device: the sharded step over cells that share the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["reference", "fabric"])
def test_cuda_sharded_fleet_equals_the_cpu_fleet_and_launches_once_per_cell(cuda, backend):
    """A fleet of two 1x2-mesh shards on the card (``devices=[cuda:0] * 2``)
    on the slab-retiled Table-V tables serves every session as the same
    fleet on the CPU, launching cam_match once per mesh cell per fleet step
    and no other kernel; ``devices=None`` refuses the 2-cell mesh on one card."""
    from repro_torch.serve.sharded import ShardConfig, ShardedSessionPool, retile_for_slabs

    cc = retile_for_slabs(compile_poker_cnn(), 2)
    shards = ShardConfig(n_shards=2, queue_depth=4, backend=backend, cluster_devices=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        fleet = ShardedSessionPool(cc, AerServeConfig(pool_size=2, max_steps=25), shards,
                                   devices=[dev] * 2)
        sessions = [
            DvsSession(i, DvsStreamSource(DvsStreamConfig(symbol=i % 4, seed=9), session_id=i),
                       label=i % 4)
            for i in range(5)
        ]
        before = [fn.launches for fn in (cam_ops.cam_match, fused_ops.fused_deliver,
                                          fabric_ops.fabric_deliver)]
        results = fleet.serve(sessions)
        after = [fn.launches for fn in (cam_ops.cam_match, fused_ops.fused_deliver,
                                         fabric_ops.fabric_deliver)]
        launched = [a - b for a, b in zip(after, before)]
        assert launched == ([4 * fleet.n_steps, 0, 0] if dev.type == "cuda" else [0, 0, 0])
        out[dev.type] = sorted((r.session_id, r.prediction, r.latency_steps, r.counts.tolist(),
                                r.link_dropped) for r in results)
    assert out["cuda"] == out["cpu"]
    if torch.cuda.device_count() == 1:
        with pytest.raises(ValueError, match="fleet needs at least 2 devices per shard, have 1"):
            ShardedSessionPool(cc, AerServeConfig(pool_size=2), shards)


def _enqueue_ms_while_the_card_spins(fn, spin_ms: float = 200.0):
    """Host ms of ``fn()`` while a spin kernel holds the card for about
    ``spin_ms``: far below it unless ``fn`` waits for the device."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_ms * 2e6))  # cycles at ~2 GHz
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms, out


@pytest.mark.parametrize("backend", ["cuda", "fused", "fabric", "sharded_queued", "sharded_fabric"])
def test_cuda_engine_step_never_waits_on_the_device(cuda, backend):
    """A serving step launched from numpy input returns while the card is
    still busy: the input goes up through pinned memory and the neuron
    step's constants are built once, so no step makes the host wait (a
    fleet step then has every shard's work queued before its one wait)."""
    from repro_torch.serve.sharded import ShardConfig, ShardedSessionPool, retile_for_slabs

    cc = retile_for_slabs(compile_poker_cnn(), 2)
    cfg = AerServeConfig(pool_size=4, max_steps=25)
    if backend.startswith("sharded"):
        fleet = ShardedSessionPool(cc, cfg, ShardConfig(
            n_shards=2, backend="fabric" if backend.endswith("fabric") else "reference",
            cluster_devices=2), devices=[cuda] * 2)
        pools = fleet.pools
    else:
        pools = [AerSessionPool(cc, build_poker_engine(cc.tables, backend=backend, device=cuda),
                                cfg)]
    for j, pool in enumerate(pools):
        for i in range(3):
            sid = 10 * j + i
            pool.admit(DvsSession(sid, DvsStreamSource(DvsStreamConfig(symbol=i, seed=9),
                                                       session_id=sid), label=i))
        for _ in range(2):
            pool.step()  # first-use allocations, pinned blocks included
    ms, outs = _enqueue_ms_while_the_card_spins(lambda: [p.begin_step() for p in pools])
    for pool, out in zip(pools, outs):
        pool.finish_step(out)
    assert ms < 100.0, f"{backend}: launching the step took {ms:.1f} ms of a 200 ms spin"


# ---------------------------------------------------------------------------
# attention and MoE serving: plain PyTorch on the card, held to the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,softcap", [(None, None), (64, None), (None, 30.0)])
def test_cuda_attend_chunked_matches_dense_and_the_cpu(cuda, window, softcap):
    """float32, GQA 8/2, S = 1100 (two blocks of 1024, the second padded):
    chunked against dense on the card allclose(rtol=1e-5, atol=2e-5), and the
    card's dense against the CPU's."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 1100, 8, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 1100, 2, 32)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(1100)[None], (2, 1100)).copy()
    kw = dict(window=window, scale=32**-0.5, softcap=softcap)
    on = [torch.as_tensor(a, device=cuda) for a in (q, k, v, pos, pos)]
    dense = at.attend_dense(*on, **kw)
    torch.testing.assert_close(at.attend_chunked(*on, **kw), dense, rtol=1e-5, atol=2e-5)
    cpu = at.attend_dense(*(torch.as_tensor(a) for a in (q, k, v, pos, pos)), **kw)
    torch.testing.assert_close(dense.cpu(), cpu, rtol=1e-5, atol=2e-5)


def test_cuda_moe_local_matches_the_cpu_and_the_reference(cuda):
    """deepseek-moe-16b's routing (64 experts, top-6, capacity 1.25) at a
    narrow width: float32 on the card equals the CPU (routing, loads and kept
    slots exactly, outputs allclose(rtol=1e-5, atol=1e-5)); in bfloat16 at
    capacity T * k, ``moe_local`` within 2**-5 of ``moe_reference``'s
    largest output."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), d_model=64, moe_d_ff=32)
    layer = moe.MoE(cfg, torch.float32, "cpu", torch.Generator().manual_seed(0))
    layer.requires_grad_(False)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(256, 64)).astype(np.float32))
    with torch.inference_mode():
        y_cpu, aux_cpu = moe.moe_local(layer, x, cfg)
        y, aux = moe.moe_local(layer.to(cuda), x.to(cuda), cfg)
        assert torch.equal(aux["load"].cpu(), aux_cpu["load"])
        assert int(aux["load"].max()) > moe.expert_capacity(cfg, 256)  # some expert drops
        torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
        layer_bf16 = moe.MoE(cfg, torch.bfloat16, cuda, torch.Generator(cuda).manual_seed(0))
        assert layer_bf16.router.dtype == torch.float32
        xb = x.to(cuda, torch.bfloat16)
        yb, _ = moe.moe_local(layer_bf16, xb, cfg, capacity=256 * cfg.top_k)
        ref, _ = moe.moe_reference(layer_bf16, xb, cfg)
    err = float((yb.float() - ref.float()).abs().max() / ref.float().abs().max())
    assert err <= 2.0**-5, err


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "gemma2-27b", "gemma3-1b", "glm4-9b",
                                  "internvl2-76b", "whisper-base", "yi-34b", "deepseek-v3-671b",
                                  "zamba2-2.7b"])
def test_cuda_smoke_arch_serves_as_on_the_cpu(cuda, arch):
    """Each attention / MoE / MLA / Mamba2 smoke config (float32) with the
    CPU model's weights on the card: prefill logits allclose(rtol=1e-4,
    atol=1e-4) and greedy tokens through ``Engine.generate`` (with the
    frontends' inputs) equal the CPU's; no kernel of the port is launched."""
    cfg = get_config(arch, smoke=True)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    model = build_model(cfg, device=cuda, seed=5)
    model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 11))
    extras = None
    if cfg.frontend == "audio_stub":
        extras = {"frames": rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "vision_stub":
        extras = {"prefix_embeddings": rng.normal(
            size=(2, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)}
    before = {fn: fn.launches for fn in (cam_ops.cam_match, fused_ops.fused_deliver,
                                         fabric_ops.fabric_deliver, rwkv_ops.rwkv6_chunk,
                                         mla_ops.mla_attention)}
    with torch.inference_mode():
        got, _ = model.prefill(torch.as_tensor(toks, device=cuda), model.init_caches(2, 24), extras)
        want, _ = cpu_model.prefill(torch.as_tensor(toks), cpu_model.init_caches(2, 24), extras)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    out = Engine(model, ServeConfig(max_len=24)).generate(toks, 8, extras)
    assert out.is_cuda
    assert torch.equal(out.cpu(), Engine(cpu_model, ServeConfig(max_len=24)).generate(toks, 8, extras))
    assert all(fn.launches == n for fn, n in before.items())


def test_cuda_ssd_chunked_core_matches_sequential_and_the_cpu(cuda):
    """The Mamba2 SSD cores in float32, B = 2, S = 300 over chunks of 128 (a
    padded tail), H = 8, P = 16, N = 16, from a carried-in state: the
    chunked core equals the sequential one on the card, and the card's
    chunked core the CPU's (outputs and final states allclose(rtol=1e-5,
    atol=2e-5))."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 300, 8, 16, 16
    args = [rng.normal(size=(b, s, h, p)), rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)),
            rng.uniform(0.01, 0.5, size=(b, s, h)), -rng.uniform(0.5, 2.0, size=h),
            rng.normal(size=h), rng.normal(size=(b, h, p, n))]
    cpu = [torch.as_tensor(a.astype(np.float32)) for a in args]
    on = [a.to(cuda) for a in cpu]
    with torch.inference_mode():
        y_chk, h_chk = ssm.mamba2_chunked_core(*on[:6], 128, on[6])
        y_seq, h_seq = ssm.mamba2_sequential_core(*on)
        y_cpu, h_cpu = ssm.mamba2_chunked_core(*cpu[:6], 128, cpu[6])
    assert y_chk.is_cuda and y_chk.shape == (b, s, h, p)
    for got, want in ((y_chk, y_seq), (h_chk, h_seq), (y_chk.cpu(), y_cpu), (h_chk.cpu(), h_cpu)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the MLA prefill's causal attention kernel
# ---------------------------------------------------------------------------
# (B, S, H, positions, scale factor): positions from 0, from an offset (from
# -5 the first five queries see no valid key and read 0), or a permutation
# of 0..S-1 (the mask follows the positions' values, not the rows); the
# factor multiplies DeepSeek-V2-Lite's scale, 8 for sharply peaked rows
MLA_CASES = {
    "one token": (1, 1, 16, 0, 1.0),
    "S = 63": (2, 63, 16, 0, 1.0),
    "S = 128 from 5, 128 heads": (1, 128, 128, 5, 1.0),
    "S = 1000 from -5": (2, 1000, 16, -5, 1.0),
    "S = 1000, 128 heads": (1, 1000, 128, 0, 1.0),
    "S = 1000 peaked": (1, 1000, 16, 0, 8.0),
    "S = 300 permuted": (2, 300, 16, "perm", 1.0),
    "the cell's shape": (4, 4096, 16, 0, 1.0),
}


def _mla_scale(factor: float = 1.0) -> float:
    cfg = get_config("deepseek-v2-lite")
    m = layers.yarn_mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim)
    return factor * (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5 * m * m


def _mla_inputs(dev, b, s, h, start, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn((b, s, h, mla_ops.QK_DIM), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((b, s, h, mla_ops.V_DIM), generator=gen, device=dev).to(torch.bfloat16)
    if start == "perm":
        pos = torch.stack([torch.randperm(s, generator=gen, device=dev) for _ in range(b)])
    else:
        pos = (torch.arange(s, device=dev) + start).expand(b, s)  # the model's stride-0 rows
    return q, k, v, pos


@pytest.mark.parametrize("case", sorted(MLA_CASES))
def test_cuda_mla_attention_matches_float32_dense(cuda, case):
    """The kernel against float32 ``attend_dense`` on the same bf16 q, k, v
    (scores, softmax and the product with v all float32 there):
    allclose(rtol=2**-7, atol=2**-7). The output is rounded to bf16 (a
    relative error up to 2**-8 of values up to about 5), and the kernel
    rounds the probabilities to bf16 before the product with v (each term
    within 2**-8 of its own size, about 2**-8 * mean |v| in all), as
    ``attend_dense`` itself does in bf16; the sums run in another order.
    A row with no valid key is exactly 0."""
    b, s, h, start, factor = MLA_CASES[case]
    q, k, v, pos = _mla_inputs(cuda, b, s, h, start)
    scale = _mla_scale(factor)
    launches = mla_ops.mla_attention.launches
    got = mla_ops.mla_attention(q, k, v, pos, scale)
    torch.cuda.synchronize()
    assert mla_ops.mla_attention.launches == launches + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, mla_ops.V_DIM)
    want = at.attend_dense(q.float(), k.float(), v.float(), pos, pos, causal=True, scale=scale)
    torch.testing.assert_close(got.float(), want, rtol=2**-7, atol=2**-7)
    empty = pos < 0
    if empty.any():
        assert torch.equal(got[empty], torch.zeros_like(got[empty]))


def test_cuda_mla_attention_raises_on_what_it_does_not_take(cuda):
    q, k, v, pos = _mla_inputs(cuda, 1, 70, 2, 0)
    scale = _mla_scale()
    with pytest.raises(ValueError, match="dtype"):
        mla_ops.mla_attention(q.float(), k, v, pos, scale)
    with pytest.raises(ValueError, match="shape"):
        mla_ops.mla_attention(q[..., :128].contiguous(), k, v, pos, scale)
    with pytest.raises(ValueError, match="shape"):
        mla_ops.mla_attention(q, k, k, pos, scale)
    with pytest.raises(ValueError, match="contiguous"):
        mla_ops.mla_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, pos, scale)
    with pytest.raises(ValueError, match="positions"):
        mla_ops.mla_attention(q, k, v, pos.int(), scale)
    with pytest.raises(ValueError, match="CUDA"):
        mla_ops.mla_attention(q.cpu(), k.cpu(), v.cpu(), pos.cpu(), scale)
    with pytest.raises(RuntimeError, match="backward"):
        mla_ops.mla_attention(q.requires_grad_(), k, v, pos, scale)


def test_cuda_mla_prefill_launches_the_kernel_once_per_layer(cuda, monkeypatch):
    """DeepSeek-V2-Lite cut to 2 layers at full width (192 / 128) in bf16:
    a prefill launches the kernel once per layer, and its last logits lie
    within 0.08 (rms, relative) of the same prefill on ``attention_core``:
    the benchmark cell's limit on bf16 logits against its float32 reference
    (bf16 prefills read 0.027-0.048 there). The two bf16 paths differ by the
    kernel's bf16 probabilities and the order of its sums, carried through
    a router whose top-6 choices flip (measured 0.030). The smoke
    configuration's head sizes (16 + 8 / 16) take ``attention_core`` on the
    card, in bf16 too."""
    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), n_periods=1)
    model = build_model(cfg, device=cuda, seed=0)
    toks = torch.randint(0, cfg.vocab, (2, 300), generator=torch.Generator().manual_seed(1))
    toks = toks.to(cuda)
    with torch.inference_mode():
        launches = mla_ops.mla_attention.launches
        got, _ = model.prefill(toks, model.init_caches(2, 300))
        assert mla_ops.mla_attention.launches == launches + cfg.n_layers == launches + 2
        monkeypatch.setattr(mla, "takes_kernel", lambda *args: False)
        want, _ = model.prefill(toks, model.init_caches(2, 300))
        monkeypatch.undo()
        assert mla_ops.mla_attention.launches == launches + 2
    got, want = got.float(), want.float()
    gap = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert gap < 0.08, gap
    del model
    smoke = get_config("deepseek-v2-lite", smoke=True)
    small = build_model(smoke, device=cuda, seed=0)
    with torch.inference_mode():
        launches = mla_ops.mla_attention.launches
        logits, _ = small.prefill(toks[:, :40] % smoke.vocab, small.init_caches(2, 40))
    assert torch.isfinite(logits.float()).all()
    assert mla_ops.mla_attention.launches == launches


def test_cuda_mla_attention_fits_one_block_per_sm(cuda):
    """One block of three warpgroups an SM: at most 65,536 / 384 registers
    a thread (168 in steps of 8), its ring within the 227 KB a block may
    hold. Its spills are logged by chip_smoke and kept in PERF.md."""
    info = mla_ops.kernel_info()
    assert info["blocks_per_sm"] == 1, info
    assert info["registers"] <= 168, info
    assert info["shared_bytes"] <= 227 * 1024, info
