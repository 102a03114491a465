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
terms with exponentials, taken in another order.
"""

import dataclasses

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
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.models.model import build_model
from repro_torch.serve.aer import AerServeConfig, AerSessionPool, DvsSession, build_poker_engine

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
