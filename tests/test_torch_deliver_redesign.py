"""The work of the redesigned delivery kernels, rehearsed on the CPU.

``fused_deliver`` and ``fabric_deliver`` (``csrc/*.cu``) run only on the
card. What they do around their arithmetic is rehearsed here in plain numpy,
block by block, with the work split the wrappers hand them
(``kernels/_split.py``, ``ops.work_split``) and others drawn by hypothesis,
and held against repro on the same inputs made from a numpy seed:

  * ``fused_deliver``: each (cluster, batch tile) cluster of ``parts``
    blocks walks the tile's queue slots once, in shares and chunks; only
    live slots read an SRAM row; every entry addressed to the cluster is
    added to the rows of every block of the cluster; each block matches its
    part of the neurons, four lanes per neuron. Against repro's
    ``fused_deliver_pallas`` in interpret mode.
  * ``fabric_deliver``: each block walks only its cluster's entries (the
    static ranges of ``FabricEntries``), skips zero weights, keeps the whole
    arrival row and its k-slice of the other slots, and writes its slice of
    the new ring. Against repro's ``fabric_deliver_ring_pallas`` in
    interpret mode and the port's ``fabric_deliver_ref``.

Tolerances: bit-exact on integer-valued inputs (every sum is an integer
below 2**24, exact in float32 in any order); allclose(rtol=1e-5, atol=1e-5)
on random floats, as tests/test_dispatch.py holds the Pallas kernels to
their reference. A CAM tag past K - 1 reads cell K - 1 in repro's reference
(``stage2_cam_match`` clamps it) and in the port, but matches no cell of
repro's Pallas compare plane, which spans [0, K); such cases are held
against repro's reference.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import routing as jrouting
from repro.core.two_stage import compact_events as j_compact_events
from repro.kernels.fabric_deliver import ops as jfab_ops
from repro.kernels.fabric_deliver.fabric_deliver import fabric_deliver_ring_pallas
from repro.kernels.fused_deliver import fused_deliver as j_fused_deliver
from repro.kernels.fused_deliver.ref import fused_deliver_ref as j_fused_deliver_ref
from repro_torch.core import routing as trouting
from repro_torch.core.two_stage import compact_events
from repro_torch.kernels import _build, _split
from repro_torch.kernels.fabric_deliver import ops as fab_ops
from repro_torch.kernels.fused_deliver import ops as fused_ops
from tests._hypothesis_compat import given, settings, st

DT = 1e-3


def _block_c(cluster_size: int) -> int:
    """The largest neuron tile of at most 16 that divides the cluster (the
    Pallas kernels take whole tiles)."""
    return max(d for d in range(1, min(16, cluster_size) + 1) if cluster_size % d == 0)


def _neuron_range(part: int, parts: int, cluster_size: int) -> tuple[int, int]:
    """The neurons ``[lo, hi)`` of a cluster that block ``part`` matches."""
    span = math.ceil(cluster_size / parts)
    return min(cluster_size, part * span), min(cluster_size, (part + 1) * span)


def _lane_words(q: int, s_words: int) -> np.ndarray:
    """The CAM words lane q of a neuron walks: vectors q, q + 4, ... of four
    words when S % 4 == 0, else words q, q + 4, ..."""
    if s_words % 4 == 0:
        return np.asarray([4 * v + j for v in range(q, s_words // 4, _split.LANES)
                           for j in range(4)], dtype=np.int64)
    return np.arange(q, s_words, _split.LANES)


def _match_rows(rows, cam_tag, cam_syn, n_lo, n_hi, k_tags):
    """Stage 2 of one block (common/cam_rows.cuh) for neurons [n_lo, n_hi):
    ``rows [TB, K + 1]`` with cell K = 0; each lane's per-type sums, then the
    transpose reduction over the four lanes. Returns ``[TB, n_hi - n_lo, 4]``."""
    tb = rows.shape[0]
    lanes = np.zeros((_split.LANES, tb, n_hi - n_lo, 4), np.float32)
    for q in range(_split.LANES):
        words = _lane_words(q, cam_tag.shape[1])
        if words.size == 0:
            continue
        tags = cam_tag[n_lo:n_hi][:, words]
        syns = cam_syn[n_lo:n_hi][:, words]
        idx = np.where(tags < 0, k_tags, np.minimum(tags, k_tags - 1))
        vals = rows[:, idx]  # [TB, nn, W]
        for t in range(4):
            lanes[q, ..., t] = (vals * (syns == t)).sum(-1, dtype=np.float32)
    return (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])


# ---------------------------------------------------------------------------
# fused_deliver: queue slots -> rows -> drive
# ---------------------------------------------------------------------------
def _rehearse_fused(src, weight, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k_tags,
                    ext, split):
    """Every block of the fused kernel in turn. Returns the drive, how often
    each slot was walked, how many SRAM rows were read, and how often each
    drive cell was written."""
    b, q = src.shape
    n, e = src_tag.shape
    nc = n // cluster_size
    tile, parts, spw = split.batch_tile, split.parts, split.slots_per_warp
    drive = np.full((b, n, 4), np.nan, np.float32)
    written = np.zeros((b, n), np.int64)
    walked = np.zeros((b, q), np.int64)
    sram_rows = 0
    for c in range(nc):
        for t0 in range(0, b, tile):
            rows = np.zeros((parts, tile, k_tags + 1), np.float32)  # one per block
            for tb in range(min(tile, b - t0)):
                if ext is not None:
                    rows[:, tb, :k_tags] = ext[t0 + tb, c]
            total = tile * q
            share = math.ceil(total / parts)
            for part in range(parts):
                lo = min(total, part * share)
                hi = min(total, lo + share)
                for base in range(lo, hi, _split.WARPS * spw):
                    # groups of 32 slots dealt to the warps in turn
                    slots = [base + (u * _split.WARPS + warp) * 32 + lane
                             for warp in range(_split.WARPS) for u in range(spw // 32)
                             for lane in range(32)]
                    for i in (i for i in slots if i < hi):
                        tb, slot = divmod(i, q)
                        if t0 + tb >= b:
                            continue
                        walked[t0 + tb, slot] += 1
                        s = int(src[t0 + tb, slot])
                        if s < 0:
                            continue  # an empty slot reads no SRAM row
                        s = min(s, n - 1)
                        sram_rows += 1
                        for j in range(e):
                            tag = int(src_tag[s, j])
                            if tag < 0:
                                continue
                            local = int(src_dest[s, j]) * k_tags + tag - c * k_tags
                            if 0 <= local < k_tags:  # into every block of the cluster
                                rows[:, tb, local] += weight[t0 + tb, slot]
            for part in range(parts):
                n_lo, n_hi = _neuron_range(part, parts, cluster_size)
                first = c * cluster_size
                d = _match_rows(rows[part], cam_tag, cam_syn, first + n_lo, first + n_hi, k_tags)
                for tb in range(min(tile, b - t0)):
                    drive[t0 + tb, first + n_lo:first + n_hi] = d[tb]
                    written[t0 + tb, first + n_lo:first + n_hi] += 1
    return drive, walked, sram_rows, written


# name: (n_clusters, cluster_size, K, S, E, batch, activity, capacity share,
#        integer inputs, CAM tags up to, synapse types from..to, entry-less)
FUSED_CASES = {
    "activity 0%": (3, 13, 32, 8, 4, 3, 0.0, 1.0, True, None, (0, 4), False),
    "activity 10%": (3, 13, 32, 8, 4, 4, 0.1, 1.0, True, None, (0, 4), False),
    "activity 100%": (2, 16, 32, 8, 4, 3, 1.0, 1.0, True, None, (0, 4), False),
    "capacity below the active count": (3, 13, 32, 8, 4, 4, 0.6, 0.25, True, None, (0, 4), False),
    "S = 5, E = 5": (3, 13, 32, 5, 5, 3, 0.4, 1.0, True, None, (0, 4), False),
    "S = 64, E = 16": (2, 16, 48, 64, 16, 3, 0.3, 1.0, True, None, (0, 4), False),
    "cluster of 130, two parts": (2, 130, 24, 8, 4, 3, 0.2, 1.0, True, None, (0, 4), False),
    "tags past K": (3, 13, 32, 8, 4, 3, 0.4, 1.0, True, 40, (0, 4), False),
    "types outside [0, 4)": (3, 13, 32, 8, 4, 3, 0.4, 1.0, True, None, (-2, 6), False),
    "entry-less table": (3, 13, 32, 8, 4, 3, 0.5, 1.0, True, None, (0, 4), True),
    "random floats": (3, 13, 32, 8, 4, 4, 0.3, 1.0, False, None, (0, 4), False),
}


def _fused_inputs(case, seed):
    nc, cs, k, s, e, b, act, cap_share, integer, tag_hi, syn_range, empty = FUSED_CASES[case]
    rng = np.random.default_rng(seed)
    n = nc * cs
    src_tag = rng.integers(-1, k, (n, e)).astype(np.int32)
    if empty:
        src_tag[:] = -1
    src_dest = rng.integers(0, nc, (n, e)).astype(np.int32)
    cam_tag = rng.integers(-1, tag_hi or k, (n, s)).astype(np.int32)
    cam_syn = rng.integers(*syn_range, (n, s)).astype(np.int32)
    active = rng.random((b, n)) < act
    if integer:
        spikes = active.astype(np.float32)
        ext = (rng.integers(0, 4, (b, nc, k)) * 8.0).astype(np.float32)
    else:
        spikes = (active * rng.random((b, n))).astype(np.float32)
        ext = rng.random((b, nc, k)).astype(np.float32)
    capacity = max(1, int(n * cap_share))
    return spikes, ext, src_tag, src_dest, cam_tag, cam_syn, cs, k, capacity, integer, tag_hi


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), tile=st.sampled_from(_split.TILES),
       parts=st.integers(1, 3), chunk_warps=st.integers(1, 3))
def test_fused_work_split_rehearsal_matches_repro_pallas(case, seed, tile, parts, chunk_warps):
    """The fused kernel's blocks, at the wrapper's split and at a drawn one
    (batch tile, parts, and slots per warp small enough to force several
    chunks), against repro's Pallas kernel in interpret mode."""
    (spikes, ext, src_tag, src_dest, cam_tag, cam_syn, cs, k, capacity, integer,
     tag_hi) = _fused_inputs(case, seed)
    b, n = spikes.shape
    jq = j_compact_events(jnp.asarray(spikes), capacity)
    jtabs = [jnp.asarray(a) for a in (src_tag, src_dest, cam_tag, cam_syn)]
    if tag_hi is None:
        want = np.asarray(j_fused_deliver(jq, *jtabs, cs, k, external_activity=jnp.asarray(ext),
                                          block_c=_block_c(cs), interpret=True))
    else:  # tags past K - 1: repro's reference clamps them, as the port does
        want = np.asarray(j_fused_deliver_ref(jq, *jtabs, cs, k,
                                              external_activity=jnp.asarray(ext)))
    tq = compact_events(torch.as_tensor(spikes), capacity)
    src, weight = tq.src.numpy(), tq.weight.numpy()
    np.testing.assert_array_equal(src, np.asarray(jq.src))
    q = src.shape[1]
    wrapper = fused_ops.work_split(b, q, cs, k)
    drawn = fused_ops.WorkSplit(tile, parts, 32 * chunk_warps, 0)
    for split in (wrapper, drawn):
        drive, walked, sram_rows, written = _rehearse_fused(
            src, weight, src_tag, src_dest, cam_tag, cam_syn, cs, k, ext, split)
        nc = n // cs
        assert (walked == nc).all(), "every (cluster, tile) walks each queue slot once"
        assert sram_rows == nc * int((src >= 0).sum()), "only live slots read SRAM rows"
        assert (written == 1).all(), "every drive cell is written once"
        if integer:
            np.testing.assert_array_equal(drive, want, err_msg=str(split))
        else:
            np.testing.assert_allclose(drive, want, rtol=1e-5, atol=1e-5, err_msg=str(split))
    # the port's plain version, which the wrapper takes on the CPU, agrees too
    plain = fused_ops.fused_deliver(tq, *(torch.as_tensor(a) for a in
                                          (src_tag, src_dest, cam_tag, cam_syn)), cs, k,
                                    external_activity=torch.as_tensor(ext)).numpy()
    if integer:
        np.testing.assert_array_equal(plain, want)
    else:
        np.testing.assert_allclose(plain, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fabric_deliver: static per-cluster ranges, ring slice, arrival rows
# ---------------------------------------------------------------------------
def _model(mod, gx, gy, cpt, latency_mult, nc):
    fab = mod.Fabric(grid_x=gx, grid_y=gy, cores_per_tile=cpt,
                     constants=mod.ChipConstants(latency_across_chip_s=latency_mult * DT))
    return mod.build_delivery_model(fab, nc, DT)


def _rehearse_fabric(dstk, delay, w, ring, cur, ext, cam_tag, cam_syn, cluster_size, k_tags,
                     start, order, split):
    """Every block of the fabric kernel in turn. Returns the drive, the new
    ring, how often each entry was walked, and how often each drive and
    ring cell was written."""
    b, d1, nc, _ = ring.shape
    n = nc * cluster_size
    tile, parts = split.batch_tile, split.parts
    slice_ = math.ceil(k_tags / parts)
    drive = np.full((b, n, 4), np.nan, np.float32)
    new_ring = np.full(ring.shape, np.nan, np.float32)
    drive_written = np.zeros((b, n), np.int64)
    ring_written = np.zeros(ring.shape, np.int64)
    walked = np.zeros(dstk.shape[0], np.int64)
    for c in range(nc):
        own = order[start[c]:start[c + 1]]  # this cluster's entries, nothing else
        for t0 in range(0, b, tile):
            rows_in = min(tile, b - t0)
            for part in range(parts):
                k_lo = min(k_tags, part * slice_)
                nk = min(k_tags, k_lo + slice_) - k_lo
                arrival = np.zeros((tile, k_tags + 1), np.float32)
                col = np.zeros((tile, d1, nk), np.float32)
                arrival[:rows_in, :k_tags] = ring[t0:t0 + rows_in, cur, c]
                for d in range(d1):
                    if d != cur:
                        col[:rows_in, d] = ring[t0:t0 + rows_in, d, c, k_lo:k_lo + nk]
                for idx in own:
                    walked[idx] += 1
                    local = int(dstk[idx]) - c * k_tags
                    slot = (cur + int(delay[idx])) % d1
                    for tb in range(rows_in):
                        wv = w[t0 + tb, idx]
                        if wv == 0 or not 0 <= local < k_tags:
                            continue  # a zero weight adds nothing
                        if slot == cur:
                            arrival[tb, local] += wv
                        elif k_lo <= local < k_lo + nk:
                            col[tb, slot, local - k_lo] += wv
                if ext is not None:
                    arrival[:rows_in, :k_tags] += ext[t0:t0 + rows_in, c]
                for tb in range(rows_in):
                    for d in range(d1):
                        new_ring[t0 + tb, d, c, k_lo:k_lo + nk] = 0.0 if d == cur else col[tb, d]
                        ring_written[t0 + tb, d, c, k_lo:k_lo + nk] += 1
                n_lo, n_hi = _neuron_range(part, parts, cluster_size)
                first = c * cluster_size
                dr = _match_rows(arrival, cam_tag, cam_syn, first + n_lo, first + n_hi, k_tags)
                drive[t0:t0 + rows_in, first + n_lo:first + n_hi] = dr[:rows_in]
                drive_written[t0:t0 + rows_in, first + n_lo:first + n_hi] += 1
    return drive, new_ring, walked, drive_written, ring_written


# name: (grid_x, grid_y, cores_per_tile, latency x dt, n_clusters, cluster_size, K,
#        S, batch, weight activity, integer inputs, CAM tags up to, types, entry-less)
FABRIC_CASES = {
    "activity 0%": (2, 1, 2, 2.0, 4, 8, 16, 8, 3, 0.0, True, None, (0, 4), False),
    "activity 10%": (2, 1, 2, 2.0, 4, 8, 16, 8, 4, 0.1, True, None, (0, 4), False),
    "activity 100%": (3, 1, 2, 1.0, 6, 5, 16, 8, 3, 1.0, True, None, (0, 4), False),
    "S = 5": (2, 1, 2, 2.0, 4, 8, 16, 5, 3, 0.5, True, None, (0, 4), False),
    "S = 64": (2, 1, 2, 2.0, 4, 8, 24, 64, 2, 0.5, True, None, (0, 4), False),
    "cluster of 130, two parts": (2, 1, 1, 2.0, 2, 130, 24, 8, 2, 0.5, True, None, (0, 4), False),
    "tags past K": (2, 1, 2, 2.0, 4, 8, 16, 8, 3, 0.5, True, 24, (0, 4), False),
    "types outside [0, 4)": (2, 1, 2, 2.0, 4, 8, 16, 8, 3, 0.5, True, None, (-2, 6), False),
    "entry-less table": (2, 1, 2, 2.0, 4, 8, 16, 8, 3, 0.5, True, None, (0, 4), True),
    "random floats": (2, 1, 2, 2.0, 4, 8, 16, 8, 4, 0.5, False, None, (0, 4), False),
}


def _fabric_inputs(case, seed):
    gx, gy, cpt, lat, nc, cs, k, s, b, act, integer, tag_hi, syn_range, empty = FABRIC_CASES[case]
    rng = np.random.default_rng(seed)
    n = nc * cs
    src_tag = rng.integers(-1, k, (n, 4)).astype(np.int32)
    if empty:
        src_tag[:] = -1
    src_dest = rng.integers(0, nc, (n, 4)).astype(np.int32)
    cam_tag = rng.integers(-1, tag_hi or k, (n, s)).astype(np.int32)
    cam_syn = rng.integers(*syn_range, (n, s)).astype(np.int32)
    jm, tm = _model(jrouting, gx, gy, cpt, lat, nc), _model(trouting, gx, gy, cpt, lat, nc)
    entries = fab_ops.build_fabric_entries(src_tag, src_dest, cs, k, tm, device="cpu")
    d1 = tm.max_delay + 1
    m = entries.dstk.shape[0]
    live = rng.random((b, m)) < act
    if integer:
        w = (live * rng.integers(1, 3, (b, m))).astype(np.float32)
        ring = rng.integers(0, 3, (b, d1, nc, k)).astype(np.float32)
        ext = (rng.integers(0, 3, (b, nc, k)) * 8.0).astype(np.float32)
    else:
        w = (live * rng.random((b, m))).astype(np.float32)
        ring = rng.random((b, d1, nc, k)).astype(np.float32)
        ext = rng.random((b, nc, k)).astype(np.float32)
    if empty:
        w[:] = 0.0  # the pad row of an entry-less table carries nothing
    return src_tag, src_dest, cam_tag, cam_syn, cs, k, entries, jm, w, ring, ext, integer, tag_hi


@pytest.mark.parametrize("case", sorted(FABRIC_CASES))
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), tile=st.sampled_from(_split.TILES),
       parts=st.integers(1, 3))
def test_fabric_work_split_rehearsal_matches_repro_pallas(case, seed, tile, parts):
    """The fabric kernel's blocks, at the wrapper's split and at a drawn
    one, at every cursor of the ring, against repro's Pallas kernel in
    interpret mode and the port's plain version."""
    (src_tag, src_dest, cam_tag, cam_syn, cs, k, entries, jm, w, ring, ext, integer,
     tag_hi) = _fabric_inputs(case, seed)
    b, d1, nc, _ = ring.shape
    dstk, delay = entries.dstk.numpy(), entries.delay.numpy()
    start, order = entries.cluster_start.numpy(), entries.cluster_order.numpy()
    splits = (fab_ops.work_split(b, cs, k, d1), fab_ops.WorkSplit(tile, parts, 0))
    for cur in range(d1):
        cursor = torch.tensor(cur, dtype=torch.int32)
        p_drive, p_ring = fab_ops.fabric_deliver_ref(
            entries.dstk, entries.delay, torch.as_tensor(w), torch.as_tensor(ring), cursor,
            torch.as_tensor(ext), torch.as_tensor(cam_tag), torch.as_tensor(cam_syn), cs, k)
        p_drive, p_ring = p_drive.numpy(), p_ring.numpy()
        if tag_hi is None:
            flat = ((cur + delay.astype(np.int64)) % d1) * (nc * k) + dstk
            j_drive, j_ring = fabric_deliver_ring_pallas(
                jnp.asarray(flat.astype(np.int32)), jnp.asarray(w), jnp.asarray(ring),
                jnp.int32(cur), jnp.asarray(ext), jnp.asarray(cam_tag), jnp.asarray(cam_syn),
                cs, k, jm.max_delay, block_c=_block_c(cs), interpret=True)
            want_drive, want_ring = np.asarray(j_drive), np.asarray(j_ring)
        else:  # tags past K - 1 clamp in the plain version, as in repro's reference
            want_drive, want_ring = p_drive, p_ring
        for split in splits:
            drive, new_ring, walked, drive_written, ring_written = _rehearse_fabric(
                dstk, delay, w, ring, cur, ext, cam_tag, cam_syn, cs, k, start, order, split)
            blocks_per_cluster = math.ceil(b / split.batch_tile) * split.parts
            assert (walked == blocks_per_cluster).all(), "only a cluster's blocks walk its entries"
            assert (drive_written == 1).all() and (ring_written == 1).all()
            assert not new_ring[:, cur].any()
            for got, want in ((drive, want_drive), (new_ring, want_ring),
                              (drive, p_drive), (new_ring, p_ring)):
                if integer:
                    np.testing.assert_array_equal(got, want, err_msg=str(split))
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=str(split))


# ---------------------------------------------------------------------------
# the static layout: each destination cluster's own entries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "geom, nc, cs, k, e, empty",
    [
        ((3, 3, 4, 0.0154), 6, 5, 8, 4, False),  # the default fabric, Table-V-like delays
        ((2, 1, 2, 2.0), 4, 8, 16, 4, False),
        ((3, 2, 2, 2.0), 11, 3, 8, 6, False),
        ((2, 1, 2, 2.0), 4, 8, 16, 4, True),  # entry-less: the one pad row
    ],
)
def test_entry_cluster_ranges_cover_every_entry_once(geom, nc, cs, k, e, empty):
    """``cluster_start`` / ``cluster_order`` list every row of the static
    table exactly once, in the run of its destination cluster dstk // K, in
    arbitration order within the run; computed from repro's own table they
    are the same, bit for bit."""
    rng = np.random.default_rng(nc * 7 + k)
    n = nc * cs
    src_tag = rng.integers(-1, k, (n, e)).astype(np.int32)
    if empty:
        src_tag[:] = -1
    src_dest = rng.integers(0, nc, (n, e)).astype(np.int32)
    tm = _model(trouting, *geom, nc)
    jm = _model(jrouting, *geom, nc)
    t = fab_ops.build_fabric_entries(src_tag, src_dest, cs, k, tm, device="cpu")
    j = jfab_ops.build_fabric_entries(src_tag, src_dest, cs, k, jm)
    start, order = t.cluster_start.numpy(), t.cluster_order.numpy()
    dstk = t.dstk.numpy()
    m = dstk.shape[0]
    assert start.dtype == order.dtype == np.int32
    assert start.shape == (nc + 1,) and order.shape == (m,)
    assert start[0] == 0 and start[-1] == m and (np.diff(start) >= 0).all()
    np.testing.assert_array_equal(np.sort(order), np.arange(m))
    for c in range(nc):
        run = order[start[c]:start[c + 1]]
        assert (dstk[run] // k == c).all()
        assert (np.diff(run) > 0).all()  # arbitration order kept
    # the same ranges from repro's static table, computed with numpy
    j_dstk = np.asarray(j.dstk)
    np.testing.assert_array_equal(j_dstk, dstk)
    key = j_dstk.astype(np.int64) // k
    np.testing.assert_array_equal(order, np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(
        start, np.concatenate([[0], np.cumsum(np.bincount(key, minlength=nc))]))
    if empty:
        assert m == 1 and not bool(t.valid[0])


def test_entry_cluster_ranges_leave_out_other_clusters():
    """An entry whose cluster lies outside [0, nc) is in no cluster's run."""
    dstk = torch.tensor([5, 70, 1, 33, -4, 40], dtype=torch.int32)  # K = 16, nc = 3
    start, order = fab_ops.entry_cluster_ranges(dstk, 3, 16)
    assert start.tolist() == [0, 2, 2, 4]
    assert order[:4].tolist() == [0, 2, 3, 5]
    assert sorted(order[4:].tolist()) == [1, 4]


# ---------------------------------------------------------------------------
# the work split and the build
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cluster_size", [1, 5, 13, 64, 127, 128, 130, 256, 1000, 5000])
def test_neuron_parts_cover_each_cluster_once(cluster_size):
    parts = _split.parts_for(cluster_size)
    assert 1 <= parts <= _split.MAX_PARTS
    covered = np.zeros(cluster_size, np.int64)
    for p in range(parts):
        lo, hi = _neuron_range(p, parts, cluster_size)
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_work_split_at_the_serving_shape_and_its_limits():
    """Table-V at B = 32: batch tiles of 2, two parts; the tile shrinks to fit
    a large K in shared memory, and a block that cannot fit is refused."""
    s = fused_ops.work_split(32, 1536, 256, 1024)
    assert (s.batch_tile, s.parts, s.slots_per_warp) == (2, 2, 192)
    assert s.shared_bytes == fused_ops.shared_bytes(2, 1024, 192) == 4 * (2 * 1025 + 2 * 8 * 192)
    f = fab_ops.work_split(32, 256, 1024, 2)
    assert (f.batch_tile, f.parts) == (2, 2)
    assert f.shared_bytes == fab_ops.shared_bytes(2, 1024, 2, 2) == 4 * 2 * (1025 + 2 * 512)
    assert fused_ops.work_split(1, 10, 13, 32).batch_tile == 1
    big = fused_ops.work_split(8, 64, 64, 30000)
    assert big.batch_tile == 1 and big.shared_bytes <= _split.SHARED_OPTIN_H100 < 4 * 2 * 30001
    with pytest.raises(ValueError, match="no fallback"):
        fused_ops.work_split(8, 64, 64, 60000)
    with pytest.raises(ValueError, match="shared memory"):
        fab_ops.work_split(1, 4, 1024, 60)  # a ring column of 60 x 1024 floats


def test_library_names_hash_the_shared_header(monkeypatch, tmp_path):
    """Both delivery kernels include common/cam_rows.cuh: the header is part
    of each library's hash, so an edit to it rebuilds them."""
    assert [h.name for h in _build.headers()] == ["cam_rows.cuh"]
    for name in ("fused_deliver", "fabric_deliver"):
        assert '#include "../../common/cam_rows.cuh"' in _build.sources()[name].read_text()
    before = _build.library_path("fused_deliver")
    edited = tmp_path / "cam_rows.cuh"
    edited.write_text(_build.headers()[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "headers", lambda: [edited])
    assert _build.library_path("fused_deliver") != before


def test_fused_split_dataclass_is_the_kernels_contract():
    """The launcher takes batch tiles of 1, 2, 4 or 8, at most 8 parts and a
    multiple of 32 slots per warp up to 256: the wrapper's split stays in it."""
    for b in (1, 2, 3, 5, 32, 65535):
        for q, cs, k in ((1, 1, 1), (24, 16, 32), (1536, 256, 1024), (4096, 4096, 64)):
            s = fused_ops.work_split(b, q, cs, k)
            assert s.batch_tile in _split.TILES and 1 <= s.parts <= 8
            assert s.slots_per_warp % 32 == 0 and 32 <= s.slots_per_warp <= 256


def test_int32_guard_names_the_tensor():
    _split.check_int32("k", ring=_split.INT32_MAX)
    with pytest.raises(ValueError, match="ring has 2147483648 elements.*no fallback"):
        _split.check_int32("fabric_deliver", w=10, ring=_split.INT32_MAX + 1)
