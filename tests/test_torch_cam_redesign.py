"""The work of the redesigned ``cam_match`` kernel, rehearsed on the CPU, and
its library yardstick.

``cam_match`` (``csrc/cam_match.cu``) runs only on the card. Its work split
is rehearsed here in plain PyTorch, block by block, with the split the
wrapper hands it (``kernels/_split.py``, ``ops.work_split``) and others
drawn by hypothesis: each (cluster, neuron part, batch tile) block stages
its tile's activity rows with a zero cell K, and walks its part of the
neurons with four lanes per neuron and the transpose reduction of
``common/cam_rows.cuh``. It is held against repro's ``cam_match_pallas`` in
interpret mode on the same inputs, made from a numpy seed.

The library yardstick, one ``torch.bmm`` of the activity with the
per-cluster count matrix of ``ref.cam_counts``, is held against repro's
``stage2_cam_match``.

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

from repro.core.two_stage import stage2_cam_match as j_stage2_cam_match
from repro.kernels.cam_match.cam_match import cam_match_pallas
from repro_torch.kernels import _build, _split
from repro_torch.kernels.cam_match import ops as cam_ops
from repro_torch.kernels.cam_match.ref import cam_counts, cam_match_ref
from tests._hypothesis_compat import given, settings, st
from tests.test_torch_deliver_redesign import _block_c, _lane_words


# name: (n_clusters, cluster_size, K, S, batch, integer inputs, CAM tags up to,
#        synapse types from..to, share of empty CAM rows)
CASES = {
    "S = 5": (3, 13, 32, 5, 3, True, None, (0, 4), 0.0),
    "S = 64": (2, 16, 48, 64, 5, True, None, (0, 4), 0.0),
    "cluster of 13": (3, 13, 32, 8, 5, True, None, (0, 4), 0.0),
    "cluster of 130": (2, 130, 24, 8, 3, True, None, (0, 4), 0.0),
    "empty rows": (3, 13, 32, 8, 3, True, None, (0, 4), 0.5),
    "tags past K": (3, 13, 32, 8, 3, True, 40, (0, 4), 0.0),
    "types outside [0, 4)": (3, 13, 32, 8, 3, True, None, (-2, 6), 0.0),
    "random floats": (3, 13, 32, 8, 4, False, None, (0, 4), 0.0),
    "random floats, S = 64": (2, 16, 48, 64, 5, False, None, (0, 4), 0.0),
}


def _inputs(case, seed):
    nc, cs, k, s, b, integer, tag_hi, syn_range, empty = CASES[case]
    rng = np.random.default_rng(seed)
    n = nc * cs
    cam_tag = rng.integers(-1, tag_hi or k, (n, s)).astype(np.int32)
    cam_tag[rng.random(n) < empty] = -1  # whole rows of empty words
    cam_syn = rng.integers(*syn_range, (n, s)).astype(np.int32)
    if integer:
        act = (rng.integers(0, 17, (b, nc, k)) * 8.0).astype(np.float32)
    else:
        act = rng.random((b, nc, k)).astype(np.float32)
    return act, cam_tag, cam_syn, cs, integer, tag_hi


def _match_block(rows, cam_tag, cam_syn, n_lo, n_hi):
    """Stage 2 of one block (common/cam_rows.cuh) for neurons [n_lo, n_hi):
    ``rows [TB, K + 1]`` with cell K = 0. Each lane adds its words in the
    order it reads them (``_lane_words``) into four per-type sums (a 0/1 mask per type), then the transpose
    reduction adds the lanes as (0 + 2) + (1 + 3). Returns ``[TB, nn, 4]``."""
    tb, k1 = rows.shape
    k_tags = k1 - 1
    tags = cam_tag[n_lo:n_hi].long()
    syns = cam_syn[n_lo:n_hi]
    idx = torch.where(tags < 0, k_tags, tags.clamp(max=k_tags - 1))  # [nn, S]
    lanes = torch.zeros((_split.LANES, tb, n_hi - n_lo, 4), dtype=torch.float32)
    for q in range(_split.LANES):
        for w in _lane_words(q, cam_tag.shape[1]).tolist():
            v = rows[:, idx[:, w]]  # [TB, nn]: one shared load per tag for all rows
            for t in range(4):
                lanes[q, ..., t] += v * (syns[:, w] == t).to(torch.float32)
    return (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])


def _rehearse_cam(act, cam_tag, cam_syn, cluster_size, split):
    """Every block of the kernel in turn, on the grid (n_clusters x parts,
    ceil(B / TB)). Returns the drive and how often each drive cell was
    written."""
    b, nc, k = act.shape
    n = nc * cluster_size
    tile, parts = split.batch_tile, split.parts
    span = math.ceil(cluster_size / parts)
    drive = torch.full((b, n, 4), float("nan"))
    written = torch.zeros((b, n), dtype=torch.int64)
    for bx in range(nc * parts):
        part, c = bx % parts, bx // parts
        first = c * cluster_size
        n_lo = first + min(cluster_size, part * span)
        n_hi = first + min(cluster_size, (part + 1) * span)
        for by in range(math.ceil(b / tile)):
            b0 = by * tile
            rows_in = min(tile, b - b0)  # a ragged last tile stages zero rows
            rows = torch.zeros((tile, k + 1), dtype=torch.float32)
            rows[:rows_in, :k] = act[b0:b0 + rows_in, c]
            d = _match_block(rows, cam_tag, cam_syn, n_lo, n_hi)
            drive[b0:b0 + rows_in, n_lo:n_hi] = d[:rows_in]
            written[b0:b0 + rows_in, n_lo:n_hi] += 1
    return drive, written


def _assert_matches(got, want, integer, msg=""):
    if integer:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("case", sorted(CASES))
@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), tile=st.sampled_from(_split.TILES),
       parts=st.integers(1, 3))
def test_cam_work_split_rehearsal_matches_repro_pallas(case, seed, tile, parts):
    """The kernel's blocks, at the wrapper's split and at a drawn one (batch
    tile, parts), against repro's Pallas kernel in interpret mode."""
    act, cam_tag, cam_syn, cs, integer, tag_hi = _inputs(case, seed)
    b, _, k = act.shape
    jargs = [jnp.asarray(a) for a in (act, cam_tag, cam_syn)]
    if tag_hi is None:
        want = np.asarray(cam_match_pallas(*jargs, cs, block_c=_block_c(cs), interpret=True))
    else:  # tags past K - 1: repro's reference clamps them, as the port does
        want = np.asarray(j_stage2_cam_match(*jargs, cs))
    targs = [torch.as_tensor(a) for a in (act, cam_tag, cam_syn)]
    drawn = cam_ops.WorkSplit(tile, parts, cam_ops.shared_bytes(tile, k))
    for split in (cam_ops.work_split(b, cs, k), drawn):
        drive, written = _rehearse_cam(*targs, cs, split)
        assert (written == 1).all(), "every drive cell is written once"
        _assert_matches(drive.numpy(), want, integer, str(split))
    # the wrapper on CPU tensors: the plain version, no launch
    before = cam_ops.cam_match.launches
    _assert_matches(cam_ops.cam_match(*targs, cs).numpy(), want, integer)
    assert cam_ops.cam_match.launches == before


# name: (n_clusters, cluster_size, K, S, batch, CAM tags up to, types from..to)
LIBRARY_CASES = {
    "in range": (3, 8, 16, 8, 4, None, (0, 4)),
    "tags past K": (3, 8, 16, 8, 4, 24, (0, 4)),
    "types outside [0, 4)": (2, 5, 12, 6, 3, None, (-2, 6)),
    "all of them, S = 5": (4, 7, 20, 5, 2, 30, (-1, 5)),
}


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", sorted(LIBRARY_CASES))
def test_library_bmm_equals_repro_stage2_cam_match(case, integer):
    """``torch.bmm(A.transpose(0, 1), cam_counts(...))`` is repro's stage 2:
    exactly on integer-valued activity (counts <= S, every sum an integer
    below 2**24), allclose(1e-5) on random floats; empty words, tags past
    K - 1 and types outside [0, 4) included."""
    nc, cs, k, s, b, tag_hi, syn_range = LIBRARY_CASES[case]
    rng = np.random.default_rng(nc * 100 + k)
    n = nc * cs
    cam_tag = rng.integers(-1, tag_hi or k, (n, s)).astype(np.int32)
    cam_syn = rng.integers(*syn_range, (n, s)).astype(np.int32)
    if integer:
        act = (rng.integers(0, 17, (b, nc, k)) * 8.0).astype(np.float32)
    else:
        act = rng.random((b, nc, k)).astype(np.float32)
    want = np.asarray(j_stage2_cam_match(jnp.asarray(act), jnp.asarray(cam_tag),
                                         jnp.asarray(cam_syn), cs))
    counts = cam_counts(torch.as_tensor(cam_tag), torch.as_tensor(cam_syn), nc, k)
    assert counts.shape == (nc, k, cs * 4) and counts.dtype == torch.float32
    counted = (cam_tag >= 0) & (cam_syn >= 0) & (cam_syn < 4)
    assert int(counts.sum()) == int(counted.sum())
    got = torch.bmm(torch.as_tensor(act).transpose(0, 1), counts)  # [nc, B, cs * 4]
    _assert_matches(got.transpose(0, 1).reshape(b, n, 4).numpy(), want, integer)
    _assert_matches(cam_match_ref(*(torch.as_tensor(a) for a in (act, cam_tag, cam_syn)),
                                  cs).numpy(), want, integer)


def test_cam_counts_refuses_unequal_clusters():
    with pytest.raises(ValueError, match="clusters of equal size"):
        cam_counts(torch.zeros((10, 4), dtype=torch.int32), torch.zeros((10, 4), dtype=torch.int32),
                   3, 8)


def test_cam_work_split_at_the_serving_shape_and_its_limits():
    """Table-V at B = 32: batch tiles of 4 and four parts of 64 neurons (one
    pass of the CAM walk each), its own split and not the delivery
    kernels'; a batch of one takes a tile of one; the tile shrinks to fit a
    large K in shared memory; a block that cannot fit is refused, by name."""
    s = cam_ops.work_split(32, 256, 1024)
    assert (s.batch_tile, s.parts) == (4, 4)
    assert s.shared_bytes == cam_ops.shared_bytes(4, 1024) == 4 * 4 * 1025
    assert _split.parts_for(256) == 2 and _split.BATCH_TILE == 2  # the delivery kernels' split
    assert cam_ops.work_split(1, 13, 32).batch_tile == 1
    assert cam_ops.work_split(3, 13, 32).batch_tile == 4  # a ragged tile of four
    assert cam_ops.work_split(33, 130, 24).parts == 3
    big = cam_ops.work_split(8, 64, 30000)
    assert big.batch_tile == 1 and big.shared_bytes <= _split.SHARED_OPTIN_H100 < 4 * 2 * 30001
    with pytest.raises(ValueError, match="cam_match: a block needs 240004 bytes.*no fallback"):
        cam_ops.work_split(8, 64, 60000)
    for b in (1, 2, 3, 5, 32, 65535):
        for cs, k in ((1, 1), (13, 32), (256, 1024), (5000, 64)):
            split = cam_ops.work_split(b, cs, k)
            assert split.batch_tile in _split.TILES and 1 <= split.parts <= _split.MAX_PARTS


def test_cam_match_source_takes_the_shared_stage_2(monkeypatch, tmp_path):
    """cam_match.cu includes common/cam_rows.cuh and walks its CAM words
    with load_cam / match_neurons; the header is hashed into the library's
    name, so an edit to it rebuilds cam_match too."""
    src = _build.sources()["cam_match"].read_text()
    assert '#include "../../common/cam_rows.cuh"' in src
    assert "cam_rows::load_cam(" in src and "cam_rows::match_neurons<" in src
    assert "__global__ void __launch_bounds__(kThreads) cam_match_kernel(" in src
    for export in ("cam_match_launch", "cam_match_kernel_info", "cam_match_max_shared_bytes"):
        assert f'extern "C" int {export}(' in src
    before = _build.library_path("cam_match")
    edited = tmp_path / "cam_rows.cuh"
    edited.write_text(_build.headers()[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "headers", lambda: [edited])
    assert _build.library_path("cam_match") != before
