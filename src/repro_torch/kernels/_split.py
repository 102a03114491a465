"""Work split of the three stage-2 kernels (``cam_match``, ``fused_deliver``,
``fabric_deliver``).

Each kernel gives a block of :data:`THREADS` threads one (cluster c, batch
tile, neuron part) triple. The ``batch_tile`` batch elements of a tile share
every CAM word a block reads, so the CAM tables are read once per tile; the
``parts`` blocks of one (c, tile) split the cluster's neurons between them
(``fused_deliver`` makes them a thread-block cluster that shares stage 1
through distributed shared memory; ``fabric_deliver`` splits the ring's
k-range between them; ``cam_match`` shares nothing between them). Stage 2
(``common/cam_rows.cuh``) gives each neuron :data:`LANES` lanes, so one
pass of a block's threads covers 64 neurons.

The splits were chosen on the H100 at the Table-V serving shape (B = 32,
six clusters of 256 neurons, K = 1024; ``scripts/tune_delivery_split.py``,
batch tiles 1, 2, 4 and 8 against 32, 64 or 128 neurons per block):
- the delivery kernels take a batch tile of :data:`BATCH_TILE` = 2 and
  :data:`NEURONS_PER_BLOCK` = 128 neurons per block, in two passes (two
  parts for a cluster of 256): fastest of the sweep at 0%, 10% and 100%
  activity;
- ``cam_match``, which has no stage 1 ahead of its CAM walk, takes a batch
  tile of :data:`CAM_MATCH_BATCH_TILE` = 4 and
  :data:`CAM_MATCH_NEURONS_PER_BLOCK` = 64 neurons per block, one pass
  (four parts), whose CAM reads are all issued before the rows are staged:
  fastest of the sweep on integer and on random-float activity.

Pure arithmetic on shapes, so the plain rehearsals of the kernels' work
split (``tests/test_torch_deliver_redesign.py``,
``tests/test_torch_cam_redesign.py``) walk the same split as the kernels do.
"""

from __future__ import annotations

import math
from collections.abc import Callable

THREADS = 256  # threads per block (cam_rows::kThreads)
WARPS = THREADS // 32
LANES = 4  # lanes per neuron in the CAM walk (cam_rows::kLanes)
NEURONS_PER_BLOCK = 2 * THREADS // LANES  # delivery kernels: two passes of the CAM walk
BATCH_TILE = 2  # delivery kernels: batch elements per block, where the batch has them
CAM_MATCH_NEURONS_PER_BLOCK = THREADS // LANES  # cam_match: one pass of the CAM walk
CAM_MATCH_BATCH_TILE = 4  # cam_match: batch elements per block, where the batch has them
MAX_PARTS = 8  # the portable thread-block cluster size
TILES = (1, 2, 4, 8)  # the batch tiles the kernels are compiled for
SHARED_OPTIN_H100 = 232_448  # bytes of shared memory a block may opt in to on an H100
INT32_MAX = 2**31 - 1  # the kernels index their tensors in 32 bits


def parts_for(cluster_size: int, neurons_per_block: int | None = None) -> int:
    """Blocks per (cluster, batch tile), each with ``neurons_per_block``
    neurons (default :data:`NEURONS_PER_BLOCK`), at most :data:`MAX_PARTS`."""
    per = NEURONS_PER_BLOCK if neurons_per_block is None else neurons_per_block
    return min(MAX_PARTS, max(1, math.ceil(cluster_size / per)))


def fit_batch_tile(
    batch: int, shared_bytes: Callable[[int], int], limit: int, what: str,
    preferred: int | None = None,
) -> int:
    """The largest batch tile of :data:`TILES`, at most ``preferred``
    (default :data:`BATCH_TILE`) and no wider than the batch needs, whose
    blocks fit in ``limit`` bytes of shared memory; raises when even a tile
    of one does not fit."""
    want = min(max(1, batch), BATCH_TILE if preferred is None else preferred)
    tile = next(t for t in TILES if t >= want)
    while tile > 1 and shared_bytes(tile) > limit:
        tile //= 2
    need = shared_bytes(tile)
    if need > limit:
        raise ValueError(
            f"{what}: a block needs {need} bytes of shared memory, over the {limit} "
            "a block can hold on this card; the kernel has no fallback"
        )
    return tile


def check_int32(what: str, **elements: int) -> None:
    """Raise when a tensor has more elements than the kernels' 32-bit
    indices reach."""
    for name, n in elements.items():
        if n > INT32_MAX:
            raise ValueError(
                f"{what}: {name} has {n} elements, past the {INT32_MAX} the kernel "
                "indexes in 32 bits; the kernel has no fallback"
            )
