"""Work split of the two delivery kernels (``fused_deliver``, ``fabric_deliver``).

Both kernels give a block of :data:`THREADS` threads one (cluster c, batch
tile, neuron part) triple. The ``batch_tile`` batch elements of a tile share
every CAM word a block reads, so the CAM tables are read once per tile; the
``parts`` blocks of one (c, tile) split the cluster's neurons between them
(``fused_deliver`` makes them a thread-block cluster that shares stage 1
through distributed shared memory; ``fabric_deliver`` splits the ring's
k-range between them). Stage 2 gives each neuron :data:`LANES` lanes, so one
pass of a block's threads covers 64 neurons; a block takes
:data:`NEURONS_PER_BLOCK` neurons in two passes, and a cluster of 256 neurons
is split into two parts.

The split was chosen on the H100 at the Table-V serving shape (B = 32, six
clusters of 256 neurons, K = 1024; ``scripts/tune_delivery_split.py``): a
batch tile of 2 and two parts ran both kernels fastest of batch tiles 2, 4
and 8 and 32, 64 or 128 neurons per block, at 0%, 10% and 100% activity.

Pure arithmetic on shapes, so the plain rehearsals of the kernels' work
split (``tests/test_torch_deliver_redesign.py``) walk the same split as the
kernels do.
"""

from __future__ import annotations

import math
from collections.abc import Callable

THREADS = 256  # threads per block (cam_rows::kThreads)
WARPS = THREADS // 32
LANES = 4  # lanes per neuron in the CAM walk (cam_rows::kLanes)
NEURONS_PER_BLOCK = 2 * THREADS // LANES  # two passes of the CAM walk
MAX_PARTS = 8  # the portable thread-block cluster size
BATCH_TILE = 2  # batch elements per block, where the batch has them
TILES = (1, 2, 4, 8)  # the batch tiles the kernels are compiled for
SHARED_OPTIN_H100 = 232_448  # bytes of shared memory a block may opt in to on an H100
INT32_MAX = 2**31 - 1  # the kernels index their tensors in 32 bits


def parts_for(cluster_size: int) -> int:
    """Blocks per (cluster, batch tile), each with NEURONS_PER_BLOCK neurons."""
    return min(MAX_PARTS, max(1, math.ceil(cluster_size / NEURONS_PER_BLOCK)))


def fit_batch_tile(
    batch: int, shared_bytes: Callable[[int], int], limit: int, what: str
) -> int:
    """The largest batch tile of :data:`TILES`, at most :data:`BATCH_TILE`
    and no wider than the batch needs, whose blocks fit in ``limit`` bytes
    of shared memory; raises when even a tile of one does not fit."""
    want = min(max(1, batch), BATCH_TILE)
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
