"""Plain PyTorch versions for the time-wheel fabric step.

``fabric_deliver_ref`` is the plain version of the ``fabric_deliver`` CUDA
kernel, with the same signature. With ``D1 = ring.shape[-3]`` slots and the
entries' cursor-rotated flat ring targets
``flat[m] = ((cursor + delay[m]) % D1) * (nc * K) + dstk[m]``:

    ring'[..., d, c, k] = ring[..., d, c, k] + sum_m w[..., m] * [flat[m] == (d*nc + c)*K + k]
    A[..., c, k]        = ring'[..., cursor, c, k] + ext[..., c, k]
    new_ring            = ring' with slot ``cursor`` zeroed
    drive               = stage-2 CAM match of A

``fabric_deliver_ring_ref`` is the ring oracle built from the roll-path
primitives (``compact_events`` -> ``stage1_route_events_fabric`` with
``cursor`` -> stage 2): it shares its semantics with the roll path and its
carry (ring + cursor) with the fast path, so

    roll == ring_ref  locks the wheel addressing,
    ring_ref == ops   locks the static entry table and prefix-count arbitration.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.dispatch import DeliveryStats
from repro_torch.core.two_stage import (
    _accumulate_into,
    compact_events,
    stage1_route_events_fabric,
    stage2_cam_match,
)

__all__ = ["fabric_deliver_ref", "fabric_deliver_ring_ref"]


def _pop_cursor_slot(ring: torch.Tensor, cursor: torch.Tensor):
    """(the cursor slot ``[..., nc, K]``, the ring with that slot zeroed),
    without bringing the 0-dim cursor tensor to the host."""
    ax = ring.ndim - 3
    idx = cursor.reshape(1).long()
    a = torch.index_select(ring, ax, idx).squeeze(ax)
    return a, ring.index_fill(ax, idx, 0.0)


def fabric_deliver_ref(
    dstk: torch.Tensor,  # [M] int32 flat dst_cluster * K + tag, batch-shared
    delay: torch.Tensor,  # [M] int32 arrival delay in steps
    w: torch.Tensor,  # [..., M] masked event weights (0 = not delivered)
    ring: torch.Tensor,  # [..., D1, nc, K] carried ring
    cursor: torch.Tensor,  # 0-dim int32 write cursor in [0, D1)
    external_activity: torch.Tensor | None,  # [..., nc, K] or None
    cam_tag: torch.Tensor,  # [N, S] int32
    cam_syn: torch.Tensor,  # [N, S] int32
    cluster_size: int,
    k_tags: int,
    syn_onehot: torch.Tensor | None = None,  # [N, S, 4] per-table constant
) -> tuple[torch.Tensor, torch.Tensor]:  # (drive [..., N, 4], new ring)
    batch_shape = w.shape[:-1]
    d1, n_clusters = ring.shape[-3], ring.shape[-2]
    size = d1 * n_clusters * k_tags
    b = math.prod(batch_shape)
    flat = ((cursor.long() + delay.long()) % d1) * (n_clusters * k_tags) + dstk.long()
    ring = _accumulate_into(ring.reshape(b, size), flat, w.reshape(b, -1))
    ring = ring.reshape(*batch_shape, d1, n_clusters, k_tags)
    a, ring = _pop_cursor_slot(ring, cursor)
    if external_activity is not None:
        a = a + external_activity
    return stage2_cam_match(a, cam_tag, cam_syn, cluster_size, syn_onehot), ring


def fabric_deliver_ring_ref(
    spikes: torch.Tensor,  # [..., N]
    src_tag: torch.Tensor,  # [N, E]
    src_dest: torch.Tensor,  # [N, E]
    cam_tag: torch.Tensor,  # [N, S]
    cam_syn: torch.Tensor,  # [N, S]
    cluster_size: int,
    k_tags: int,
    ring: torch.Tensor,  # [..., max_delay + 1, nc, K]
    cursor: torch.Tensor,  # 0-dim int32
    *,
    cluster_tile: torch.Tensor,  # [nc]
    delay_steps: torch.Tensor,  # [nc, nc]
    n_tiles: int,
    max_delay: int,
    link_capacity: int | None,
    queue_capacity: int | None = None,
    external_activity: torch.Tensor | None = None,
    syn_onehot: torch.Tensor | None = None,
    mesh_hops: torch.Tensor | None = None,
    latency_s: torch.Tensor | None = None,
    energy_j: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, DeliveryStats]:
    """One ring-carried fabric step: ``(drive, ring, cursor, DeliveryStats)``."""
    n = spikes.shape[-1]
    n_clusters = n // cluster_size
    cursor = torch.as_tensor(cursor, dtype=torch.int32, device=spikes.device)
    capacity = n if queue_capacity is None else queue_capacity
    queue = compact_events(spikes, capacity)
    route = stage1_route_events_fabric(
        queue, src_tag, src_dest, n_clusters, k_tags, cluster_size, cluster_tile,
        delay_steps, n_tiles, max_delay, link_capacity, mesh_hops=mesh_hops,
        latency_s=latency_s, energy_j=energy_j, cursor=cursor,
    )
    a, ring = _pop_cursor_slot(ring + route.buffer, cursor)
    if external_activity is not None:
        a = a + external_activity
    drive = stage2_cam_match(a, cam_tag, cam_syn, cluster_size, syn_onehot)
    stats = DeliveryStats(
        dropped=queue.dropped,
        link_dropped=route.link_dropped,
        delivered=route.delivered,
        hops=route.hops,
        latency_s=route.latency_s,
        energy_j=route.energy_j,
    )
    return drive, ring, (cursor + 1) % (max_delay + 1), stats
