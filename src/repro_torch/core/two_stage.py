"""Two-stage tag dispatch in PyTorch (the paper's §II scheme, executable).

Counterpart of ``repro.core.two_stage``: the queued path and fabric mode.

Stage 1 (point-to-point, "R1-SRAM -> fabric"): every active source emits its
stage-1 entries ``(tag, dest_cluster)``; all events are accumulated into a
tag-activity matrix ``A[..., n_clusters, K]`` with one int64 ``index_add_``.

Stage 2 (broadcast + CAM match, "R1 -> core"): every CAM word that matches
contributes its cluster's activity to the synapse-type accumulator of its
neuron, giving drive ``[..., N, N_SYN_TYPES]``. The functions here are the
plain PyTorch versions; the hand-written CUDA kernels live under
``repro_torch.kernels`` (``cam_match``, ``fused_deliver``).

Both stages are batch-native: ``spikes`` may carry any leading batch shape
``[..., N]`` over routing tables shared by the batch.

:func:`compact_events` models the core's output FIFO: active sources are
compacted in arbiter scan order into a fixed-capacity ``(src, weight)``
queue with an overflow counter, and :func:`stage1_route_events` scatters
only the queued events' SRAM entries.

:func:`stage1_route_events_fabric` is stage 1 through the R1/R2/R3 fabric
(DESIGN.md §11): entries binned by tile pair, per-link FIFO arbitration with
:func:`dispatch_slots`, and a delay-indexed buffer (the roll path, and the
ring oracle with ``cursor=``).

:func:`two_stage_deliver` is the one-call delivery (spikes -> drive) through
any dispatch backend.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "N_SYN_TYPES",
    "EventQueue",
    "FabricRouteResult",
    "dispatch_slots",
    "stage1_route_events_fabric",
    "compact_events",
    "gather_event_entries",
    "stage1_route",
    "stage1_route_events",
    "precompute_syn_onehot",
    "stage2_cam_match",
    "two_stage_deliver",
]

N_SYN_TYPES = 4  # fast-exc, slow-exc, subtractive-inh, shunting-inh


@dataclasses.dataclass(frozen=True)
class EventQueue:
    """Fixed-capacity compaction of one step's active sources.

    ``src[..., Q]`` holds source neuron ids in arbiter scan order (lowest id
    first), ``-1`` marks empty slots past the last event. ``weight`` is the
    event weight (``spikes[src]``, 0 in empty slots); ``dropped`` counts
    events that did not fit.
    """

    src: torch.Tensor  # [..., Q] int32, -1 = empty
    weight: torch.Tensor  # [..., Q]
    dropped: torch.Tensor  # [...] int32


def compact_events(spikes: torch.Tensor, capacity: int) -> EventQueue:
    """Compact active spikes into a fixed-capacity AER queue.

    Sources are scanned in id order and the first ``capacity`` active ones
    win the bus; the rest are dropped and counted. Queue slot ``s`` holds
    the (s+1)-th active source: a left binary search of ``s+1`` in the
    running active count.
    """
    n = spikes.shape[-1]
    q = min(int(capacity), n)
    if q <= 0:
        raise ValueError(f"queue capacity must be positive, got {capacity}")
    batch_shape = spikes.shape[:-1]
    active = spikes != 0
    pos = torch.cumsum(active, dim=-1, dtype=torch.int32).reshape(-1, n)
    targets = torch.arange(1, q + 1, dtype=torch.int32, device=spikes.device)
    src = torch.searchsorted(
        pos, targets.expand(pos.shape[0], q).contiguous(), right=False, out_int32=True
    ).reshape(*batch_shape, q)
    kept = src < n  # slot beyond the last active source -> empty
    src = torch.where(kept, src, -1)
    weight = torch.where(
        kept,
        torch.take_along_dim(spikes, src.clamp(min=0).long(), dim=-1),
        torch.zeros((), dtype=spikes.dtype, device=spikes.device),
    )
    n_active = active.sum(dim=-1, dtype=torch.int32)
    dropped = n_active - kept.sum(dim=-1, dtype=torch.int32)
    return EventQueue(src=src, weight=weight, dropped=dropped)


def gather_event_entries(
    queue: EventQueue,
    src_tag: torch.Tensor,  # [N, E] int32, -1 = empty
    src_dest: torch.Tensor,  # [N, E] int32 cluster ids
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch the queued events' SRAM rows: ``(ev_tag, ev_dest) [..., Q, E]``.

    Empty queue slots yield ``ev_tag = -1`` rows.
    """
    safe = queue.src.clamp(0, src_tag.shape[0] - 1).long()
    ev_tag = src_tag[safe]
    ev_dest = src_dest[safe]
    ev_tag = torch.where(queue.src[..., None] >= 0, ev_tag, -1)
    return ev_tag, ev_dest


def _accumulate_activity(
    flat: torch.Tensor,  # [B, M] per-batch flat indices in [0, size]; size = invalid
    weights: torch.Tensor,  # [B, M]
    size: int,
) -> torch.Tensor:  # [B, size]
    """Batched scatter-add into per-batch activity slabs.

    (batch, slot) is linearized into one int64 index so the whole batch is a
    single ``index_add_``; slot ``size`` of each slab absorbs invalid
    entries and is sliced off.
    """
    b = flat.shape[0]
    span = size + 1
    offsets = torch.arange(b, dtype=torch.int64, device=flat.device)[:, None] * span
    a = torch.zeros(b * span, dtype=weights.dtype, device=weights.device)
    a.index_add_(0, (flat.long() + offsets).reshape(-1), weights.reshape(-1))
    return a.reshape(b, span)[:, :size]


def _accumulate_into(
    buf: torch.Tensor,  # [B, size] existing per-batch accumulator (e.g. the ring)
    flat: torch.Tensor,  # [B, M] or [M] flat indices; out of range = dropped
    weights: torch.Tensor,  # [B, M]
) -> torch.Tensor:  # [B, size], a new tensor
    """Scatter-add into (a copy of) an existing accumulator.

    The ring update of the fabric's time wheel adds each step's events to
    the carried ring. Indices outside ``[0, size)`` are dropped, as
    ``repro``'s ``mode="drop"`` scatter and the ``fabric_deliver`` kernel
    do. The reference picks among int32, int64 and 2-D index paths to dodge
    int32 overflow; the int64 index of :func:`_accumulate_activity` needs
    one path only.
    """
    b, size = buf.shape
    flat = torch.where((flat >= 0) & (flat < size), flat.long(), size)
    return buf + _accumulate_activity(flat.expand(b, flat.shape[-1]), weights, size)


def _scatter_count(
    mask: torch.Tensor,  # [..., Q, E] bool events to count
    bins: torch.Tensor,  # [..., Q, E] int bin per event (value under ~mask ignored)
    size: int,
) -> torch.Tensor:  # [..., size] int32
    """Per-bin event counts: the attribution-preserving form of ``mask.sum()``.

    Used by the ``per_link_stats`` mode of :func:`stage1_route_events_fabric`
    to keep drops per directed link and deliveries per cluster pair.
    Masked-out events land in a sentinel slot that is sliced off.
    """
    flat = torch.where(mask, bins.clamp(0, size - 1), size)
    counts = mask.to(torch.int32)
    batch_shape = mask.shape[:-2]
    b = math.prod(batch_shape)
    out = _accumulate_activity(flat.reshape(b, -1), counts.reshape(b, -1), size)
    return out.reshape(*batch_shape, size)


def stage1_route(
    spikes: torch.Tensor,  # [..., N] float event weights
    src_tag: torch.Tensor,  # [N, E] int32, -1 = empty
    src_dest: torch.Tensor,  # [N, E] int32 cluster ids
    n_clusters: int,
    k_tags: int,
) -> torch.Tensor:  # [..., n_clusters, K]
    """Dense stage 1: scatter all ``N x E`` SRAM entries, weighted by spikes."""
    valid = src_tag >= 0
    size = n_clusters * k_tags
    flat = torch.where(valid, src_dest.long() * k_tags + src_tag, size)  # [N, E]
    weights = spikes[..., None] * valid.to(spikes.dtype)  # [..., N, E]
    batch_shape = spikes.shape[:-1]
    b = math.prod(batch_shape)
    flat_b = flat.reshape(1, -1).expand(b, flat.numel())
    a = _accumulate_activity(flat_b, weights.reshape(b, -1), size)
    return a.reshape(*batch_shape, n_clusters, k_tags)


def stage1_route_events(
    queue: EventQueue,
    src_tag: torch.Tensor,  # [N, E]
    src_dest: torch.Tensor,  # [N, E]
    n_clusters: int,
    k_tags: int,
) -> torch.Tensor:  # [..., n_clusters, K]
    """Event-sparse stage 1: scatter only the queued events' SRAM entries.

    Produces the same activity as :func:`stage1_route` whenever the queue
    holds every active source.
    """
    ev_tag, ev_dest = gather_event_entries(queue, src_tag, src_dest)
    valid = ev_tag >= 0
    size = n_clusters * k_tags
    flat = torch.where(valid, ev_dest.long() * k_tags + ev_tag, size)  # [..., Q, E]
    weights = queue.weight[..., None] * valid.to(queue.weight.dtype)
    batch_shape = queue.src.shape[:-1]
    b = math.prod(batch_shape)
    a = _accumulate_activity(flat.reshape(b, -1), weights.reshape(b, -1), size)
    return a.reshape(*batch_shape, n_clusters, k_tags)


# ---------------------------------------------------------------------------
# stage 1, fabric mode: tile binning, link FIFOs, delay-indexed scatter
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FabricRouteResult:
    """Outcome of one fabric-mode stage-1 pass (DESIGN.md §11).

    ``buffer[..., d, c, t]`` is the tag activity arriving at cluster ``c``
    under tag ``t`` in ``d`` steps (``d = 0`` = this step; with ``cursor``
    the slots are ring-addressed instead); ``link_dropped`` counts events
    lost to inter-tile link-FIFO overflow; ``delivered`` counts routed
    (kept) events. ``hops`` / ``latency_s`` / ``energy_j`` are per-step sums
    over delivered events of the Table II-IV per-event figures (``None``
    when the matrices were not supplied).

    With ``per_link_stats`` the two counters keep their attribution:
    ``link_dropped`` becomes ``[..., n_tiles * n_tiles]`` (flat directed
    tile pair) and ``delivered`` becomes ``[..., n_clusters * n_clusters]``
    (flat (src_cluster, dst_cluster) pair). Both sum over their trailing
    axis to exactly the scalar-mode values.
    """

    buffer: torch.Tensor  # [..., max_delay + 1, n_clusters, K]
    link_dropped: torch.Tensor  # [...] int32, or [..., T*T] per-link
    delivered: torch.Tensor  # [...] int32, or [..., nc*nc] per-pair
    hops: torch.Tensor | None = None  # [...] int32
    latency_s: torch.Tensor | None = None  # [...] float32
    energy_j: torch.Tensor | None = None  # [...] float32


def dispatch_slots(
    flat_e: torch.Tensor, n_bins: int, cap: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign each event a slot in its bin's fixed-capacity buffer.

    ``flat_e [..., A]`` is a bin id per event (out of range = inactive);
    returns ``(slot, keep)`` of the same shape, where ``slot = bin * cap +
    position`` for the first ``cap`` events of each bin in stable order and
    ``keep`` masks the rest (``slot = -1``): the FIFO-overflow semantics of
    :func:`compact_events`, for many bins at once, row by row over the
    leading dims. A stable argsort, as in ``repro``.
    """
    a = flat_e.shape[-1]
    flat_e = torch.where(flat_e < 0, n_bins, flat_e).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    in_range = sorted_e < n_bins
    clipped = sorted_e.clamp(max=n_bins)
    counts = torch.zeros(
        (*flat_e.shape[:-1], n_bins + 1), dtype=torch.int64, device=flat_e.device
    )
    counts.scatter_add_(-1, clipped, torch.ones_like(clipped))
    counts = counts[..., :n_bins]
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = torch.arange(a, dtype=torch.int64, device=flat_e.device)
    pos_in_e = pos - torch.gather(starts, -1, sorted_e.clamp(max=n_bins - 1))
    keep = (pos_in_e < cap) & in_range
    slot_sorted = torch.where(keep, sorted_e * cap + pos_in_e, -1)
    slot = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    return slot.to(torch.int32), slot >= 0


def stage1_route_events_fabric(
    queue: EventQueue,  # src [..., Q] neuron ids into src_tag's rows
    src_tag: torch.Tensor,  # [N, E]
    src_dest: torch.Tensor,  # [N, E] destination cluster ids
    n_clusters: int,
    k_tags: int,
    cluster_size: int,
    cluster_tile: torch.Tensor,  # [n_clusters] int32 linear tile id per cluster
    delay_steps: torch.Tensor,  # [n_clusters, n_clusters] int32 arrival delays
    n_tiles: int,
    max_delay: int,
    link_capacity: int | None,  # events per directed tile pair per step; None = inf
    mesh_hops: torch.Tensor | None = None,  # [nc, nc] optional stats matrices
    latency_s: torch.Tensor | None = None,
    energy_j: torch.Tensor | None = None,
    cursor: torch.Tensor | None = None,  # time-wheel write cursor (ring addressing)
    per_link_stats: bool = False,  # keep drop/delivered attribution (§18)
) -> FabricRouteResult:
    """Event-sparse stage 1 through the R1/R2/R3 fabric.

    Each queued event's SRAM entry is binned by its (source tile,
    destination tile) pair:

      * intra-tile entries (R1/R2 only) land in ``buffer[0]``;
      * cross-tile entries contend for their directed link's FIFO: the
        first ``link_capacity`` events per link (queue slot order, i.e.
        lowest source id first) win, the rest are dropped and counted;
      * surviving cross-tile entries land ``delay_steps[src, dst]`` slots
        deep in the buffer.

    Per-event stats are summed over *delivered* entries only. With
    ``cursor`` set, an event with delay ``d`` lands in slot ``(cursor + d)
    % (max_delay + 1)`` (the time-wheel ring, DESIGN.md §14); arbitration,
    drops and stats are unchanged. ``repro``'s ``src_cluster_offset``
    (sharded fabric) and ``entry_alive`` (faults) are not ported yet.
    """
    ev_tag, ev_dest = gather_event_entries(queue, src_tag, src_dest)  # [..., Q, E]
    valid = ev_tag >= 0
    src_cl = torch.where(queue.src >= 0, torch.div(queue.src, cluster_size,
                                                   rounding_mode="floor"), 0)
    src_cl_e = src_cl[..., None].expand(ev_tag.shape).long()  # [..., Q, E]
    dst_cl = ev_dest.clamp(0, n_clusters - 1).long()
    pair = src_cl_e * n_clusters + dst_cl  # flat [nc, nc] index
    tiles = cluster_tile.long()
    src_tile = tiles[src_cl_e.clamp(0, n_clusters - 1)]
    dst_tile = tiles[dst_cl]
    cross = (src_tile != dst_tile) & valid

    if link_capacity is None:
        keep_cross = torch.ones_like(cross)
    else:
        bins = torch.where(cross, src_tile * n_tiles + dst_tile, -1)
        flat_bins = bins.reshape(*bins.shape[:-2], -1)
        _, keep_flat = dispatch_slots(flat_bins, n_tiles * n_tiles, link_capacity)
        keep_cross = keep_flat.reshape(bins.shape)

    kept = valid & (~cross | keep_cross)
    if per_link_stats:
        link_bins = src_tile * n_tiles + dst_tile
        link_dropped = _scatter_count(cross & ~keep_cross, link_bins, n_tiles * n_tiles)
        delivered = _scatter_count(kept, pair, n_clusters * n_clusters)
    else:
        link_dropped = (cross & ~keep_cross).sum((-1, -2), dtype=torch.int32)
        delivered = kept.sum((-1, -2), dtype=torch.int32)

    delay = delay_steps.reshape(-1)[pair].long()
    slot = delay if cursor is None else (cursor.long() + delay) % (max_delay + 1)
    size = (max_delay + 1) * n_clusters * k_tags
    flat = torch.where(kept, (slot * n_clusters + dst_cl) * k_tags + ev_tag.clamp(min=0), size)
    weights = queue.weight[..., None] * kept.to(queue.weight.dtype)
    batch_shape = queue.src.shape[:-1]
    b = math.prod(batch_shape)
    a = _accumulate_activity(flat.reshape(b, -1), weights.reshape(b, -1), size)
    buffer = a.reshape(*batch_shape, max_delay + 1, n_clusters, k_tags)

    def _sum_over_kept(matrix, dtype):
        if matrix is None:
            return None
        vals = matrix.reshape(-1)[pair]
        return torch.where(kept, vals, torch.zeros((), dtype=vals.dtype,
                                                   device=vals.device)).sum((-1, -2), dtype=dtype)

    return FabricRouteResult(
        buffer=buffer,
        link_dropped=link_dropped,
        delivered=delivered,
        hops=_sum_over_kept(mesh_hops, torch.int32),
        latency_s=_sum_over_kept(latency_s, torch.float32),
        energy_j=_sum_over_kept(energy_j, torch.float32),
    )


def precompute_syn_onehot(
    cam_syn: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """One-hot synapse-type plane ``[N, S, N_SYN_TYPES]`` for stage 2.

    Types outside ``[0, N_SYN_TYPES)`` give an all-zero row, as
    ``jax.nn.one_hot`` does.
    """
    types = torch.arange(N_SYN_TYPES, device=cam_syn.device)
    return (cam_syn[..., None] == types).to(dtype)


def stage2_cam_match(
    activity: torch.Tensor,  # [..., n_clusters, K]
    cam_tag: torch.Tensor,  # [N, S] int32, -1 = empty
    cam_syn: torch.Tensor,  # [N, S] int32 in [0, N_SYN_TYPES)
    cluster_size: int,
    syn_onehot: torch.Tensor | None = None,  # [N, S, N_SYN_TYPES] precomputed
) -> torch.Tensor:  # [..., N, N_SYN_TYPES]
    """Broadcast + CAM match, plain PyTorch.

    CAM word ``(j, s)`` reads ``activity[cluster_of(j), cam_tag[j, s]]``:
    the tag is clamped into ``[0, K)`` for the gather and invalid words are
    zeroed after it, then the values are summed per synapse type with a
    one-hot contraction. On CUDA that contraction is a float32 matmul, so
    callers keep ``torch.backends.cuda.matmul.allow_tf32`` False.
    """
    n, _ = cam_tag.shape
    n_clusters, k = activity.shape[-2:]
    batch_shape = activity.shape[:-2]
    if n != n_clusters * cluster_size:
        raise ValueError(
            f"cam_tag has {n} rows, activity has {n_clusters} clusters of "
            f"{cluster_size}"
        )
    valid = cam_tag >= 0
    cluster_of_word = (
        torch.arange(n, dtype=torch.int64, device=cam_tag.device)[:, None] // cluster_size
    )
    flat_word = cluster_of_word * k + cam_tag.clamp(0, k - 1)  # [N, S]
    act_flat = activity.reshape(*batch_shape, n_clusters * k)
    vals = act_flat[..., flat_word]  # [..., N, S]
    vals = torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    if syn_onehot is None:
        syn_onehot = precompute_syn_onehot(cam_syn, dtype=vals.dtype)
    return torch.einsum("...ns,nst->...nt", vals, syn_onehot.to(vals.dtype))


def two_stage_deliver(
    spikes: torch.Tensor,
    src_tag: torch.Tensor,
    src_dest: torch.Tensor,
    cam_tag: torch.Tensor,
    cam_syn: torch.Tensor,
    cluster_size: int,
    k_tags: int,
    external_activity: torch.Tensor | None = None,
    backend: str | object = "reference",
    queue_capacity: int | None = None,
    syn_onehot: torch.Tensor | None = None,
    with_stats: bool = False,
):
    """Full event delivery: spikes -> synaptic drive per neuron & synapse type.

    ``external_activity`` injects input events directly as tag activity.
    ``backend`` selects the dispatch implementation by name or instance
    (core/dispatch.py registry); on CUDA tensors the kernel backends launch
    their kernels. ``queue_capacity`` enables event-sparse delivery through a
    fixed-capacity AER queue; with ``with_stats=True`` the return value is
    ``(drive, DeliveryStats)`` carrying the queue's drop counter.
    """
    from repro_torch.core.dispatch import backend_deliver, get_backend  # dispatch imports us

    return backend_deliver(
        get_backend(backend),
        spikes,
        src_tag,
        src_dest,
        cam_tag,
        cam_syn,
        cluster_size,
        k_tags,
        external_activity=external_activity,
        queue_capacity=queue_capacity,
        syn_onehot=syn_onehot,
        with_stats=with_stats,
    )
