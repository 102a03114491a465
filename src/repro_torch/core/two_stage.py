"""Two-stage tag dispatch in PyTorch (the paper's §II scheme, executable).

Counterpart of ``repro.core.two_stage`` for the queued, non-fabric path.

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
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "N_SYN_TYPES",
    "EventQueue",
    "compact_events",
    "gather_event_entries",
    "stage1_route",
    "stage1_route_events",
    "precompute_syn_onehot",
    "stage2_cam_match",
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
