"""Pluggable dispatch backends for batched event delivery.

Counterpart of ``repro.core.dispatch`` for the queued, non-fabric path. A
dispatch backend turns ``spikes [..., N]`` plus external tag activity
``[..., n_clusters, K]`` into per-neuron synaptic drive ``[..., N, 4]``:

  * ``reference`` — plain PyTorch scatter + indexed gather (the oracle)
  * ``cuda``      — stage 2 on the hand-written ``cam_match`` CUDA kernel
                    (the counterpart of ``repro``'s ``pallas`` backend)
  * ``fused``     — stage-1 scatter AND stage-2 CAM match in the
                    hand-written ``fused_deliver`` CUDA kernel; always
                    event-queued

On CPU tensors the two kernel backends run their kernels' plain versions.
``queue_capacity`` compacts active spikes into a fixed-capacity AER queue
before stage 1; ``with_stats=True`` also returns a :class:`DeliveryStats`.
Backends are selected by name through :func:`get_backend`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.two_stage import (
    compact_events,
    stage1_route,
    stage1_route_events,
    stage2_cam_match,
)
from repro_torch.kernels.cam_match import ops as cam_ops
from repro_torch.kernels.fused_deliver import ops as fused_ops

__all__ = [
    "DispatchBackend",
    "DeliveryStats",
    "ReferenceBackend",
    "CudaBackend",
    "FusedBackend",
    "register_backend",
    "get_backend",
    "available_backends",
]

_REGISTRY: dict[str, type] = {}


@dataclasses.dataclass(frozen=True)
class DeliveryStats:
    """Per-stream delivery statistics: ``dropped [...]`` int32 counts events
    lost to AER-queue overflow this step (0 everywhere on the dense path).
    The fabric counters of ``repro``'s ``DeliveryStats`` come with the
    fabric slice."""

    dropped: torch.Tensor


def register_backend(name: str):
    """Class decorator: register a :class:`DispatchBackend` under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(spec: "str | DispatchBackend | None" = "reference") -> "DispatchBackend":
    """Resolve a backend by name or pass an instance through unchanged."""
    if isinstance(spec, DispatchBackend):
        return spec
    if spec is None:
        spec = "reference"
    try:
        cls = _REGISTRY[spec]
    except KeyError:
        raise ValueError(
            f"unknown dispatch backend {spec!r}; available: {available_backends()}"
        ) from None
    return cls()


def _stage1_activity(
    spikes: torch.Tensor,
    src_tag: torch.Tensor,
    src_dest: torch.Tensor,
    n_clusters: int,
    k_tags: int,
    queue_capacity: int | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 scatter, dense or event-queued: ``(activity, dropped)``."""
    if queue_capacity is None or queue_capacity >= spikes.shape[-1]:
        # capacity >= N makes the queue lossless AND makes compaction pure
        # overhead: the dense scatter visits the same nonzero entries, adding
        # only exact-0.0 terms for silent sources — bit-identical activity
        # on the serving path, zero drops, no cumsum/searchsorted
        a = stage1_route(spikes, src_tag, src_dest, n_clusters, k_tags)
        dropped = torch.zeros(spikes.shape[:-1], dtype=torch.int32, device=spikes.device)
        return a, dropped
    queue = compact_events(spikes, queue_capacity)
    a = stage1_route_events(queue, src_tag, src_dest, n_clusters, k_tags)
    return a, queue.dropped


class DispatchBackend:
    """Interface: batched stage-1 scatter shared, stage-2 pluggable."""

    name = "abstract"

    def cam_match(
        self,
        activity: torch.Tensor,  # [..., n_clusters, K]
        cam_tag: torch.Tensor,  # [N, S]
        cam_syn: torch.Tensor,  # [N, S]
        cluster_size: int,
        syn_onehot: torch.Tensor | None = None,  # [N, S, 4] per-table constant
    ) -> torch.Tensor:  # [..., N, 4]
        raise NotImplementedError

    def deliver(
        self,
        spikes: torch.Tensor,  # [..., N]
        src_tag: torch.Tensor,
        src_dest: torch.Tensor,
        cam_tag: torch.Tensor,
        cam_syn: torch.Tensor,
        cluster_size: int,
        k_tags: int,
        external_activity: torch.Tensor | None = None,
        queue_capacity: int | None = None,
        syn_onehot: torch.Tensor | None = None,
        with_stats: bool = False,
    ):
        n = spikes.shape[-1]
        a, dropped = _stage1_activity(
            spikes, src_tag, src_dest, n // cluster_size, k_tags, queue_capacity
        )
        if external_activity is not None:
            a = a + external_activity
        drive = self.cam_match(a, cam_tag, cam_syn, cluster_size, syn_onehot)
        if with_stats:
            return drive, DeliveryStats(dropped=dropped)
        return drive


@register_backend("reference")
@dataclasses.dataclass(frozen=True)
class ReferenceBackend(DispatchBackend):
    """Plain PyTorch stage 2 (direct indexed gather + synapse-type einsum)."""

    def cam_match(self, activity, cam_tag, cam_syn, cluster_size, syn_onehot=None):
        return stage2_cam_match(activity, cam_tag, cam_syn, cluster_size, syn_onehot)


@register_backend("cuda")
@dataclasses.dataclass(frozen=True)
class CudaBackend(DispatchBackend):
    """Stage 2 on the hand-written ``cam_match`` CUDA kernel.

    The kernel reads the CAM synapse types directly; the precomputed
    one-hot is a plain-version optimization and is ignored here.
    """

    def cam_match(self, activity, cam_tag, cam_syn, cluster_size, syn_onehot=None):
        return cam_ops.cam_match(activity, cam_tag, cam_syn, cluster_size)


@register_backend("fused")
@dataclasses.dataclass(frozen=True)
class FusedBackend(DispatchBackend):
    """Single-kernel delivery: stage-1 scatter + stage-2 CAM match fused.

    Always event-queued: ``queue_capacity=None`` sizes the queue to N
    (lossless). External activity is broadcast to the batch shape and made
    contiguous before the kernel reads it.
    """

    def cam_match(self, activity, cam_tag, cam_syn, cluster_size, syn_onehot=None):
        # stage 2 alone (no queue to fuse with): reference semantics.
        return stage2_cam_match(activity, cam_tag, cam_syn, cluster_size, syn_onehot)

    def deliver(
        self,
        spikes,
        src_tag,
        src_dest,
        cam_tag,
        cam_syn,
        cluster_size,
        k_tags,
        external_activity=None,
        queue_capacity=None,
        syn_onehot=None,
        with_stats=False,
    ):
        capacity = spikes.shape[-1] if queue_capacity is None else queue_capacity
        queue = compact_events(spikes, capacity)
        if external_activity is not None:
            n_clusters = src_tag.shape[0] // cluster_size
            external_activity = external_activity.expand(
                *spikes.shape[:-1], n_clusters, k_tags
            ).contiguous()
        drive = fused_ops.fused_deliver(
            queue, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k_tags,
            external_activity=external_activity, syn_onehot=syn_onehot,
        )
        if with_stats:
            return drive, DeliveryStats(dropped=queue.dropped)
        return drive
