"""Pluggable dispatch backends for batched event delivery.

Counterpart of ``repro.core.dispatch``. A dispatch backend turns ``spikes
[..., N]`` plus external tag activity ``[..., n_clusters, K]`` into
per-neuron synaptic drive ``[..., N, 4]``:

  * ``reference`` — plain PyTorch scatter + indexed gather (the oracle)
  * ``cuda``      — stage 2 on the hand-written ``cam_match`` CUDA kernel
                    (the counterpart of ``repro``'s ``pallas`` backend)
  * ``fused``     — stage-1 scatter AND stage-2 CAM match in the
                    hand-written ``fused_deliver`` CUDA kernel; always
                    event-queued
  * ``fabric``    — latency/bandwidth-aware delivery through the executable
                    R1/R2/R3 model (DESIGN.md §11): tile binning, per-link
                    FIFOs, delay lines, Table II-IV stats; its time-wheel
                    ring step runs the hand-written ``fabric_deliver`` kernel

On CPU tensors the kernel backends run their kernels' plain versions.
``queue_capacity`` compacts active spikes into a fixed-capacity AER queue
before stage 1; ``with_stats=True`` also returns a :class:`DeliveryStats`.
Backends are selected by name through :func:`get_backend`;
:func:`backend_deliver` is the signature-tolerant ``deliver`` call of
``two_stage_deliver``.

:func:`autotune_backend` (``EventEngine(backend="auto")``) measures the
dense / queued / fused crossover at one (activity, batch) point on the
engine's device and returns an :class:`AutotuneDecision`, as ``repro``'s
autotuner does: the same candidates, ``tol`` rule and lossless-queue alias,
and on the CPU the same mapping. On the card the plain stage 2 is never
chosen: ``dense`` and ``queued`` are served by the ``cuda`` backend.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import time

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.core.device import resolve_device
from repro_torch.core.two_stage import (
    compact_events,
    stage1_route,
    stage1_route_events,
    stage1_route_events_fabric,
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
    "FabricBackend",
    "AutotuneDecision",
    "advance_inflight",
    "autotune_backend",
    "autotune_candidates",
    "backend_deliver",
    "register_backend",
    "get_backend",
    "served_backend",
    "available_backends",
]

_REGISTRY: dict[str, type] = {}


@dataclasses.dataclass(frozen=True)
class DeliveryStats:
    """Per-stream delivery statistics.

    ``dropped [...]`` int32 counts events lost to AER-queue overflow this
    step (0 everywhere on the dense path). The remaining fields are filled
    only by the fabric backend and stay ``None`` elsewhere:
    ``link_dropped`` counts events lost to inter-tile link-FIFO overflow,
    ``delivered`` counts routed events, and ``hops`` / ``latency_s`` /
    ``energy_j`` are per-step sums of the Table II-IV per-event figures
    over delivered events.
    """

    dropped: torch.Tensor
    link_dropped: torch.Tensor | None = None
    delivered: torch.Tensor | None = None
    hops: torch.Tensor | None = None
    latency_s: torch.Tensor | None = None
    energy_j: torch.Tensor | None = None


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


@functools.lru_cache(maxsize=None)
def _deliver_kwargs(cls: type) -> frozenset[str] | None:
    """Names ``cls.deliver`` accepts as keywords, worked out once per
    backend class; ``None`` means it takes ``**kwargs``."""
    sig = inspect.signature(cls.deliver)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        return None
    return frozenset(sig.parameters)


def backend_deliver(
    backend: "DispatchBackend",
    spikes: torch.Tensor,
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
    """Signature-tolerant ``deliver`` call (``two_stage_deliver``'s).

    A backend whose ``deliver`` lacks the ``queue_capacity`` /
    ``syn_onehot`` / ``with_stats`` keywords keeps working: they are
    forwarded only when accepted. ``syn_onehot`` is an optimization hint and
    is dropped silently; ``with_stats`` is synthesized (zero drops — such a
    backend is always dense); asking it for ``queue_capacity`` is a semantic
    request it cannot honor and raises.
    """
    accepted = _deliver_kwargs(type(backend))
    kwargs = {"external_activity": external_activity}
    for name, value in (
        ("queue_capacity", queue_capacity),
        ("syn_onehot", syn_onehot),
        ("with_stats", with_stats),
    ):
        if accepted is None or name in accepted:
            kwargs[name] = value
        elif name == "queue_capacity" and queue_capacity is not None:
            raise ValueError(
                f"dispatch backend {backend.name!r} predates event-sparse "
                "delivery and does not support queue_capacity"
            )
    out = backend.deliver(
        spikes, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k_tags, **kwargs
    )
    if with_stats and "with_stats" not in kwargs:
        dropped = torch.zeros(spikes.shape[:-1], dtype=torch.int32, device=spikes.device)
        return out, DeliveryStats(dropped=dropped)
    return out


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
    one-hot is a plain-version optimization and is ignored here. The kernel
    reads the activity as one dense block: the stage-1 scatter alone (no
    external activity added) leaves a strided view, so it is made
    contiguous first (free when it already is).
    """

    def cam_match(self, activity, cam_tag, cam_syn, cluster_size, syn_onehot=None):
        return cam_ops.cam_match(activity.contiguous(), cam_tag, cam_syn, cluster_size)


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


def advance_inflight(buffer, inflight, max_delay: int):
    """Advance the fabric delay line one step: ``(activity_now, new_inflight)``.

    ``buffer [..., max_delay + 1, nc, K]`` is this step's routed scatter
    (slot 0 = arriving now); ``inflight [..., max_delay, nc, K]`` is the
    carried tail, or ``None`` to collapse every delay slot into the current
    step (the single-shot statistical mode — returns ``None`` back).
    """
    if inflight is None:
        return buffer.sum(dim=-3), None
    if max_delay == 0:
        return buffer[..., 0, :, :], inflight  # inflight is empty [..., 0, nc, K]
    a = buffer[..., 0, :, :] + inflight[..., 0, :, :]
    shifted = torch.cat(
        [inflight[..., 1:, :, :], torch.zeros_like(inflight[..., :1, :, :])], dim=-3
    )
    return a, shifted + buffer[..., 1:, :, :]


def _lead(batch) -> tuple[int, ...]:
    return () if batch is None else (batch,) if isinstance(batch, int) else tuple(batch)


@register_backend("fabric")
class FabricBackend(DispatchBackend):
    """Latency/bandwidth-aware delivery over the R1/R2/R3 fabric (§11).

    Events are compacted into the AER queue, binned by (source, destination)
    tile pair, pushed through per-link bandwidth FIFOs
    (``r3_throughput_eps * dt`` events per directed tile pair per step,
    lowest-source-id-first overflow), and scattered into a delay-indexed
    activity buffer — cross-tile events arrive
    ``ceil(mesh_hops * latency_across_chip_s / dt)`` steps later.

    Entry points:

    * :meth:`deliver_fabric_ring`, the default mode of
      ``EventEngine(fabric=...)`` (DESIGN.md §14): the carried buffer is a
      time-wheel ring ``[..., max_delay + 1, nc, K]`` indexed by a carried
      int32 cursor, and delivery runs over a static per-SRAM-entry table
      (kernels/fabric_deliver). On CUDA tensors the ring update and the
      CAM match run in the hand-written ``fabric_deliver`` kernel;
      ``kernel=False`` runs its plain version instead (for holding the
      kernel against it), and CPU tensors always take the plain version.
    * :meth:`deliver_fabric` takes and returns the roll-carried in-flight
      buffer (``[..., max_delay, n_clusters, K]``; ``ring=False``), the
      parity reference, in plain PyTorch.
    * :meth:`deliver` (the registry API) models one isolated timestep with
      every surviving event collapsed into the same step.

    ``tile_of_cluster`` pins the placement (default: hierarchical linear);
    per-event constants are precomputed once per cluster count
    (``routing.build_delivery_model``). ``repro``'s TPU knobs ``block_c``
    and ``interpret`` have no counterpart; ``faults`` must be ``None``
    (fault injection is not ported yet).
    """

    def __init__(
        self,
        fabric: routing.Fabric | None = None,
        tile_of_cluster=None,
        dt: float = 1e-3,
        vdd: float = 1.3,
        link_capacity: int | None = None,
        ring: bool = True,
        faults=None,
        per_link_stats: bool = False,
        kernel: bool = True,
    ):
        if faults is not None:
            raise NotImplementedError(
                "fault injection (FaultSpec) is not ported yet; it comes with the "
                "faults slice of the port (ROADMAP queue 1, 'Faults and recovery')"
            )
        self.fabric = fabric if fabric is not None else routing.Fabric()
        self.tile_of_cluster = tile_of_cluster
        self.dt = float(dt)
        self.vdd = vdd
        self.link_capacity = link_capacity
        self.ring = bool(ring)
        self.per_link_stats = bool(per_link_stats)
        self.kernel = bool(kernel)
        self._models: dict[int, routing.FabricDeliveryModel] = {}
        self._arrays: dict[tuple[int, torch.device], dict[str, torch.Tensor]] = {}

    def model_for(self, n_clusters: int) -> routing.FabricDeliveryModel:
        """The (cached) :class:`~repro_torch.core.routing.FabricDeliveryModel`
        for a cluster count."""
        model = self._models.get(n_clusters)
        if model is None:
            model = routing.build_delivery_model(
                self.fabric, n_clusters, self.dt, tile_of_cluster=self.tile_of_cluster,
                vdd=self.vdd, link_capacity=self.link_capacity,
            )
            self._models[n_clusters] = model
        return model

    def arrays_for(self, n_clusters: int, device: torch.device) -> dict[str, torch.Tensor]:
        """The model's per-cluster-pair matrices as tensors on ``device``."""
        key = (n_clusters, torch.device(device))
        arrays = self._arrays.get(key)
        if arrays is None:
            model = self.model_for(n_clusters)
            arrays = {
                name: torch.as_tensor(getattr(model, attr), device=device)
                for name, attr in (
                    ("cluster_tile", "tile_of_cluster"), ("delay_steps", "delay_steps"),
                    ("mesh_hops", "mesh_hops"), ("latency_s", "latency_s"),
                    ("energy_j", "energy_j"),
                )
            }
            self._arrays[key] = arrays
        return arrays

    def init_inflight(
        self, n_clusters: int, k_tags: int, batch=None, dtype=torch.float32,
        device: torch.device | str = "cuda",
    ) -> torch.Tensor:
        """Zero in-flight buffer ``[..., max_delay, n_clusters, K]``."""
        model = self.model_for(n_clusters)
        return torch.zeros((*_lead(batch), model.max_delay, n_clusters, k_tags),
                           dtype=dtype, device=resolve_device(device))

    def init_ring(
        self, n_clusters: int, k_tags: int, batch=None, dtype=torch.float32,
        device: torch.device | str = "cuda",
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero time-wheel ring ``[..., max_delay + 1, nc, K]`` + cursor 0.

        The cursor is one 0-dim int32 tensor on the device, shared by every
        batch slot (they step in lockstep); the kernel reads it through a
        pointer, so stepping never syncs the host.
        """
        model = self.model_for(n_clusters)
        dev = resolve_device(device)
        ring = torch.zeros((*_lead(batch), model.max_delay + 1, n_clusters, k_tags),
                           dtype=dtype, device=dev)
        return ring, torch.zeros((), dtype=torch.int32, device=dev)

    def build_entries(self, src_tag, src_dest, cluster_size: int, k_tags: int,
                      device: torch.device | str = "cuda"):
        """Static per-SRAM-entry table for the ring path (host-side, once per
        engine); see kernels/fabric_deliver/ops.py."""
        from repro_torch.kernels.fabric_deliver import ops as fabric_ops

        n_clusters = src_tag.shape[0] // cluster_size
        return fabric_ops.build_fabric_entries(
            src_tag, src_dest, cluster_size, k_tags, self.model_for(n_clusters),
            device=device,
        )

    def deliver_fabric_ring(
        self,
        spikes,
        entries,  # FabricEntries from build_entries
        cam_tag,
        cam_syn,
        cluster_size,
        k_tags,
        ring,  # [..., max_delay + 1, nc, K]
        cursor,  # 0-dim int32 tensor
        external_activity=None,
        queue_capacity=None,
        syn_onehot=None,
    ):
        """Ring fabric step: ``(drive, ring, cursor, DeliveryStats)``."""
        from repro_torch.kernels.fabric_deliver import ops as fabric_ops

        model = self.model_for(spikes.shape[-1] // cluster_size)
        return fabric_ops.fabric_deliver_ring(
            spikes, entries, cam_tag, cam_syn, cluster_size, k_tags, ring, cursor,
            max_delay=model.max_delay, link_capacity=model.link_capacity,
            queue_capacity=queue_capacity, external_activity=external_activity,
            syn_onehot=syn_onehot, per_link_stats=self.per_link_stats,
            n_tiles=model.n_tiles, kernel=self.kernel,
        )

    def cam_match(self, activity, cam_tag, cam_syn, cluster_size, syn_onehot=None):
        return stage2_cam_match(activity, cam_tag, cam_syn, cluster_size, syn_onehot)

    def deliver_fabric(
        self,
        spikes,
        src_tag,
        src_dest,
        cam_tag,
        cam_syn,
        cluster_size,
        k_tags,
        inflight=None,  # [..., max_delay, n_clusters, K] or None (collapse delays)
        external_activity=None,
        queue_capacity=None,
        syn_onehot=None,
    ):
        """Roll fabric step: ``(drive, new_inflight, DeliveryStats)``.

        ``new_inflight`` is ``None`` when ``inflight`` was ``None`` (the
        collapsed single-shot mode used by :meth:`deliver`).
        """
        n = spikes.shape[-1]
        n_clusters = n // cluster_size
        model = self.model_for(n_clusters)
        arrs = self.arrays_for(n_clusters, spikes.device)
        capacity = n if queue_capacity is None else queue_capacity
        queue = compact_events(spikes, capacity)
        route = stage1_route_events_fabric(
            queue, src_tag, src_dest, n_clusters, k_tags, cluster_size,
            arrs["cluster_tile"], arrs["delay_steps"], model.n_tiles, model.max_delay,
            model.link_capacity, mesh_hops=arrs["mesh_hops"],
            latency_s=arrs["latency_s"], energy_j=arrs["energy_j"],
            per_link_stats=self.per_link_stats,
        )
        a, new_inflight = advance_inflight(route.buffer, inflight, model.max_delay)
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
        return drive, new_inflight, stats

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
        drive, _, stats = self.deliver_fabric(
            spikes, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k_tags,
            inflight=None, external_activity=external_activity,
            queue_capacity=queue_capacity, syn_onehot=syn_onehot,
        )
        if with_stats:
            return drive, stats
        return drive


# ---------------------------------------------------------------------------
# dispatch autotuner: measured dense/queued/fused crossover (DESIGN.md §18)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AutotuneDecision:
    """Outcome of one :func:`autotune_backend` pass.

    ``winner`` is the measured-fastest candidate; ``backend`` / ``dense``
    are how the engine realizes it on the device it was tuned for
    (registry backend name, :func:`served_backend`, + whether the AER queue
    compaction is bypassed — the dense path still reports zero-drop stats,
    so the step's output contract is unchanged). ``measurements`` records
    every candidate's per-call time in µs (:func:`_time_calls_us`: device
    time on the card, host time on the CPU), in candidate order, so the decision is auditable and the pool fingerprint
    can carry it.
    """

    winner: str
    backend: str
    dense: bool
    activity: float
    batch: int
    measurements: tuple[tuple[str, float], ...]

    def token(self) -> str:
        """Compact fingerprint component (decision, not timings)."""
        return f"autotune:{self.winner}:act{self.activity:g}:B{self.batch}"


# candidate -> (registry backend, bypass queue compaction), repro's mapping
_AUTOTUNE_IMPL = {
    "dense": ("reference", True),
    "queued": ("reference", False),
    "fused": ("fused", False),
    # fabric_ring is measurable only via an injected measurement (timing it
    # needs a ring carry); it maps onto the fabric backend's default mode
    "fabric_ring": ("fabric", False),
}
# calls per round on the card (device time, averaged over every round's calls)
_CALLS_PER_ROUND = 25


def autotune_candidates() -> tuple[str, ...]:
    return tuple(_AUTOTUNE_IMPL)


def served_backend(name: str, device: torch.device | str) -> str:
    """The registry backend that serves ``name`` on ``device``: on the card
    the plain stage 2 (``reference``) of an autotuned ``dense`` or
    ``queued`` winner is served by the ``cam_match`` kernel (``cuda``),
    which computes the same drive; elsewhere ``name`` itself."""
    if name == "reference" and torch.device(device).type == "cuda":
        return "cuda"
    return name


def _time_calls_us(fns: dict, spikes: torch.Tensor, iters: int) -> dict[str, float]:
    """Per-call time in µs of each ``fns[c](spikes)``.

    On the card: the device time of the kernels and copies one call puts
    on the card, from torch.profiler, averaged over ``iters`` rounds of
    ``_CALLS_PER_ROUND`` calls. The candidates issue about as many device
    ops each, so their host time differs by less than the host's jitter
    and its ranking flips from run to run; their device work does not.
    Raises if the trace shows no device time. On the CPU: the best of
    ``iters`` single calls on the host clock. Every candidate's warm-up call
    (which builds the kernel on first use) runs before any timing."""
    for fn in fns.values():
        fn(spikes)
    n = max(1, int(iters))
    if not spikes.is_cuda:
        best = dict.fromkeys(fns, float("inf"))
        for _ in range(n):
            for cand, fn in fns.items():
                t0 = time.perf_counter()
                fn(spikes)
                best[cand] = min(best[cand], (time.perf_counter() - t0) * 1e6)
        return best
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(spikes.device)
    calls = n * _CALLS_PER_ROUND
    out = {}
    for cand, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(spikes)
            torch.cuda.synchronize(spikes.device)
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy <= 0:
            raise RuntimeError(f"autotune: the trace of {cand!r} shows no device time")
        out[cand] = busy / calls
    return out


def autotune_backend(
    src_tag,
    src_dest,
    cam_tag,
    cam_syn,
    cluster_size: int,
    k_tags: int,
    *,
    activity: float = 0.1,
    batch: int = 8,
    queue_capacity: int | None = None,
    candidates: tuple[str, ...] = ("dense", "queued", "fused"),
    measure: dict[str, float] | None = None,
    iters: int = 3,
    seed: int = 0,
    tol: float = 0.05,
    device: torch.device | str = "cuda",
) -> AutotuneDecision:
    """Measure the dense/queued/fused crossover at one (activity, B) point.

    Times each candidate's delivery on ``device`` over a deterministic
    synthetic spike batch (``batch`` streams at ``activity`` fraction
    active, drawn with numpy from ``seed``) and returns the winner as an
    :class:`AutotuneDecision`. ``measure`` injects known timings per
    candidate (µs): injected candidates are not re-timed, so a fully
    injected call is deterministic and timing-free. The winner is the
    *earliest* candidate within ``tol`` of the measured fastest, not the
    strict argmin, so wall-clock jitter at a genuine crossover cannot flip
    the decision between runs (exact ties break in ``candidates`` order).

    ``queue_capacity`` should be the engine's actual queue depth. With
    ``None`` (or a capacity at/above the neuron count) the queued path is
    the dense path (the lossless-queue shortcut), so the tuner records
    dense's timing for it instead of racing two timings of the same program.
    On the card, ``dense`` and ``queued`` run the ``cam_match`` kernel and
    ``fused`` the ``fused_deliver`` kernel, and each is timed by the device
    work it puts on the card (:func:`_time_calls_us`).
    """
    for cand in candidates:
        if cand not in _AUTOTUNE_IMPL:
            raise ValueError(
                f"unknown autotune candidate {cand!r}; known: {autotune_candidates()}"
            )
    measure = dict(measure or {})
    timed = [c for c in candidates if c not in measure]
    if timed:
        from repro_torch.core.two_stage import precompute_syn_onehot

        dev = resolve_device(device)
        n = src_tag.shape[0]
        rng = np.random.default_rng(seed)
        spikes = torch.as_tensor(
            (rng.random((int(batch), n)) < float(activity)).astype(np.float32), device=dev
        )
        st, sd, ct, cs = (
            torch.as_tensor(a, device=dev).to(torch.int32)
            for a in (src_tag, src_dest, cam_tag, cam_syn)
        )
        onehot = precompute_syn_onehot(cs)
        lossless = queue_capacity is None or int(queue_capacity) >= n
        alias_queued = (
            lossless and "queued" in timed
            and ("dense" in measure or "dense" in timed)
        )
        fns = {}
        for cand in timed:
            if cand == "queued" and alias_queued:
                continue
            if cand == "fabric_ring":
                raise ValueError(
                    "fabric_ring can only be autotuned via an injected "
                    "measurement (measure={'fabric_ring': us})"
                )
            bname, dense = _AUTOTUNE_IMPL[cand]
            be = get_backend(served_backend(bname, dev))
            qc = None if dense else queue_capacity

            def fn(s, _be=be, _qc=qc):
                return _be.deliver(s, st, sd, ct, cs, cluster_size, k_tags,
                                   queue_capacity=_qc, syn_onehot=onehot)

            fns[cand] = fn
        measure.update(_time_calls_us(fns, spikes, iters))
        if alias_queued:
            measure["queued"] = measure["dense"]
    best = min(measure[c] for c in candidates)
    winner = next(c for c in candidates if measure[c] <= (1.0 + tol) * best)
    backend, dense = _AUTOTUNE_IMPL[winner]
    return AutotuneDecision(
        winner=winner,
        backend=served_backend(backend, device),
        dense=dense,
        activity=float(activity),
        batch=int(batch),
        measurements=tuple((c, float(measure[c])) for c in candidates),
    )
