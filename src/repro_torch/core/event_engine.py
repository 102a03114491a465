"""Event-driven SNN engine: two-stage routing + neuron dynamics, PyTorch.

Counterpart of ``repro.core.event_engine``, queued and fabric mode:

  spikes[t] --AER queue--> stage1 --> tag activity A[c, k] --stage2/CAM-->
           drive[N, 4] --AdExp/DPI--> spikes[t+1]

External stimulation enters as tag activity (events addressed to (cluster,
tag)). The carry and inputs may bear a leading batch dimension ``B``: B
independent event streams stepped against one set of routing tables.
Delivery goes through a dispatch backend (``reference``, ``cuda`` or
``fused``; core/dispatch.py), or, with ``fabric=``, through the executable
R1/R2/R3 fabric (``FabricBackend``): cross-tile events arrive late and link
FIFOs can drop. Fabric mode carries the delay line: a time-wheel ring and
its cursor by default, the roll buffer with ``fabric_options={"ring":
False}``.

``EventEngine.reset_slots(carry, mask)`` restores masked slots to fresh
state so a session pool can admit and evict tenants independently.

``dense_reference_step`` is the oracle: the same network as one dense
``[N, N, 4]`` connectivity tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import neuron as neuron_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch import (
    DeliveryStats,
    DispatchBackend,
    FabricBackend,
    get_backend,
)
from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.core.routing import Fabric, default_tile_of_cluster
from repro_torch.core.tags import RoutingTables
from repro_torch.core.two_stage import N_SYN_TYPES, precompute_syn_onehot

__all__ = [
    "EventEngine",
    "DeliveryStats",
    "reset_slots",
    "dense_weights_from_tables",
    "dense_reference_step",
]


@dataclasses.dataclass(frozen=True)
class _Tables:
    src_tag: torch.Tensor
    src_dest: torch.Tensor
    cam_tag: torch.Tensor
    cam_syn: torch.Tensor
    # per-table constant [N, S, 4]: one-hot synapse types, precomputed once
    cam_syn_onehot: torch.Tensor


class EventEngine:
    """Executable DYNAPs fabric for a compiled network.

    ``queue_capacity=Q`` compacts each step's spikes into a fixed-capacity
    AER queue before stage 1, and ``step``/``run`` then also return a
    :class:`DeliveryStats`. ``fabric`` (a :class:`~repro_torch.core.routing.Fabric`
    or a configured :class:`~repro_torch.core.dispatch.FabricBackend`) turns
    on fabric mode, which takes precedence over ``backend`` for delivery and
    always returns stats; ``fabric_options`` configure a backend built from a
    ``Fabric``. The engine runs on ``device`` (CUDA unless the caller asks
    for the CPU).
    """

    def __init__(
        self,
        tables: RoutingTables,
        params: NeuronParams | None = None,
        backend: str | DispatchBackend = "reference",
        queue_capacity: int | None = None,
        device: torch.device | str = "cuda",
        fabric: Fabric | FabricBackend | None = None,
        fabric_options: dict | None = None,
    ):
        self.device = resolve_device(device)
        self.params = params or NeuronParams()
        self.cluster_size = tables.cluster_size
        self.k_tags = tables.k_tags
        self.n_neurons = tables.n_neurons
        self.n_clusters = tables.n_clusters
        if queue_capacity is not None and queue_capacity <= 0:
            raise ValueError(f"queue_capacity must be positive, got {queue_capacity}")
        self.queue_capacity = queue_capacity
        self.backend = get_backend(backend)
        self.fabric_backend = None
        self.fabric_model = None
        if fabric is not None:
            self.fabric_backend = self._fabric_backend(tables, fabric, fabric_options)
            # built eagerly: placement errors surface here, and init_state
            # needs max_delay
            self.fabric_model = self.fabric_backend.model_for(self.n_clusters)
        elif fabric_options:
            raise ValueError("fabric_options need fabric=")

        def table(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=self.device)

        cam_syn = table(tables.cam_syn)
        self.tables = _Tables(
            src_tag=table(tables.src_tag),
            src_dest=table(tables.src_dest),
            cam_tag=table(tables.cam_tag),
            cam_syn=cam_syn,
            cam_syn_onehot=precompute_syn_onehot(cam_syn),
        )
        # ring mode (DESIGN.md §14): a static per-SRAM-entry table, built once
        self.fabric_ring = self.fabric_backend is not None and self.fabric_backend.ring
        self._fabric_entries = None
        if self.fabric_ring:
            self._fabric_entries = self.fabric_backend.build_entries(
                tables.src_tag, tables.src_dest, self.cluster_size, self.k_tags,
                device=self.device,
            )

    def _fabric_backend(self, tables, fabric, fabric_options) -> FabricBackend:
        """The fabric backend, checked against this engine's dt and the
        tables' placement (a mismatch would warp arrival times and hops)."""
        if isinstance(fabric, FabricBackend):
            if fabric_options:
                raise ValueError(
                    "fabric_options ignored: fabric was passed as a "
                    "FabricBackend instance — configure it at construction"
                )
            backend = fabric
        else:
            opts = dict(fabric_options or {})
            opts.setdefault("tile_of_cluster", tables.tile_of_cluster)
            opts.setdefault("dt", self.params.dt)
            backend = FabricBackend(fabric=fabric, **opts)
        if backend.dt != self.params.dt:
            raise ValueError(
                f"fabric dt={backend.dt} != NeuronParams.dt={self.params.dt}: "
                "delays and link capacity would be derived at a timestep the "
                "neurons do not integrate with"
            )
        if tables.tile_of_cluster is not None:
            tiles = backend.tile_of_cluster
            if tiles is None:
                tiles = default_tile_of_cluster(self.n_clusters, backend.fabric)
            if not np.array_equal(np.asarray(tiles), tables.tile_of_cluster):
                raise ValueError(
                    "fabric placement differs from the compiled tables' "
                    "tile_of_cluster — pass tile_of_cluster="
                    "tables.tile_of_cluster when constructing the backend"
                )
        return backend

    def init_state(self, batch: int | tuple[int, ...] | None = None) -> tuple:
        """(neuron state, previous-step spikes); batched when ``batch`` set.

        In fabric mode the carry gains the delay line: with the ring (the
        default) elements 3 and 4 are the time-wheel ring ``[..., max_delay
        + 1, n_clusters, K]`` and its shared 0-dim int32 cursor; with
        ``fabric_options={"ring": False}`` element 3 is the roll-carried
        in-flight buffer ``[..., max_delay, nc, K]``.
        """
        lead = () if batch is None else (batch,) if isinstance(batch, int) else tuple(batch)
        carry = (
            neuron_mod.init_state(self.n_neurons, self.params, batch=batch, device=self.device),
            torch.zeros((*lead, self.n_neurons), dtype=torch.float32, device=self.device),
        )
        if self.fabric_backend is None:
            return carry
        if self.fabric_ring:
            ring, cursor = self.fabric_backend.init_ring(
                self.n_clusters, self.k_tags, batch=batch, device=self.device
            )
            return (*carry, ring, cursor)
        inflight = self.fabric_backend.init_inflight(
            self.n_clusters, self.k_tags, batch=batch, device=self.device
        )
        return (*carry, inflight)

    def _as_input(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def step(self, carry, input_activity, i_ext=None):
        """One fabric timestep.

        ``input_activity [..., n_clusters, K]`` (numpy or tensor) is this
        step's external tag activity. Returns ``(carry, spikes)``, or
        ``(carry, (spikes, DeliveryStats))`` when the engine was built with
        ``queue_capacity`` or in fabric mode (which always reports its drops,
        hops, latency and energy).

        The returned carry holds new tensors; the carry passed in is never
        updated in place and stays readable (``repro``'s ``donate_carry``
        has no counterpart here).
        """
        dtype = carry[1].dtype
        input_activity = self._as_input(input_activity, dtype)
        if i_ext is not None:
            i_ext = self._as_input(i_ext, dtype)
        t = self.tables
        if self.fabric_ring:
            state, prev_spikes, ring, cursor = carry
            drive, ring, cursor, stats = self.fabric_backend.deliver_fabric_ring(
                prev_spikes, self._fabric_entries, t.cam_tag, t.cam_syn,
                self.cluster_size, self.k_tags, ring, cursor,
                external_activity=input_activity, queue_capacity=self.queue_capacity,
                syn_onehot=t.cam_syn_onehot,
            )
            state, spikes = neuron_mod.neuron_step(state, drive, self.params, i_ext)
            return (state, spikes, ring, cursor), (spikes, stats)
        if self.fabric_backend is not None:
            state, prev_spikes, inflight = carry
            drive, inflight, stats = self.fabric_backend.deliver_fabric(
                prev_spikes, t.src_tag, t.src_dest, t.cam_tag, t.cam_syn,
                self.cluster_size, self.k_tags, inflight=inflight,
                external_activity=input_activity, queue_capacity=self.queue_capacity,
                syn_onehot=t.cam_syn_onehot,
            )
            state, spikes = neuron_mod.neuron_step(state, drive, self.params, i_ext)
            return (state, spikes, inflight), (spikes, stats)
        state, prev_spikes = carry
        drive, stats = self.backend.deliver(
            prev_spikes,
            t.src_tag,
            t.src_dest,
            t.cam_tag,
            t.cam_syn,
            self.cluster_size,
            self.k_tags,
            external_activity=input_activity,
            queue_capacity=self.queue_capacity,
            syn_onehot=t.cam_syn_onehot,
            with_stats=True,
        )
        state, spikes = neuron_mod.neuron_step(state, drive, self.params, i_ext)
        out = spikes if self.queue_capacity is None else (spikes, stats)
        return (state, spikes), out

    def reset_slots(self, carry, mask):
        """Per-slot state surgery for multi-tenant serving.

        ``mask`` is a boolean array over the carry's leading batch dims
        (``True`` = wipe that slot). Masked slots go back to the fresh state
        of :meth:`init_state` (neuron state at rest, previous-step spikes
        cleared and, in fabric mode, the slot's whole ring or in-flight
        buffer zeroed, so a departing tenant's events in transit never reach
        the next occupant); unmasked slots are untouched, bit for bit. The
        ring cursor is shared by all slots and passes through unchanged:
        zeroing a slot's whole ring is phase-independent.
        """
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=self.device)
        if mask.ndim < 1:
            raise ValueError("reset_slots needs a batched carry (mask per slot)")
        lead = tuple(carry[1].shape[: mask.ndim])
        if tuple(mask.shape) != lead:
            raise ValueError(
                f"reset mask shape {tuple(mask.shape)} does not match the "
                f"carry's slot dims {lead} — a mis-sized mask must raise, "
                "not broadcast (it would wipe the wrong tenants)"
            )
        fresh = self.init_state(batch=tuple(mask.shape))
        return reset_slots(carry, mask, fresh)

    def run(self, carry, input_events, i_ext=None):
        """Step T times; returns ``(final carry, spikes [T, ..., N])`` — with
        ``queue_capacity`` set or in fabric mode, ``(final carry, (spikes
        [T, ..., N], DeliveryStats stacked over T))``.

        ``i_ext`` may be time-varying: a ``[T, ..., N]`` current (one more
        leading axis than the spike state, first axis of length ``T``) is
        stepped alongside ``input_events``. Anything of the spike state's
        rank or below is a per-step constant.

        Over zero steps the carry comes back as it was, with empty stacks
        ``[0, ...]`` of each output's per-step shape and dtype, as
        ``repro``'s ``lax.scan`` returns them. Those shapes are read off one
        step taken on zero input and discarded (a step never updates the
        carry it is given), so on the card that step launches its kernels.
        """
        t_steps = input_events.shape[0]
        i_shape = () if i_ext is None else tuple(np.shape(i_ext))
        time_varying = len(i_shape) == carry[1].ndim + 1 and i_shape[0] == t_steps
        outs = []
        for t in range(t_steps):
            carry, out = self.step(
                carry, input_events[t], i_ext[t] if time_varying else i_ext
            )
            outs.append(out)
        if t_steps == 0:
            zeros = torch.zeros(tuple(input_events.shape[1:]), dtype=carry[1].dtype)
            outs.append(self.step(carry, zeros, None if time_varying else i_ext)[1])
        if self.queue_capacity is None and self.fabric_backend is None:
            return carry, torch.stack(outs)[:t_steps]
        spikes = torch.stack([s for s, _ in outs])[:t_steps]
        stats = DeliveryStats(**{
            f.name: None if getattr(outs[0][1], f.name) is None
            else torch.stack([getattr(st, f.name) for _, st in outs])[:t_steps]
            for f in dataclasses.fields(DeliveryStats)
        })
        return carry, (spikes, stats)


def reset_slots(carry, mask: torch.Tensor, fresh):
    """Replace masked slots of ``carry`` with the matching slots of ``fresh``.

    ``carry`` and ``fresh`` are tuples of tensors and :class:`NeuronState`s
    of identical shapes whose leading dims start with ``mask``'s shape. Kept
    standalone so custom serving loops can splice any per-slot state.
    """

    def sel(cur, new):
        if cur.ndim < mask.ndim:
            return cur
        if tuple(cur.shape[: mask.ndim]) != tuple(mask.shape):
            raise ValueError(
                f"mask shape {tuple(mask.shape)} does not match carry leaf "
                f"slot dims {tuple(cur.shape[: mask.ndim])} — refusing to "
                "broadcast a mis-sized mask across slots"
            )
        m = mask.reshape(mask.shape + (1,) * (cur.ndim - mask.ndim))
        return torch.where(m, new.to(cur.dtype), cur)

    def leaf(cur, new):
        if isinstance(cur, NeuronState):
            return NeuronState(
                **{f.name: sel(getattr(cur, f.name), getattr(new, f.name))
                   for f in dataclasses.fields(NeuronState)}
            )
        return sel(cur, new)

    return tuple(leaf(c, f) for c, f in zip(carry, fresh, strict=True))


def dense_weights_from_tables(tables: RoutingTables) -> np.ndarray:
    """[N, N, 4] dense fan-in counts implied by the routing tables."""
    n = tables.n_neurons
    w = np.zeros((n, n, N_SYN_TYPES), dtype=np.float32)
    for src, dst, syn in tables.dense_equivalent():
        w[dst, src, syn] += 1.0
    return w


def dense_reference_step(
    dense_w: torch.Tensor,  # [N, N, 4]
    prev_spikes: torch.Tensor,  # [..., N]
    state: NeuronState,
    params: NeuronParams,
    external_drive: torch.Tensor | None = None,  # [..., N, 4]
    i_ext: torch.Tensor | None = None,
):
    """Oracle step: dense matmul delivery instead of two-stage routing."""
    drive = torch.einsum("dst,...s->...dt", dense_w, prev_spikes)
    if external_drive is not None:
        drive = drive + external_drive
    return neuron_mod.neuron_step(state, drive, params, i_ext)
