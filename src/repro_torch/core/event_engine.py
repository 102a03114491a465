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

``backend="auto"`` measures the dense / queued / fused crossover on the
engine's device (``dispatch.autotune_backend``) or honors an injected
``AutotuneDecision``, and builds the winner (on the card through a kernel
backend, never the plain stage 2); a ``dense`` winner bypasses the AER
queue compaction while keeping the ``(spikes, stats)`` output.

``EventEngine.reset_slots(carry, mask)`` restores masked slots to fresh
state so a session pool can admit and evict tenants independently;
``extract_slots`` / ``splice_slots`` move slots' full runtime state (the
fabric delay line included) between engines as a host-side
:class:`SlotCarry`. A fabric built with ``faults`` (a ``FaultSpec``) severs
the same SRAM entries on the ring and the roll path.

Multi-device (DESIGN.md §2, §17): :meth:`EventEngine.make_sharded_step`
runs the step over a single-process :class:`~repro_torch.distributed.mesh.DeviceMesh`
(clusters over one axis, batch slots over another): each cell routes its
own neuron slab, the stage-1 partial activity (or, on the fabric, the
routed delay-line buffer) is reduce-scattered to the cluster slabs' owners,
and each cell's stage 2 runs the ``cam_match`` kernel.
:class:`ShardedEventEngine` is an engine whose ``step`` runs that way over
its own ``("data", "model")`` mesh, the carry staying whole on the mesh's
first device.

Multi-model residency (DESIGN.md §16): :class:`ModelRegistry` lays several
compiled networks out as disjoint slabs of one table, and one engine serves
them all; on the fabric ring its entry table is built slab by slab
(``entry_slabs``). :func:`slice_slot_carry` / :func:`embed_slot_carry` move a
slot's state across a change of the slab layout.

``dense_reference_step`` is the oracle: the same network as one dense
``[N, N, 4]`` connectivity tensor.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core import neuron as neuron_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch import (
    DeliveryStats,
    DispatchBackend,
    FabricBackend,
    advance_inflight,
    autotune_backend,
    get_backend,
    served_backend,
    sharded_local_deliver,
)
from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.core.routing import Fabric, default_tile_of_cluster
from repro_torch.core.tags import RoutingTables, TableSlab, concat_tables
from repro_torch.core.tracing import span
from repro_torch.core.two_stage import (
    N_SYN_TYPES,
    compact_events,
    precompute_syn_onehot,
    stage1_route_events_fabric,
)
from repro_torch.distributed.mesh import (
    AXES,
    DeviceMesh,
    NamedSharding,
    P,
    make_mesh,
    named,
    psum,
    psum_scatter,
    tree_map,
)
from repro_torch.kernels.cam_match import ops as cam_ops
from repro_torch.kernels.fabric_deliver.ref import _pop_cursor_slot

__all__ = [
    "EventEngine",
    "ShardedEventEngine",
    "DeliveryStats",
    "SlotCarry",
    "ModelRegistry",
    "embed_slot_carry",
    "reset_slots",
    "slice_slot_carry",
    "dense_weights_from_tables",
    "dense_reference_step",
]


@dataclasses.dataclass
class SlotCarry:
    """Host-side serialization of a set of batch slots' full runtime state.

    Produced by :meth:`EventEngine.extract_slots`, consumed by
    :meth:`EventEngine.splice_slots`: the unit of session migration between
    engines (DESIGN.md §15). All leaves are numpy with leading dim ``S``
    (the extracted slot count). ``inflight`` is the delay-line state in the
    phase-normalized roll layout (``inflight[:, i]`` holds tag activity
    arriving ``i + 1`` steps after extraction), whether the source engine
    ran the ring or the roll buffer, so a slot can be spliced across
    delivery modes and across engines whose ring cursors disagree. ``None``
    when the source engine had no fabric.
    """

    state: NeuronState  # numpy leaves, each [S, ...]
    spikes: np.ndarray  # [S, N] previous-step spikes
    inflight: np.ndarray | None  # [S, max_delay, n_clusters, K] or None


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
    ``Fabric``, as ``backend_options`` configure the backend ``backend``
    names. The engine runs on ``device`` (CUDA unless the caller asks
    for the CPU). ``entry_slabs`` (each resident model's ``(src_tag,
    src_dest)``, back to back) builds the fabric ring's entry table slab by
    slab; it must span the tables' neurons and applies to the ring only.
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
        autotune: dict | None = None,
        entry_slabs=None,  # several resident models on the ring: [(src_tag_m, src_dest_m)]
        backend_options: dict | None = None,
    ):
        if not isinstance(tables, RoutingTables) and hasattr(tables, "tables"):
            tables = tables.tables  # CompileResult / CompiledArtifact
        self.device = resolve_device(device)
        self.params = params or NeuronParams()
        self.cluster_size = tables.cluster_size
        self.k_tags = tables.k_tags
        self.n_neurons = tables.n_neurons
        self.n_clusters = tables.n_clusters
        if queue_capacity is not None and queue_capacity <= 0:
            raise ValueError(f"queue_capacity must be positive, got {queue_capacity}")
        self.queue_capacity = queue_capacity
        self.autotune_decision = None
        self._autotune_dense = False
        if backend == "auto":
            backend = self._autotune(tables, fabric, autotune)
        elif autotune:
            raise ValueError("autotune options require backend='auto'")
        self.backend = get_backend(backend, **(backend_options or {}))
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
        # fault injection (DESIGN.md §15): the per-SRAM-entry survival mask is
        # drawn once, so both delivery paths see the same erasure pattern: the
        # ring path bakes it into FabricEntries.alive, the roll path gathers
        # it per queued event
        self._fault_entry_alive = None
        if self.fabric_backend is not None:
            self._fault_entry_alive = self.fabric_backend.entry_alive_for(
                self.tables.src_tag, self.tables.src_dest, self.cluster_size
            )
        # ring mode (DESIGN.md §14): a static per-SRAM-entry table, built once
        self.fabric_ring = self.fabric_backend is not None and self.fabric_backend.ring
        self._fabric_entries = None
        if self.fabric_ring and entry_slabs is not None:
            # multi-model residency (DESIGN.md §16): the entry table assembled
            # slab by slab, equal to the build from the concatenated table
            n_total = sum(len(st) for st, _ in entry_slabs)
            if n_total != self.n_neurons:
                raise ValueError(
                    f"entry_slabs span {n_total} neurons, tables have {self.n_neurons}"
                )
            self._fabric_entries = self.fabric_backend.build_entries_slabs(
                entry_slabs, self.cluster_size, self.k_tags, device=self.device
            )
        elif self.fabric_ring:
            self._fabric_entries = self.fabric_backend.build_entries(
                tables.src_tag, tables.src_dest, self.cluster_size, self.k_tags,
                device=self.device, entry_alive=self._fault_entry_alive,
            )
        elif entry_slabs is not None:
            raise ValueError("entry_slabs only applies to the fabric ring fast path")

    def _autotune(self, tables, fabric, autotune) -> str:
        """Resolve ``backend="auto"``: measure (or take the injected
        decision), record it, and return the registry name that serves the
        winner on this engine's device (:func:`served_backend`)."""
        if fabric is not None:
            raise ValueError(
                "backend='auto' tunes the dense/queued/fused dispatch "
                "path; fabric engines deliver through the fabric model — "
                "pass an explicit backend"
            )
        opts = dict(autotune or {})
        decision = opts.pop("decision", None)
        if decision is None:
            opts.setdefault("queue_capacity", self.queue_capacity)
            opts.setdefault("device", self.device)
            decision = autotune_backend(
                tables.src_tag, tables.src_dest, tables.cam_tag, tables.cam_syn,
                self.cluster_size, self.k_tags, **opts,
            )
        elif opts:
            raise ValueError(
                "autotune={'decision': ...} is exclusive with tuning "
                f"options {sorted(opts)}"
            )
        self.autotune_decision = decision
        self._autotune_dense = bool(decision.dense)
        return served_backend(decision.backend, self.device)

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
        """``x`` as a ``dtype`` tensor on the engine's device. Host data
        bound for the card goes through pinned memory, an upload the host
        does not wait on (one from pageable memory waits for the device)."""
        t = torch.as_tensor(x, dtype=dtype)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

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
        with span("repro_torch.step"):
            dtype = carry[1].dtype
            input_activity = self._as_input(input_activity, dtype)
            if i_ext is not None:
                i_ext = self._as_input(i_ext, dtype)
            with span("repro_torch.deliver"):
                drive, tail, stats = self._deliver(carry, input_activity)
            with span("repro_torch.neuron"):
                state, spikes = neuron_mod.neuron_step(carry[0], drive, self.params, i_ext)
        if self.fabric_backend is None and self.queue_capacity is None:
            return (state, spikes), spikes
        return (state, spikes, *tail), (spikes, stats)

    def _deliver(self, carry, input_activity):
        """This step's delivery of the carried spikes on the engine's path:
        ``(drive, the carry's delay line after it, DeliveryStats)``."""
        t = self.tables
        if self.fabric_ring:
            _, prev_spikes, ring, cursor = carry
            drive, ring, cursor, stats = self.fabric_backend.deliver_fabric_ring(
                prev_spikes, self._fabric_entries, t.cam_tag, t.cam_syn,
                self.cluster_size, self.k_tags, ring, cursor,
                external_activity=input_activity, queue_capacity=self.queue_capacity,
                syn_onehot=t.cam_syn_onehot,
            )
            return drive, (ring, cursor), stats
        if self.fabric_backend is not None:
            _, prev_spikes, inflight = carry
            drive, inflight, stats = self.fabric_backend.deliver_fabric(
                prev_spikes, t.src_tag, t.src_dest, t.cam_tag, t.cam_syn,
                self.cluster_size, self.k_tags, inflight=inflight,
                external_activity=input_activity, queue_capacity=self.queue_capacity,
                syn_onehot=t.cam_syn_onehot, entry_alive=self._fault_entry_alive,
            )
            return drive, (inflight,), stats
        _, prev_spikes = carry
        drive, stats = self.backend.deliver(
            prev_spikes,
            t.src_tag,
            t.src_dest,
            t.cam_tag,
            t.cam_syn,
            self.cluster_size,
            self.k_tags,
            external_activity=input_activity,
            # an autotuned "dense" winner bypasses compaction; the output
            # contract still follows queue_capacity (stats read zero drops)
            queue_capacity=None if self._autotune_dense else self.queue_capacity,
            syn_onehot=t.cam_syn_onehot,
            with_stats=True,
        )
        return drive, (), stats

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

    # ------------------------------------------------------------------
    # Slot migration (DESIGN.md §15): extract_slots / splice_slots generalize
    # reset_slots. Instead of wiping a slot, they serialize its complete
    # runtime state (the fabric delay line included), so surviving sessions
    # can move onto a repaired engine or come back from a checkpoint.
    def _check_slot_index(self, slots, batch: int) -> np.ndarray:
        idx = np.atleast_1d(np.asarray(slots, dtype=np.int64))
        if idx.ndim != 1 or idx.size == 0:
            raise ValueError("slots must be a non-empty 1-D index sequence")
        if np.unique(idx).size != idx.size:
            raise ValueError(f"slots must be unique, got {idx.tolist()}")
        if np.any(idx < 0) or np.any(idx >= batch):
            raise ValueError(
                f"slots {idx.tolist()} out of range for batch size {batch}"
            )
        return idx

    def extract_slots(self, carry, slots) -> SlotCarry:
        """Serialize ``slots``' full per-slot runtime state to the host.

        The carry must bear exactly one leading batch dim (a session pool).
        Ring-mode delay state is phase-normalized on the way out: wheel slot
        ``(cursor + i) % (max_delay + 1)`` holds the events arriving in
        ``i + 1`` steps, so the returned ``inflight[:, i]`` has the roll
        layout and the wheel phase does not travel with the snapshot.
        """
        if carry[1].ndim != 2:
            raise ValueError(
                "extract_slots needs a carry with one leading batch dim, got "
                f"spikes shape {tuple(carry[1].shape)}"
            )
        idx = self._check_slot_index(slots, carry[1].shape[0])
        sel = torch.as_tensor(idx, device=carry[1].device)

        def host(x):
            return x.index_select(0, sel).cpu().numpy()

        state = NeuronState(**{f.name: host(getattr(carry[0], f.name))
                               for f in dataclasses.fields(NeuronState)})
        inflight = None
        if self.fabric_backend is not None:
            if self.fabric_ring:
                ring = carry[2]  # [B, max_delay + 1, nc, K]
                cur = int(carry[3])
                d1 = ring.shape[-3]
                order = torch.as_tensor((cur + np.arange(d1 - 1)) % d1, device=ring.device)
                inflight = ring.index_select(0, sel).index_select(1, order).cpu().numpy()
            else:
                inflight = host(carry[2])
        return SlotCarry(state=state, spikes=host(carry[1]), inflight=inflight)

    def splice_slots(self, carry, slots, sc: SlotCarry):
        """Write ``sc``'s serialized slots into ``carry`` at ``slots``.

        The inverse of :meth:`extract_slots`, on this engine's carry; the
        source engine may differ (migration onto a repaired placement, or a
        restore into a fresh pool). Neuron count, cluster count and K must
        match. Delay-line contents are re-bucketed when the two engines'
        ``max_delay`` differ: shorter horizons gain zero tail slots; longer
        horizons fold the excess tail into the last slot (events arrive
        earlier than on the source fabric: best effort; the exchange is
        bit-exact when the horizons agree). Returns a new carry; unlisted
        slots are untouched bit for bit.
        """
        spikes_t = carry[1]
        if spikes_t.ndim != 2:
            raise ValueError(
                "splice_slots needs a carry with one leading batch dim, got "
                f"spikes shape {tuple(spikes_t.shape)}"
            )
        idx = self._check_slot_index(slots, spikes_t.shape[0])
        sp = np.asarray(sc.spikes)
        if sp.shape[0] != idx.size:
            raise ValueError(f"{idx.size} slots but SlotCarry holds {sp.shape[0]}")
        if sp.shape[-1] != self.n_neurons:
            raise ValueError(
                f"SlotCarry has {sp.shape[-1]} neurons, engine has {self.n_neurons}"
            )
        sel = torch.as_tensor(idx, device=spikes_t.device)

        def put(cur, new, what):
            new = torch.as_tensor(np.asarray(new), dtype=cur.dtype, device=cur.device)
            want = (idx.size, *cur.shape[1:])
            if tuple(new.shape) != want:
                raise ValueError(
                    f"SlotCarry {what} shape {tuple(new.shape)} != "
                    f"expected {want} — a mismatched leaf must raise, not "
                    "broadcast into the pool"
                )
            return cur.index_copy(0, sel, new)

        state = NeuronState(**{
            f.name: put(getattr(carry[0], f.name), getattr(sc.state, f.name), "state leaf")
            for f in dataclasses.fields(NeuronState)
        })
        spikes = put(spikes_t, sp, "spikes")
        if self.fabric_backend is None:
            if sc.inflight is not None and np.any(np.asarray(sc.inflight)):
                raise ValueError(
                    "SlotCarry holds in-flight fabric events but the target "
                    "engine has no fabric delay line to receive them"
                )
            return (state, spikes)
        d_t = self.fabric_model.max_delay
        if sc.inflight is None:
            inflight = np.zeros((idx.size, d_t, self.n_clusters, self.k_tags), np.float32)
        else:
            inflight = np.asarray(sc.inflight)
            if inflight.shape[-2:] != (self.n_clusters, self.k_tags):
                raise ValueError(
                    f"SlotCarry in-flight grid {inflight.shape[-2:]} != "
                    f"engine ({self.n_clusters}, {self.k_tags})"
                )
            d_s = inflight.shape[1]
            if d_s > d_t:  # fold the excess tail into the last live slot
                if d_t == 0:
                    if np.any(inflight):
                        raise ValueError(
                            "target engine has no delay line (max_delay=0) "
                            "but the SlotCarry holds in-flight events"
                        )
                    inflight = inflight[:, :0]
                else:
                    inflight = np.concatenate(
                        [inflight[:, : d_t - 1],
                         inflight[:, d_t - 1:].sum(axis=1, keepdims=True)],
                        axis=1,
                    )
            elif d_s < d_t:
                pad = np.zeros((idx.size, d_t - d_s, *inflight.shape[2:]), inflight.dtype)
                inflight = np.concatenate([inflight, pad], axis=1)
        if self.fabric_ring:
            ring, cursor = carry[2], carry[3]
            cur = int(cursor)
            d1 = d_t + 1
            rows = np.zeros((idx.size, d1, *inflight.shape[2:]), inflight.dtype)
            rows[:, (cur + np.arange(d_t)) % d1] = inflight
            return (state, spikes, put(ring, rows, "ring"), cursor)
        return (state, spikes, put(carry[2], inflight, "in-flight buffer"))

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
        with span("repro_torch.run"):
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

    # ------------------------------------------------------------------
    # Multi-device (DESIGN.md §2): the step over a single-process mesh
    def _cell_tables(self, tables: _Tables, mesh: DeviceMesh, axis: str) -> dict:
        """Each mesh cell's rows of ``tables`` (its cluster slab), contiguous
        on the cell's device; cells on one device with one slab share them.
        Built once per engine and mesh, not per step."""
        rows = NamedSharding(mesh, P(axis))
        by_slab, out = {}, {}
        for cell in mesh.cells():
            dev = mesh.device(cell)
            key = (dev, mesh.index(cell, axis))
            if key not in by_slab:
                by_slab[key] = _Tables(**{
                    f.name: rows.slab(getattr(tables, f.name), cell).to(dev).contiguous()
                    for f in dataclasses.fields(_Tables)
                })
            out[cell] = by_slab[key]
        return out

    def make_sharded_step(self, mesh: DeviceMesh, axis: str = "data",
                          batch_axis: str | None = None):
        """The engine step with clusters sharded over mesh axis ``axis``.

        Neurons, CAM tables and neuron state are cut by cluster slab; each
        cell's stage-1 partial activity is reduce-scattered across the
        ``axis`` group (the R2/R3 point-to-point hop), and stage 2 (on the
        ``cam_match`` kernel) and the dynamics are local to the cell. With
        ``batch_axis`` the mesh is 2-D: event streams shard over it (pure
        data parallelism) and every carried tensor bears a leading batch dim.
        The carry passed in stays whole on its device; each step cuts it
        into the cells' slabs (views on that device, copies elsewhere) and
        joins the results back onto it. Each cell's tables are cut once,
        here.

        The returned function has ``repro``'s flat signature: ``(tables,
        state, prev_spikes, input_activity, i_ext) -> (state, spikes)``, and
        with the engine's ``queue_capacity`` set (each cell compacts its slab
        through its own AER FIFO of ``ceil(Q / n_dev)`` slots) ``(state,
        spikes, dropped)``, ``dropped`` summed fabric-wide.

        In fabric mode each cell owns a contiguous slab of whole *tiles* (a
        placement that splits a tile across cells raises), per-link FIFO
        arbitration runs where the events originate (exact, since a
        directed link's traffic all comes from one cell), and the step is
        ``(tables, state, prev_spikes, inflight, input_activity, i_ext) ->
        (state, spikes, inflight, DeliveryStats)`` with the in-flight buffer
        cut over its cluster axis and the stats summed fabric-wide; on the
        ring (the default) ``(tables, state, prev_spikes, ring, cursor,
        input_activity, i_ext) -> (state, spikes, ring, cursor,
        DeliveryStats)``, the scalar cursor replicated. The sharded fabric
        step routes with ``stage1_route_events_fabric`` and a
        reduce-scatter, as ``repro``'s does, not with ``fabric_deliver``.
        """
        n_dev = mesh.shape[axis]
        if self.n_clusters % n_dev:
            raise ValueError("clusters must divide device axis")
        queue_capacity = self.queue_capacity
        if queue_capacity is not None:  # per-core FIFO: split capacity by slab
            queue_capacity = max(1, -(-queue_capacity // n_dev))
        if self.fabric_backend is not None:
            if self.fabric_backend.faults is not None:
                raise NotImplementedError(
                    "fault injection is not supported by the sharded fabric "
                    "step — run faulted scenarios single-device (DESIGN.md §15)"
                )
            return self._make_sharded_fabric_step(mesh, axis, batch_axis, n_dev,
                                                   queue_capacity)
        params, cluster_size = self.params, self.cluster_size
        n_clusters, k_tags = self.n_clusters, self.k_tags
        own = self._cell_tables(self.tables, mesh, axis)
        by_cell = NamedSharding(mesh, P(axis) if batch_axis is None else P(batch_axis, axis))
        per_batch = NamedSharding(mesh, P() if batch_axis is None else P(batch_axis))

        def step(tables, state, prev_spikes, input_activity, i_ext=None):
            cells = own if tables is self.tables else self._cell_tables(tables, mesh, axis)
            home = prev_spikes.device
            inp, ie = _broadcast_inputs(prev_spikes, input_activity, i_ext)
            st, spk = _shard_state(by_cell, state), by_cell.shard(prev_spikes)
            xin, xie = by_cell.shard(inp), by_cell.shard(ie)
            out_state, out_spikes, out_drop = {}, {}, {}
            for group in mesh.groups(axis):
                drives, dropped = sharded_local_deliver(
                    [spk[c] for c in group],
                    *([getattr(cells[c], name) for c in group]
                      for name in ("src_tag", "src_dest", "cam_tag", "cam_syn")),
                    cluster_size, n_clusters, k_tags,
                    external_activity=[xin[c] for c in group],
                    queue_capacity=queue_capacity, with_stats=True,
                )
                for c, drive, d in zip(group, drives, dropped):
                    out_state[c], out_spikes[c] = neuron_mod.neuron_step(st[c], drive, params, xie[c])
                    out_drop[c] = d
            state = _unshard_state(by_cell, out_state, home)
            spikes = by_cell.unshard(out_spikes, home)
            if queue_capacity is None:
                return state, spikes
            return state, spikes, per_batch.unshard(out_drop, home)

        return step

    def _make_sharded_fabric_step(self, mesh, axis, batch_axis, n_dev, queue_capacity):
        """Fabric-mode sharded step: tiles -> cells (see make_sharded_step)."""
        params, cluster_size = self.params, self.cluster_size
        n_clusters, k_tags = self.n_clusters, self.k_tags
        nc_local = n_clusters // n_dev
        model = self.fabric_backend.model_for(n_clusters)
        # the device mesh mirrors the chip mesh only if no tile straddles a
        # cell boundary — every link's traffic then originates on exactly
        # one cell and per-cell FIFO arbitration is globally exact
        slab_of_cluster = np.arange(n_clusters) // nc_local
        for t in np.unique(model.tile_of_cluster):
            devs = np.unique(slab_of_cluster[model.tile_of_cluster == t])
            if devs.size > 1:
                raise ValueError(
                    f"tile {t} is split across devices {devs.tolist()}: fabric-"
                    "sharded execution needs each tile's clusters on one device "
                    "(use the hierarchical linear placement or re-shard)"
                )
        own = self._cell_tables(self.tables, mesh, axis)
        arrs = {cell: self.fabric_backend.arrays_for(n_clusters, mesh.device(cell))
                for cell in mesh.cells()}
        per_link = self.fabric_backend.per_link_stats
        d1 = model.max_delay + 1
        if batch_axis is None:
            spec_c, spec_f, spec_d = P(axis), P(None, axis), P()
        else:
            spec_c, spec_f, spec_d = P(batch_axis, axis), P(batch_axis, None, axis), P(batch_axis)
        by_cell, by_line = NamedSharding(mesh, spec_c), NamedSharding(mesh, spec_f)
        per_batch, replicated = NamedSharding(mesh, spec_d), NamedSharding(mesh, P())
        stat_fields = [f.name for f in dataclasses.fields(DeliveryStats)]

        def route_group(cells, group, spk, cur):
            """Stage 1 of one ``axis`` group: each cell compacts and routes
            its slab; the routed buffers are reduce-scattered to the cluster
            slabs' owners and the stats summed over the group."""
            bufs, parts = [], []
            for c in group:
                t, a = cells[c], arrs[c]
                capacity = spk[c].shape[-1] if queue_capacity is None else queue_capacity
                queue = compact_events(spk[c], capacity)
                route = stage1_route_events_fabric(
                    queue, t.src_tag, t.src_dest, n_clusters, k_tags, cluster_size,
                    a["cluster_tile"], a["delay_steps"], model.n_tiles, model.max_delay,
                    model.link_capacity, mesh_hops=a["mesh_hops"], latency_s=a["latency_s"],
                    energy_j=a["energy_j"], src_cluster_offset=mesh.index(c, axis) * nc_local,
                    cursor=None if cur is None else cur[c], per_link_stats=per_link,
                )
                bufs.append(route.buffer)
                parts.append((queue.dropped, route.link_dropped, route.delivered, route.hops,
                              route.latency_s, route.energy_j))
            # hand every (delay, cluster) slab to its owner: the R3 hop. With
            # per_link_stats the link / pair counters carry a trailing bin
            # axis; the elementwise sum treats both shapes alike
            local = psum_scatter(bufs, dim=-2)
            summed = [psum(list(field)) for field in zip(*parts)]
            return local, [DeliveryStats(*(s[j] for s in summed)) for j in range(len(group))]

        def run(tables, state, prev_spikes, line, cursor, input_activity, i_ext):
            cells = own if tables is self.tables else self._cell_tables(tables, mesh, axis)
            home = prev_spikes.device
            inp, ie = _broadcast_inputs(prev_spikes, input_activity, i_ext)
            st, spk = _shard_state(by_cell, state), by_cell.shard(prev_spikes)
            xin, xie, lines = by_cell.shard(inp), by_cell.shard(ie), by_line.shard(line)
            cur = None if cursor is None else replicated.shard(cursor)
            out_state, out_spikes, out_line, out_stats = {}, {}, {}, {}
            for group in mesh.groups(axis):
                local, stats = route_group(cells, group, spk, cur)
                for c, buf, s in zip(group, local, stats):
                    if cur is None:
                        a, out_line[c] = advance_inflight(buf, lines[c], model.max_delay)
                    else:
                        # the wheel step: accumulate this step's arrivals
                        # (already cursor-rotated by stage 1), pop and clear
                        # the cursor slot
                        a, out_line[c] = _pop_cursor_slot(lines[c] + buf, cur[c])
                    drive = cam_ops.cam_match((a + xin[c]).contiguous(), cells[c].cam_tag,
                                              cells[c].cam_syn, cluster_size)
                    out_state[c], out_spikes[c] = neuron_mod.neuron_step(st[c], drive, params,
                                                                        xie[c])
                    out_stats[c] = s
            stats = DeliveryStats(**{
                name: per_batch.unshard({c: getattr(s, name) for c, s in out_stats.items()}, home)
                for name in stat_fields
            })
            return (_unshard_state(by_cell, out_state, home), by_cell.unshard(out_spikes, home),
                    by_line.unshard(out_line, home), stats)

        if self.fabric_ring:
            def ring_step(tables, state, prev_spikes, ring, cursor, input_activity, i_ext=None):
                state, spikes, ring, stats = run(tables, state, prev_spikes, ring, cursor,
                                                 input_activity, i_ext)
                return state, spikes, ring, (cursor + 1) % d1, stats

            return ring_step

        def roll_step(tables, state, prev_spikes, inflight, input_activity, i_ext=None):
            return run(tables, state, prev_spikes, inflight, None, input_activity, i_ext)

        return roll_step


def _broadcast_inputs(prev_spikes, input_activity, i_ext):
    """The step's external tag activity and current at the carry's batch
    shape (a vacant ``i_ext`` is zeros)."""
    lead = prev_spikes.shape[:-1]
    inp = torch.broadcast_to(input_activity, (*lead, *input_activity.shape[-2:]))
    ie = torch.zeros_like(prev_spikes) if i_ext is None else torch.broadcast_to(
        i_ext, prev_spikes.shape)
    return inp, ie


def _shard_state(sharding: NamedSharding, state: NeuronState) -> dict:
    leaves = {f.name: sharding.shard(getattr(state, f.name)) for f in dataclasses.fields(NeuronState)}
    return {cell: NeuronState(**{k: v[cell] for k, v in leaves.items()})
            for cell in sharding.mesh.cells()}


def _unshard_state(sharding: NamedSharding, parts: dict, device) -> NeuronState:
    return NeuronState(**{
        f.name: sharding.unshard({c: getattr(s, f.name) for c, s in parts.items()}, device)
        for f in dataclasses.fields(NeuronState)
    })


class ShardedEventEngine(EventEngine):
    """:class:`EventEngine` whose step runs over a single-process device mesh.

    The engine owns a 2-D :class:`~repro_torch.distributed.mesh.DeviceMesh`
    named ``("data", "model")``: batch slots (tenants) shard over ``data``
    and clusters (tiles) over ``model``, one serving shard of a
    ``ShardedSessionPool`` (serve/sharded.py, DESIGN.md §17). The public
    step contract is unchanged (``step(carry, input_activity, i_ext) ->
    (carry, (spikes, stats))``) and the carry stays whole on the mesh's
    first device, so session pools, slot surgery (``reset_slots`` /
    ``extract_slots`` / ``splice_slots``) and checkpointing work on it
    untouched; only the step runs through
    :meth:`EventEngine.make_sharded_step`, every cell's stage 2 on the
    ``cam_match`` kernel. Queued engines always report a
    :class:`DeliveryStats` (drops summed fabric-wide), matching the
    ``queue_capacity`` contract of the local engine.

    ``devices=None`` takes the first ``batch_devices * cluster_devices``
    distinct visible devices of ``device``'s type (the card by default) and
    raises if there are fewer; an explicit ``devices`` list may name one
    device more than once (several cells on one card). Constraints of the
    sharded step: the carry must be batched and the batch must divide over
    ``batch_devices``; ``n_clusters`` must divide over ``cluster_devices``;
    in fabric mode the placement must keep every tile's clusters inside one
    cell's slab (:func:`repro_torch.core.compiler.device_slab_placement`
    builds such placements) and fault injection is refused. A ``(1, 1)``
    mesh is valid: serving code paths are then identical with or without
    more devices.
    """

    def __init__(
        self,
        tables,
        params: NeuronParams | None = None,
        *,
        devices=None,
        cluster_devices: int = 1,
        batch_devices: int = 1,
        device: torch.device | str = "cuda",
        **engine_kw,
    ):
        if cluster_devices <= 0 or batch_devices <= 0:
            raise ValueError(
                f"mesh extents must be positive, got {batch_devices} x {cluster_devices}"
            )
        mesh = make_mesh((batch_devices, cluster_devices), AXES, devices=devices, device=device)
        super().__init__(tables, params, device=mesh.home, **engine_kw)
        if self.n_clusters % cluster_devices:
            raise ValueError(
                f"{self.n_clusters} clusters do not divide over {cluster_devices} "
                "cluster devices"
            )
        self.mesh = mesh
        self.cluster_devices = cluster_devices
        self.batch_devices = batch_devices
        # placement and tile-split errors surface here, at construction
        self._sharded = self.make_sharded_step(mesh, "model", batch_axis="data")

    def step(self, carry, input_activity, i_ext=None):
        dtype = carry[1].dtype
        inp = self._as_input(input_activity, dtype)
        ie = None if i_ext is None else self._as_input(i_ext, dtype)
        if self.fabric_ring:
            state, spikes, ring, cursor, stats = self._sharded(self.tables, *carry, inp, ie)
            return (state, spikes, ring, cursor), (spikes, stats)
        if self.fabric_backend is not None:
            state, spikes, inflight, stats = self._sharded(self.tables, *carry, inp, ie)
            return (state, spikes, inflight), (spikes, stats)
        out = self._sharded(self.tables, *carry, inp, ie)
        if self.queue_capacity is None:
            return (out[0], out[1]), out[1]
        state, spikes, dropped = out
        return (state, spikes), (spikes, DeliveryStats(dropped=dropped))

    def carry_pspecs(self):
        """:class:`~repro_torch.distributed.mesh.PartitionSpec` tree of a
        batched carry under this engine's mesh, ``repro``'s tree:
        neuron-state leaves and spikes shard ``[B, N]`` over ``(data,
        model)``, fabric delay lines shard clusters (``[B, D, nc, K]`` over
        ``(data, None, model)``) and the ring's cursor is replicated. Feed
        it through ``distributed.mesh.named`` into
        ``Checkpointer.restore(shardings=...)``, or to
        ``distributed.elastic.reshard_tree``, to land a carry on the mesh."""
        spec_c = P("data", "model")
        state = NeuronState(spec_c, spec_c, spec_c, spec_c)
        if self.fabric_backend is None:
            return (state, spec_c)
        spec_f = P("data", None, "model")
        if self.fabric_ring:
            return (state, spec_c, spec_f, P())
        return (state, spec_c, spec_f)

    def place_carry(self, carry):
        """``carry`` (tensors on any device, or numpy) placed on this
        engine's mesh per :meth:`carry_pspecs`: checked against the specs
        and moved to the mesh's first device. Splice and restore surgery
        build host-side or foreign-device leaves; this lands them where the
        next step reads them."""
        return tree_map(lambda s, x: s.place(x), named(self.mesh, self.carry_pspecs()), carry,
                        is_leaf=lambda s: isinstance(s, NamedSharding))


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


# ---------------------------------------------------------------------------
# Multi-model residency (DESIGN.md §16)
# ---------------------------------------------------------------------------
def slice_slot_carry(sc: SlotCarry, slab: TableSlab) -> SlotCarry:
    """Restrict a :class:`SlotCarry` to one resident model's table slab.

    Neuron-state leaves carry the neuron axis at position 1 (``[S, N]`` /
    ``[S, N, 4]``); the in-flight buffer is cut on the cluster axis and
    narrowed to the slab's own ``k_tags`` (tag activity a model never
    compiled is structurally zero in its slab).
    """
    n0, n1 = slab.neuron_lo, slab.neuron_hi
    state = NeuronState(**{f.name: np.asarray(getattr(sc.state, f.name))[:, n0:n1]
                           for f in dataclasses.fields(NeuronState)})
    inflight = None
    if sc.inflight is not None:
        inflight = np.asarray(sc.inflight)[:, :, slab.cluster_lo:slab.cluster_hi, :slab.k_tags]
    return SlotCarry(state=state, spikes=np.asarray(sc.spikes)[:, n0:n1], inflight=inflight)


def embed_slot_carry(sc_slab: SlotCarry, engine: "EventEngine", slab: TableSlab) -> SlotCarry:
    """Embed a slab-restricted :class:`SlotCarry` into ``engine``'s geometry.

    The inverse of :func:`slice_slot_carry`, for migration onto a pool whose
    slab layout moved. The base is the engine's fresh init, not zeros: a
    zero membrane sits at the firing threshold, and every neuron outside the
    slab would spike on the first step. The in-flight buffer keeps the
    source horizon; :meth:`EventEngine.splice_slots` re-buckets it.
    """
    part = np.asarray(sc_slab.spikes)
    s = part.shape[0]
    if part.shape[-1] != slab.n_neurons:
        raise ValueError(
            f"SlotCarry holds {part.shape[-1]} neurons but the slab spans {slab.n_neurons}"
        )
    base = engine.extract_slots(engine.init_state(batch=s), np.arange(s))
    n0, n1 = slab.neuron_lo, slab.neuron_hi

    def put(full, p):
        full = np.array(full)
        full[:, n0:n1] = p
        return full

    state = NeuronState(**{f.name: put(getattr(base.state, f.name), getattr(sc_slab.state, f.name))
                           for f in dataclasses.fields(NeuronState)})
    spikes = put(base.spikes, part)
    inflight = None
    if engine.fabric_backend is not None:
        if sc_slab.inflight is None:
            inflight = base.inflight
        else:
            src = np.asarray(sc_slab.inflight)
            if src.shape[-2:] != (slab.n_clusters, slab.k_tags):
                raise ValueError(
                    f"SlotCarry in-flight grid {src.shape[-2:]} != slab "
                    f"({slab.n_clusters}, {slab.k_tags})"
                )
            if slab.k_tags > engine.k_tags:
                raise ValueError(f"slab k_tags {slab.k_tags} exceeds engine K {engine.k_tags}")
            inflight = np.zeros((s, src.shape[1], engine.n_clusters, engine.k_tags), np.float32)
            inflight[:, :, slab.cluster_lo:slab.cluster_hi, :slab.k_tags] = src
    elif sc_slab.inflight is not None and np.any(sc_slab.inflight):
        raise ValueError(
            "SlotCarry holds in-flight fabric events but the target engine "
            "has no fabric delay line to receive them"
        )
    return SlotCarry(state=state, spikes=spikes, inflight=inflight)


class ModelRegistry:
    """Ordered set of resident compiled networks sharing one engine (§16).

    Each model keeps its own :class:`RoutingTables`; :meth:`combined`
    concatenates them into disjoint neuron and cluster slabs
    (:func:`~repro_torch.core.tags.concat_tables`). The slab layout follows
    insertion order, so which models are resident, in which order, is the
    whole identity of the combined engine: :meth:`fingerprint` hashes
    exactly that, as ``repro``'s registry does, and checkpoint restore
    compares it.
    """

    def __init__(self, models=None):
        self._models: dict[str, RoutingTables] = {}
        for name, tables in (models or {}).items():
            self.load(name, tables)

    @staticmethod
    def _unwrap(tables) -> RoutingTables:
        # CompileResult / CompiledArtifact / CompiledCnn wrappers
        while hasattr(tables, "tables"):
            tables = tables.tables
        return tables

    def load(self, name: str, tables) -> None:
        if name in self._models:
            raise ValueError(f"model {name!r} already resident")
        tables = self._unwrap(tables)
        for other_name, other in self._models.items():
            if other.cluster_size != tables.cluster_size:
                raise ValueError(
                    f"model {name!r} cluster_size {tables.cluster_size} != "
                    f"resident {other_name!r} cluster_size {other.cluster_size}"
                )
        self._models[name] = tables

    def unload(self, name: str) -> None:
        if name not in self._models:
            raise KeyError(f"model {name!r} is not resident")
        del self._models[name]

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def __len__(self) -> int:
        return len(self._models)

    @property
    def names(self) -> list[str]:
        return list(self._models)

    def tables_of(self, name: str) -> RoutingTables:
        return self._models[name]

    def slabs(self) -> dict[str, TableSlab]:
        """Slab layout by model name, in insertion order."""
        out, n0, c0 = {}, 0, 0
        for name, t in self._models.items():
            out[name] = TableSlab(neuron_lo=n0, neuron_hi=n0 + t.n_neurons, cluster_lo=c0,
                                  cluster_hi=c0 + t.n_clusters, k_tags=t.k_tags)
            n0 += t.n_neurons
            c0 += t.n_clusters
        return out

    def combined(self) -> tuple[RoutingTables, dict[str, TableSlab]]:
        """(combined tables, slab layout by name). A single resident model
        returns its own tables, so a registry of one changes nothing."""
        if not self._models:
            raise ValueError("registry holds no resident models")
        names = list(self._models)
        if len(names) == 1:
            return self._models[names[0]], self.slabs()
        tables, slab_list = concat_tables(list(self._models.values()))
        return tables, dict(zip(names, slab_list))

    def fingerprint(self) -> str:
        """sha256 over (name, table fingerprint) pairs in slab order."""
        h = hashlib.sha256()
        for name, t in self._models.items():
            h.update(name.encode())
            h.update(b"\x00")
            h.update(t.fingerprint().encode())
            h.update(b"\x01")
        return h.hexdigest()


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
    """Oracle step: dense matmul delivery instead of two-stage routing, and
    the neuron step in plain PyTorch operations (``neuron_step_eager``), so
    that on the card it holds the neuron kernel too."""
    drive = torch.einsum("dst,...s->...dt", dense_w, prev_spikes)
    if external_drive is not None:
        drive = drive + external_drive
    return neuron_mod.neuron_step_eager(state, drive, params, i_ext)
