"""Elastic serving over device meshes: a fleet of sharded session pools.

Counterpart of ``repro.serve.sharded``, the fleet layer over serve/aer.py
(DESIGN.md §17). A :class:`ShardedSessionPool` partitions serving capacity
into ``n_shards`` shards; each shard is one
:class:`~repro_torch.serve.aer.AerSessionPool` over its own
:class:`~repro_torch.core.event_engine.ShardedEventEngine`, a ``(batch_devices,
cluster_devices)`` single-process device mesh driving the sharded
fabric-ring (or queued) step, every cell's stage 2 on the ``cam_match``
kernel, with the compiled network's ``device_slabs`` placement mapping whole
tiles onto the cluster axis. Across shards tenants are independent: the
fleet's cross-shard operations are control-plane moves (admission,
migration, recovery), never data-plane hops.

Four layers (the §17 ladder):

  1. **sharded pool**: fixed per-shard slot pools; one fleet ``step()``
     launches every shard's step before collecting any (``begin_step`` /
     ``finish_step``), so the device has every shard's work queued before
     the host waits. Per-shard :class:`DeliveryStats` (already summed over
     each shard's mesh) are summed on the host into fleet metrics
     (:meth:`~ShardedSessionPool.fleet_stats`).
  2. **admission control**: ``submit`` routes a session to the
     least-loaded shard by the compiler's traffic model
     (:func:`~repro_torch.core.compiler.session_rate` of the session's
     model, summed over each shard's resident and queued sessions; measured
     rates replace it once the shards' traffic profiles have seen enough),
     with a bounded waiting queue per shard and a typed
     :class:`AdmissionError` when every queue is full.
  3. **live migration**: ``migrate`` moves a mid-flight tenant between
     shards (different meshes included) via ``extract_session`` /
     ``inject_session``: neuron state, undelivered spikes and the
     phase-normalized time-wheel slab splice at the destination's cursor
     phase, bit-exact when the shards share tables and delay horizon.
     ``drain_shard`` empties a shard for maintenance.
  4. **elastic restart**: ``checkpoint`` writes one atomic fleet tree
     (per-shard engine carries + session and queue meta); ``restore``
     rebuilds a fleet onto a *different* shard count (lost shards' sessions
     redistribute into surviving free slots, bit-exact because sessions are
     pure in their own step counter), and ``recover_shard`` rolls a killed
     shard's sessions back to the latest checkpoint and splices them into
     the survivors while their current state keeps serving untouched.

The fleet and its shard engines run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque

import numpy as np
import torch

from repro_torch.core.cnn import CompiledCnn, poker_neuron_params
from repro_torch.core.compiler import device_slab_placement, session_rate
from repro_torch.core.dispatch import DeliveryStats
from repro_torch.core.event_engine import ModelRegistry, ShardedEventEngine, SlotCarry
from repro_torch.core.neuron import NeuronState
from repro_torch.core.routing import Fabric
from repro_torch.core.tags import RoutingTables
from repro_torch.distributed.mesh import tree_map, visible_devices
from repro_torch.serve.aer import (
    AerServeConfig,
    AerSessionPool,
    CheckpointMismatchError,
    DvsSession,
    SessionResult,
    session_from_meta,
)

__all__ = [
    "ShardConfig",
    "AdmissionError",
    "ShardedSessionPool",
    "build_poker_shard_engine",
    "retile_for_slabs",
]


class AdmissionError(RuntimeError):
    """The fleet cannot accept a session: every admissible shard's bounded
    waiting queue is full (or no shard is alive). Backpressure is the
    caller's to handle — retry later or scale out; the fleet never grows an
    unbounded queue."""


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Fleet topology: how many shards, their meshes, and queue bounds.

    Per-shard slot count and decision policy live in the shard pools'
    :class:`~repro_torch.serve.aer.AerServeConfig` (``pool_size`` is per
    shard: fleet capacity is ``n_shards * pool_size``). ``queue_depth``
    bounds each shard's waiting queue; ``cluster_devices`` x
    ``batch_devices`` is one shard's device mesh (clusters over ``model``,
    batch slots over ``data``). When the fleet is given at least
    ``n_shards`` such meshes' worth of devices, shards get disjoint device
    sets; otherwise they share the first mesh's devices (oversubscribed:
    the same results, as on one card).
    """

    n_shards: int = 2
    queue_depth: int = 8
    cluster_devices: int = 1
    batch_devices: int = 1
    backend: str = "reference"  # dispatch backend name, or "fabric"
    # fabric mode only: per-link drop / per-pair delivery attribution — the
    # shards' pools then grow TrafficProfiles and the fleet's admission
    # scoring upgrades to measured rates (DESIGN.md §18)
    per_link_stats: bool = False


def retile_for_slabs(cc: CompiledCnn, n_slabs: int, fabric=None, seed: int = 0):
    """``cc`` with its placement re-annealed under the ``n_slabs`` device-slab
    constraint (:func:`~repro_torch.core.compiler.device_slab_placement`),
    required before fabric-mode shards can split clusters over
    ``cluster_devices > 1`` (every tile's clusters must live on one device).
    """
    placement, _ = device_slab_placement(cc.tables, fabric or Fabric(), n_slabs, seed=seed)
    return dataclasses.replace(
        cc, tables=dataclasses.replace(cc.tables, tile_of_cluster=placement)
    )


def build_poker_shard_engine(
    tables,
    backend: str = "reference",
    *,
    cluster_devices: int = 1,
    batch_devices: int = 1,
    devices=None,
    device: torch.device | str = "cuda",
    entry_slabs=None,
    per_link_stats: bool = False,
) -> ShardedEventEngine:
    """One serving shard's engine at the §V poker operating point.

    The multi-device sibling of :func:`~repro_torch.serve.aer.build_poker_engine`:
    the same neuron parameters and lossless AER queue capacity, but the step
    is a :class:`ShardedEventEngine` over a ``(batch_devices,
    cluster_devices)`` mesh of ``devices`` (default: distinct visible devices
    of ``device``'s type). Fabric mode with ``cluster_devices > 1`` needs
    tables whose placement satisfies the device-slab invariant
    (:func:`retile_for_slabs`); a violating placement raises at
    construction, not mid-serve. ``repro``'s ``donate_carry`` has no
    counterpart.
    """
    params = poker_neuron_params()
    if not isinstance(tables, RoutingTables) and hasattr(tables, "tables"):
        tables = tables.tables
    mesh_kw = dict(
        devices=devices,
        cluster_devices=cluster_devices,
        batch_devices=batch_devices,
        device=device,
        queue_capacity=tables.n_neurons,
    )
    if backend == "fabric":
        fabric_options = {"per_link_stats": True} if per_link_stats else None
        return ShardedEventEngine(tables, params, fabric=Fabric(), entry_slabs=entry_slabs,
                                  fabric_options=fabric_options, **mesh_kw)
    if entry_slabs is not None:
        raise ValueError("entry_slabs only applies to the fabric backend")
    if per_link_stats:
        raise ValueError("per_link_stats only applies to the fabric backend")
    return ShardedEventEngine(tables, params, backend=backend, **mesh_kw)


def _land(pool: AerSessionPool) -> None:
    """Put ``pool``'s carry where its engine steps it: on a sharded engine's
    mesh (``place_carry``), else on the engine's device. Splice and restore
    surgery leave host-side or foreign-device leaves behind."""
    engine = pool.engine
    if isinstance(engine, ShardedEventEngine):
        pool.carry = engine.place_carry(pool.carry)
    else:
        pool.carry = tree_map(lambda x: torch.as_tensor(x).to(engine.device), pool.carry)


class ShardedSessionPool:
    """A fleet of session-pool shards with admission, migration, recovery.

    ``cfg`` is the per-shard :class:`AerServeConfig` (``pool_size`` slots
    per shard); ``shards`` the :class:`ShardConfig` topology. Every shard
    serves the same resident model set: shards are interchangeable
    capacity, which is what makes migration and elastic restart free of
    geometry negotiation. ``engine_factory(shard_id, devices) -> engine``
    overrides shard engine construction (for heterogeneous meshes); the
    default builds :func:`build_poker_shard_engine` on the shard's device
    set. ``devices`` lists the devices to deal out to the shards (it may
    repeat one); by default they are the distinct visible devices of
    ``device``'s type.
    """

    def __init__(
        self,
        cc: CompiledCnn,
        cfg: AerServeConfig,
        shards: ShardConfig,
        *,
        models: dict[str, CompiledCnn] | None = None,
        devices=None,
        device: torch.device | str = "cuda",
        engine_factory=None,
    ):
        if shards.n_shards <= 0:
            raise ValueError(f"n_shards must be positive, got {shards.n_shards}")
        if shards.queue_depth < 0:
            raise ValueError(f"queue_depth must be non-negative, got {shards.queue_depth}")
        self.cfg = cfg
        self.shards = shards
        if shards.backend == "fabric" and shards.cluster_devices > 1 and engine_factory is None:
            if models is not None and len(models) > 1:
                raise NotImplementedError(
                    "multi-model residency with cluster-sharded fabric shards "
                    "needs a caller-built engine_factory (the combined slabs "
                    "must be retiled jointly)"
                )
            cc = retile_for_slabs(cc, shards.cluster_devices)
        self.models: dict[str, CompiledCnn] = dict(models) if models else {"default": cc}
        self._shard_devices = self._assign_devices(devices, device)
        entry_slabs = None
        if len(self.models) == 1:
            eng_tables = next(iter(self.models.values())).tables
        else:
            # multi-model: one engine over the concatenated slabs; in fabric
            # mode the entry table is assembled slab by slab, mirroring
            # AerSessionPool._engine_for
            registry = ModelRegistry({n: m.tables for n, m in self.models.items()})
            eng_tables, _ = registry.combined()
            if shards.backend == "fabric":
                entry_slabs = [(t.src_tag, t.src_dest)
                               for t in (registry.tables_of(n) for n in registry.names)]
        self.pools: list[AerSessionPool | None] = []
        for i in range(shards.n_shards):
            if engine_factory is not None:
                engine = engine_factory(i, self._shard_devices[i])
            else:
                engine = build_poker_shard_engine(
                    eng_tables, shards.backend, cluster_devices=shards.cluster_devices,
                    batch_devices=shards.batch_devices, devices=self._shard_devices[i],
                    entry_slabs=entry_slabs, per_link_stats=shards.per_link_stats,
                )
            pool = AerSessionPool(cc, engine, cfg, models=self.models)
            _land(pool)
            self.pools.append(pool)
        self.queues: list[deque[DvsSession]] = [deque() for _ in range(shards.n_shards)]
        self.dead: set[int] = set()  # killed shards keep their index
        self.n_steps = 0
        # admission scoring: predicted per-session fabric traffic by model
        # (the compiler's traffic model — DESIGN.md §13 driving §17)
        self._rates = {name: session_rate(m.tables) for name, m in self.models.items()}
        # observed per-model rates (§18): shards built with per-link stats
        # feed their traffic profiles back here; once a model has enough
        # observed session-steps the measured delivered/session-step rate
        # replaces the static compiler prediction in admission scoring
        self.observed_min_session_steps = 8
        self._obs_delivered: dict[str, float] = {n: 0.0 for n in self.models}
        self._obs_session_steps: dict[str, int] = {n: 0 for n in self.models}

    def _assign_devices(self, devices, device) -> list[list]:
        per = self.shards.cluster_devices * self.shards.batch_devices
        avail = list(devices) if devices is not None else visible_devices(device)
        n = self.shards.n_shards
        if len(avail) >= n * per:
            return [avail[i * per:(i + 1) * per] for i in range(n)]
        if len(avail) >= per:
            return [avail[:per] for _ in range(n)]
        raise ValueError(f"fleet needs at least {per} devices per shard, have {len(avail)}")

    # -- introspection -----------------------------------------------------
    def live_shards(self) -> list[int]:
        return [i for i in range(self.shards.n_shards) if i not in self.dead]

    @property
    def busy(self) -> bool:
        return any(self.queues[i] or self.pools[i].occupied for i in self.live_shards())

    def occupancy(self) -> dict[int, tuple[int, int]]:
        """Per live shard: (occupied slots, queued sessions)."""
        return {i: (len(self.pools[i].occupied), len(self.queues[i]))
                for i in self.live_shards()}

    def fleet_stats(self) -> DeliveryStats | None:
        """Fleet-level delivery metrics for the most recent step.

        Each shard's stats are already summed over its own device mesh by
        the sharded step; the fleet total is their host-side sum (drops,
        link drops, delivered, hops, latency, energy — ``None`` fields, e.g.
        outside fabric mode, stay ``None``).
        """
        per = [self.pools[i].last_stats for i in self.live_shards()
               if self.pools[i].last_stats is not None]
        if not per:
            return None

        def tot(field):
            vals = [getattr(s, field) for s in per]
            if any(v is None for v in vals):
                return None
            return np.asarray([v.cpu().numpy().sum() for v in vals]).sum()

        return DeliveryStats(**{f.name: tot(f.name) for f in dataclasses.fields(DeliveryStats)})

    def _rate_of(self, sess: DvsSession) -> float:
        """Admission cost of one session: observed rate when measured,
        else the static compiler prediction (two units that only ever rank
        sessions against each other inside one admission decision)."""
        name = sess.model
        if name is None:
            if len(self.models) != 1:
                raise ValueError(
                    "session must name its model when several are resident "
                    f"(have {list(self.models)})"
                )
            name = next(iter(self.models))
        if name not in self._rates:
            raise KeyError(f"model {name!r} is not resident (have {list(self.models)})")
        n = self._obs_session_steps.get(name, 0)
        if n >= self.observed_min_session_steps:
            return self._obs_delivered[name] / n
        return self._rates[name]

    def observed_rates(self) -> dict[str, float | None]:
        """Measured per-model delivered/session-step rates (``None`` below
        the ``observed_min_session_steps`` floor or without per-link stats)."""
        out: dict[str, float | None] = {}
        for name in self.models:
            n = self._obs_session_steps.get(name, 0)
            out[name] = (self._obs_delivered[name] / n
                         if n >= self.observed_min_session_steps else None)
        return out

    def _observe_rates(self, live: list[int]) -> None:
        """Fold the shards' last-step traffic profiles into the per-model
        observed-rate accumulators (slab-sliced: slabs are disjoint and
        arbitration is per batch slot, so a slab's delivered counts belong
        entirely to its model's sessions)."""
        for i in live:
            pool = self.pools[i]
            prof = pool.profile
            if prof is None or prof.last is None:
                continue
            by_model: dict[str, int] = {}
            for s in pool.slots:
                if s is not None and s.model is not None:
                    by_model[s.model] = by_model.get(s.model, 0) + 1
            for name, count in by_model.items():
                slab = pool.slabs[name]
                sub = prof.last[slab.cluster_lo:slab.cluster_hi, slab.cluster_lo:slab.cluster_hi]
                self._obs_delivered[name] = self._obs_delivered.get(name, 0.0) + float(sub.sum())
                self._obs_session_steps[name] = self._obs_session_steps.get(name, 0) + count

    def _score(self, i: int) -> float:
        """Predicted traffic load of shard ``i``: summed per-session rates of
        its resident + queued sessions (the admission objective)."""
        live = [s for s in self.pools[i].slots if s is not None]
        return sum(self._rate_of(s) for s in live) + sum(self._rate_of(s) for s in self.queues[i])

    # -- admission (DESIGN.md §17 layer 2) ---------------------------------
    def submit(self, session: DvsSession) -> int:
        """Route ``session`` to the least-loaded admissible shard.

        The session lands on the cheapest shard (by :meth:`_score`) with a
        free slot, else the cheapest with queue room (admitted at the next
        step's backfill). Raises :class:`AdmissionError` when every live
        shard's bounded queue is full. Returns the chosen shard id.
        """
        self._rate_of(session)  # validates the model name early
        live = self.live_shards()
        if not live:
            raise AdmissionError("no live shards remain in the fleet")
        # a queued session bound for a free slot does not consume queue
        # room: queue_depth bounds only the overflow beyond free slots
        with_slot = [i for i in live if len(self.pools[i].free_slots) > len(self.queues[i])]
        cands = with_slot or [
            i for i in live
            if len(self.queues[i]) < len(self.pools[i].free_slots) + self.shards.queue_depth
        ]
        if not cands:
            raise AdmissionError(
                f"fleet at capacity: every live shard's waiting queue is at "
                f"queue_depth={self.shards.queue_depth}"
            )
        best = min(cands, key=lambda i: (self._score(i), i))
        self.queues[best].append(session)
        return best

    def _backfill(self) -> None:
        for i in self.live_shards():
            while self.pools[i].admit_next(self.queues[i]) is not None:
                pass

    # -- stepping (DESIGN.md §17 layer 1) ----------------------------------
    def step(self) -> None:
        """One fleet timestep: backfill, then step every live shard.

        Every shard's engine step is launched before any result is read
        back, so the device has all of the fleet's work of the step queued
        before the host waits on the first shard.
        """
        self._backfill()
        live = self.live_shards()
        outs = [self.pools[i].begin_step() for i in live]
        for i, out in zip(live, outs):
            self.pools[i].finish_step(out)
        self._observe_rates(live)
        self.n_steps += 1

    def evict_finished(self) -> list[SessionResult]:
        results: list[SessionResult] = []
        for i in self.live_shards():
            fin = self.pools[i].finished_slots()
            if fin:
                results.extend(self.pools[i].evict_many(fin))
        return results

    def serve(self, sessions) -> list[SessionResult]:
        """Drain ``sessions`` through the fleet with continuous batching.

        Pending sessions submit as queue room frees (admission backpressure
        never surfaces to the caller here: the fleet-level pending list
        absorbs it); results return in completion order.
        """
        pending = deque(sessions)
        results: list[SessionResult] = []
        while pending or self.busy:
            while pending:
                try:
                    self.submit(pending[0])
                except AdmissionError:
                    break
                pending.popleft()
            self.step()
            results.extend(self.evict_finished())
        return results

    # -- live migration (DESIGN.md §17 layer 3) ----------------------------
    def locate(self, session_id: int) -> tuple[int, int]:
        """(shard, slot) of a resident session; raises ``KeyError`` if the
        session is not resident (queued sessions have no slot yet)."""
        for i in self.live_shards():
            for slot, s in enumerate(self.pools[i].slots):
                if s is not None and s.session_id == session_id:
                    return i, slot
        raise KeyError(f"session {session_id} is not resident in the fleet")

    def migrate(self, session_id: int, dst_shard: int) -> int:
        """Move a mid-flight session onto ``dst_shard``; returns its new slot.

        The source shard serializes the slot (neuron state, undelivered
        previous-step spikes, phase-normalized time-wheel in-flight slab);
        the destination, possibly a different mesh, splices it at its own
        engine's cursor phase. Bit-exact when the shards share tables and
        delay horizon, which fleet shards do by construction.
        """
        if dst_shard in self.dead or not 0 <= dst_shard < len(self.pools):
            raise ValueError(f"destination shard {dst_shard} is not live")
        src_shard, slot = self.locate(session_id)
        if src_shard == dst_shard:
            return slot
        sess, sc = self.pools[src_shard].extract_session(slot)
        dst_pool = self.pools[dst_shard]
        new_slot = dst_pool.inject_session(sess, sc)
        _land(dst_pool)
        return new_slot

    def drain_shard(self, shard_id: int) -> int:
        """Empty ``shard_id`` for maintenance: migrate every resident session
        to the least-loaded other shard with a free slot and re-route its
        queue. Returns the number of sessions moved; raises
        :class:`AdmissionError` (before moving anything) when the rest of
        the fleet lacks slots for them."""
        if shard_id in self.dead:
            raise ValueError(f"shard {shard_id} is already dead")
        pool = self.pools[shard_id]
        others = [i for i in self.live_shards() if i != shard_id]
        free_elsewhere = sum(len(self.pools[i].free_slots) for i in others)
        if len(pool.occupied) > free_elsewhere:
            raise AdmissionError(
                f"cannot drain shard {shard_id}: {len(pool.occupied)} resident "
                f"sessions but only {free_elsewhere} free slots elsewhere"
            )
        moved = 0
        for slot in list(pool.occupied):
            sess = pool.slots[slot]
            dst = min((i for i in others if self.pools[i].free_slots),
                      key=lambda i: (self._score(i), i))
            self.migrate(sess.session_id, dst)
            moved += 1
        queued, self.queues[shard_id] = list(self.queues[shard_id]), deque()
        for sess in queued:
            self.submit(sess)
            moved += 1
        return moved

    def kill_shard(self, shard_id: int) -> None:
        """Simulate losing ``shard_id``'s host: its pool, carry and queue are
        gone. Sessions it held are recoverable only through
        :meth:`recover_shard` (from the last checkpoint)."""
        if shard_id in self.dead:
            raise ValueError(f"shard {shard_id} is already dead")
        self.dead.add(shard_id)
        self.pools[shard_id] = None
        self.queues[shard_id] = deque()

    # -- checkpoint / elastic restart (DESIGN.md §17 layer 4) --------------
    def _fleet_meta(self) -> dict:
        return {
            "n_shards": self.shards.n_shards,
            "n_steps": self.n_steps,
            "pool_size": self.cfg.pool_size,
            "queue_depth": self.shards.queue_depth,
            "dead": sorted(self.dead),
            "queues": [
                None if i in self.dead
                else [self.pools[i]._session_meta(s) for s in self.queues[i]]
                for i in range(self.shards.n_shards)
            ],
        }

    def snapshot_tree(self) -> dict:
        """One atomic fleet tree: per-shard pool snapshots + fleet meta."""
        blob = np.frombuffer(json.dumps(self._fleet_meta()).encode(), dtype=np.uint8).copy()
        return {
            "fleet_meta": blob,
            "shards": {f"s{i}": self.pools[i].snapshot_tree() for i in self.live_shards()},
        }

    def checkpoint(self, ckptr, step: int | None = None, blocking: bool = False):
        """Write the whole fleet atomically (checkpoint/checkpointer.py).

        Dead shards are omitted (their state died with the host; the
        snapshot of record for their sessions is the previous checkpoint).
        ``step`` defaults to the fleet step counter.
        """
        ckptr.save(self.n_steps if step is None else step, self.snapshot_tree(),
                   blocking=blocking)

    @staticmethod
    def _restore_fleet_meta(ckptr, step: int) -> dict:
        tree = ckptr.restore(step, {"fleet_meta": np.zeros(0, np.uint8)})
        return json.loads(np.asarray(tree["fleet_meta"]).astype(np.uint8).tobytes().decode())

    def _shard_like(self) -> dict:
        """Restore prototype of one shard's tree: the carry as host tensors
        (slot surgery reads them there; :func:`_land` moves them on)."""
        proto = self.pools[self.live_shards()[0]]
        carry = tree_map(lambda x: torch.zeros_like(x, device="cpu"), proto.carry)
        return {"carry": carry, "session_meta": np.zeros(0, np.uint8)}

    def _redistribute_shard_tree(self, shard_tree: dict, queue_meta, source_factory=None) -> int:
        """Splice one saved shard's sessions into the live fleet.

        Resident sessions need free slots (mid-flight state cannot wait in a
        queue); queued ones re-route through :meth:`submit`. Raises
        :class:`CheckpointMismatchError`, before any state lands, when the
        surviving fleet lacks capacity: the typed "reshard impossible" path.
        """
        meta = json.loads(
            np.asarray(shard_tree["session_meta"]).astype(np.uint8).tobytes().decode()
        )
        slots = [(i, sm) for i, sm in enumerate(meta["slots"]) if sm is not None]
        free_total = sum(len(self.pools[i].free_slots) for i in self.live_shards())
        queue_room = sum(self.shards.queue_depth - len(self.queues[i])
                         for i in self.live_shards())
        n_queued = len(queue_meta or [])
        if len(slots) > free_total or n_queued > queue_room:
            raise CheckpointMismatchError(
                f"cannot redistribute a lost shard's {len(slots)} resident + "
                f"{n_queued} queued sessions: the surviving fleet has "
                f"{free_total} free slots and {queue_room} queue slots"
            )
        moved = 0
        if slots:
            # one extraction for all of the shard's occupied slots; any live
            # engine serves — extraction is geometry, not placement
            any_pool = self.pools[self.live_shards()[0]]
            sc_all = any_pool.engine.extract_slots(shard_tree["carry"], [i for i, _ in slots])
            for j, (_, sm) in enumerate(slots):
                sess = session_from_meta(sm, self.models, source_factory=source_factory)
                row = SlotCarry(
                    state=NeuronState(**{f.name: getattr(sc_all.state, f.name)[j:j + 1]
                                         for f in dataclasses.fields(NeuronState)}),
                    spikes=sc_all.spikes[j:j + 1],
                    inflight=None if sc_all.inflight is None else sc_all.inflight[j:j + 1],
                )
                dst = min((i for i in self.live_shards() if self.pools[i].free_slots),
                          key=lambda i: (self._score(i), i))
                dst_pool = self.pools[dst]
                dst_pool.inject_session(sess, row)
                _land(dst_pool)
                moved += 1
        for sm in queue_meta or []:
            self.submit(session_from_meta(sm, self.models, source_factory=source_factory))
            moved += 1
        return moved

    @classmethod
    def restore(
        cls,
        cc: CompiledCnn,
        cfg: AerServeConfig,
        shards: ShardConfig,
        ckptr,
        step: int | None = None,
        *,
        models: dict[str, CompiledCnn] | None = None,
        devices=None,
        device: torch.device | str = "cuda",
        engine_factory=None,
        source_factory=None,
    ) -> "ShardedSessionPool":
        """Rebuild a fleet from a checkpoint, elastically.

        ``shards.n_shards`` may differ from the saved fleet's: shards ``j <
        min(saved, new)`` restore in place bit-exactly (their whole carry
        lands back on shard ``j``'s mesh, whose shape may differ too: the
        carry tensors are global values); saved shards beyond the new count
        redistribute their sessions into surviving free slots via the
        migration path. Raises :class:`CheckpointMismatchError` when the new
        fleet cannot hold the snapshot's live sessions.
        """
        if step is None:
            step = ckptr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no complete checkpoint under {ckptr.dir}")
        fleet = cls(cc, cfg, shards, models=models, devices=devices, device=device,
                    engine_factory=engine_factory)
        meta = cls._restore_fleet_meta(ckptr, step)
        if int(meta["pool_size"]) != cfg.pool_size:
            raise CheckpointMismatchError(
                f"fleet checkpoint was taken at pool_size={meta['pool_size']} "
                f"per shard, restoring at pool_size={cfg.pool_size}"
            )
        saved_live = [j for j in range(int(meta["n_shards"]))
                      if j not in set(meta.get("dead", []))]
        shard_like = fleet._shard_like()
        like = {"fleet_meta": np.zeros(0, np.uint8),
                "shards": {f"s{j}": shard_like for j in saved_live}}
        try:
            tree = ckptr.restore(step, like)
        except CheckpointMismatchError:
            raise
        except ValueError as e:
            raise CheckpointMismatchError(
                f"fleet checkpoint at step {step} does not fit the restoring "
                f"shards' carry: {e}"
            ) from e
        fleet.n_steps = int(meta["n_steps"])
        queues_meta = meta.get("queues") or [None] * int(meta["n_shards"])
        direct = [j for j in saved_live if j < shards.n_shards]
        lost = [j for j in saved_live if j >= shards.n_shards]
        for j in direct:
            pool = fleet.pools[j]
            pool.load_snapshot_tree(tree["shards"][f"s{j}"], source_factory=source_factory)
            _land(pool)
            for sm in queues_meta[j] or []:
                fleet.queues[j].append(
                    session_from_meta(sm, fleet.models, source_factory=source_factory))
        for j in lost:
            fleet._redistribute_shard_tree(tree["shards"][f"s{j}"], queues_meta[j],
                                           source_factory=source_factory)
        return fleet

    def recover_shard(self, ckptr, shard_id: int, step: int | None = None,
                      source_factory=None) -> int:
        """Recover a killed shard's sessions onto the surviving shards.

        The live half of elastic restart: the fleet keeps serving on its
        survivors (their *current* state, untouched); the dead shard's
        sessions roll back to the latest checkpoint and splice into
        surviving free slots. Deterministic stream replay makes the
        recovered sessions' results bit-exact against an undisturbed run;
        they just finish later. Returns the number of sessions recovered.
        Call :meth:`kill_shard` (or lose the host) first.
        """
        if shard_id not in self.dead:
            raise ValueError(f"shard {shard_id} is live — recover_shard is for lost shards")
        if not self.live_shards():
            raise AdmissionError("no live shards remain to recover onto")
        if step is None:
            step = ckptr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no complete checkpoint under {ckptr.dir}")
        meta = self._restore_fleet_meta(ckptr, step)
        if shard_id in set(meta.get("dead", [])) or shard_id >= int(meta["n_shards"]):
            raise CheckpointMismatchError(
                f"checkpoint at step {step} holds no state for shard {shard_id}"
            )
        like = {"fleet_meta": np.zeros(0, np.uint8),
                "shards": {f"s{shard_id}": self._shard_like()}}
        try:
            tree = ckptr.restore(step, like)
        except ValueError as e:
            raise CheckpointMismatchError(
                f"checkpoint at step {step} does not fit the fleet's shard carry: {e}"
            ) from e
        queues_meta = meta.get("queues") or [None] * int(meta["n_shards"])
        return self._redistribute_shard_tree(tree["shards"][f"s{shard_id}"],
                                             queues_meta[shard_id], source_factory=source_factory)
