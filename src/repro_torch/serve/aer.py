"""Continuous-batching AER serving: a multi-tenant DVS session pool.

Counterpart of ``repro.serve.aer``, in queued mode or over the executable
fabric (``build_poker_engine(tables, "fabric")``):

  * a **fixed-slot pool**: the engine carry is batched to ``pool_size``
    once; every slot is one tenant's neuron state, previous-step spikes and,
    in fabric mode, its slice of the delay-line ring;
  * one batched engine step drives all slots (vacancy is zero input on
    fresh state, not a smaller shape);
  * **independent admit/evict**: a departing tenant's slot is wiped with
    ``EventEngine.reset_slots`` before reuse.

A fabric engine built with ``per_link_stats`` also feeds every step's
per-cluster-pair delivered counts and per-link drops into the pool's
:class:`~repro_torch.core.compiler.TrafficProfile` (``pool.profile``), the
measured traffic that ``optimize_placement`` re-places against. The pool's
``fingerprint()`` identifies its serving geometry as ``repro``'s does.

Multi-model residency (DESIGN.md §16): ``AerSessionPool.from_models`` serves
several compiled networks from one engine over their concatenated tables
(a :class:`~repro_torch.core.event_engine.ModelRegistry`; a pool built from
one ``CompiledCnn`` is a registry of one, named ``"default"``). Each session
names its model (``DvsSession.model``); its input lands in its model's slab
of the combined ``[n_clusters, K]`` grid and its readout is read at the
slab's neuron offset. ``load_model`` / ``unload_model`` rebuild the engine
under live sessions, whose state moves across the slab re-layout.

Recovery (DESIGN.md §15): a free slot can be quarantined (withdrawn from
admission); a live session moves between pools with its full runtime state
(``extract_session`` / ``inject_session``, ``clone_onto`` for the whole
pool); and the pool checkpoints as one tree (``snapshot_tree``,
``checkpoint``) that ``restore`` resumes bit for bit on an engine of the
same geometry.

Input enters through ``CompiledCnn.input_activity`` with an explicit
malformed-packet policy (``on_invalid``); under ``"raise"`` a bad packet
faults its session, not the pool. Readout is the paper's majority rule over
per-session output-population spike counts, kept on the host in float64.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import deque

import numpy as np
import torch

from repro_torch.core.cnn import (
    CompiledCnn,
    compile_poker_cnn,
    hebbian_readout_select,
    poker_neuron_params,
)
from repro_torch.core.compiler import TrafficProfile
from repro_torch.core.event_engine import (
    DeliveryStats,
    EventEngine,
    ModelRegistry,
    SlotCarry,
    embed_slot_carry,
    slice_slot_carry,
)
from repro_torch.core.routing import Fabric
from repro_torch.core.tags import RoutingTables
from repro_torch.data.pipeline import DvsStreamConfig, DvsStreamSource, symbol_dvs_events

__all__ = [
    "AerServeConfig",
    "DvsSession",
    "SessionResult",
    "AerSessionPool",
    "PoolFullError",
    "SlotError",
    "CheckpointMismatchError",
    "build_poker_engine",
    "session_from_meta",
    "tune_poker_readout",
]

def session_from_meta(
    sm: dict, models, source_factory=None, slot: int | None = None
) -> "DvsSession":
    """Rebuild a :class:`DvsSession` from its checkpoint meta blob entry.

    ``models`` names the restoring pool's resident models (a dict or a
    sequence of names); a session of another model raises
    :class:`CheckpointMismatchError`. Sources that are not a
    :class:`DvsStreamSource` need ``source_factory(slot_meta) -> source``,
    else this raises ``TypeError``.
    """
    src_meta = sm["source"]
    if src_meta.get("kind") == "dvs_stream":
        source = DvsStreamSource(
            DvsStreamConfig(**src_meta["cfg"]), session_id=src_meta["session_id"]
        )
    elif source_factory is not None:
        source = source_factory(sm)
    else:
        raise TypeError(
            f"slot {slot}'s source kind {src_meta.get('kind')!r} is not "
            "serializable — pass source_factory to rebuild it"
        )
    names = list(models)
    model = sm.get("model")
    if model is None and len(names) == 1:
        model = names[0]
    if model not in names:
        raise CheckpointMismatchError(
            f"slot {slot}'s session ran on model {model!r}, which is "
            f"not resident in the restoring pool ({names})"
        )
    return DvsSession(
        session_id=sm["session_id"],
        source=source,
        label=sm["label"],
        model=model,
        tenant=sm.get("tenant"),
        step=int(sm["step"]),
        counts=None if sm["counts"] is None else np.asarray(sm["counts"], dtype=np.float64),
        dropped=int(sm["dropped"]),
        link_dropped=int(sm["link_dropped"]),
        error=sm["error"],
    )


class PoolFullError(RuntimeError):
    """``admit`` beyond capacity: no free (non-quarantined) slot remains."""


class SlotError(ValueError):
    """A slot operation addressed an invalid target: index out of range,
    eviction of an unoccupied slot, or quarantine of an occupied one."""


class CheckpointMismatchError(ValueError):
    """A checkpoint's geometry or resident-model fingerprint does not match
    the pool restoring it. Raised before any carry state is spliced, so a
    failed restore never corrupts the pool."""


def build_poker_engine(
    tables,
    backend: str = "reference",
    device: torch.device | str = "cuda",
    fabric_options: dict | None = None,
    autotune: dict | None = None,
    faults=None,
    entry_slabs=None,
) -> EventEngine:
    """Event engine at the §V serving operating point for a dispatch backend.

    ``backend`` is a registry name (``reference`` / ``cuda`` / ``fused``),
    ``"auto"`` (the dispatch autotuner, configured by ``autotune``: the
    keywords of ``autotune_backend`` or ``{"decision": ...}``), or
    ``"fabric"`` for executable-mesh delivery on the default 3x3-chip board
    geometry, configured by ``fabric_options`` (``FabricBackend`` keywords,
    e.g. ``link_capacity``, ``ring``, ``per_link_stats`` or ``kernel``). The
    AER queue is sized lossless for this workload (``queue_capacity = N``),
    so the ``reference`` and ``cuda`` backends take the dense stage-1 path
    and ``fused`` queues every active source. ``faults`` (a
    :class:`~repro_torch.core.faults.FaultSpec`) needs the fabric backend.
    Memory faults are applied to the tables beforehand
    (``faults.apply_table_faults``) and served on any backend.
    ``entry_slabs`` (several resident models' ``(src_tag, src_dest)``)
    builds the fabric ring's entry table slab by slab.
    """
    if not isinstance(tables, RoutingTables) and hasattr(tables, "tables"):
        tables = tables.tables
    params = poker_neuron_params()
    q_cap = tables.n_neurons
    if backend == "fabric":
        opts = dict(fabric_options or {})
        if faults is not None:
            opts["faults"] = faults
        if autotune is not None:
            raise ValueError("autotune applies to backend='auto', not fabric")
        return EventEngine(
            tables, params, queue_capacity=q_cap, device=device, fabric=Fabric(),
            fabric_options=opts, entry_slabs=entry_slabs,
        )
    if faults is not None:
        raise ValueError(f"fault injection needs the fabric backend, got {backend!r}")
    if entry_slabs is not None:
        raise ValueError("entry_slabs only applies to the fabric backend")
    if fabric_options is not None:
        raise ValueError(f"fabric_options need the fabric backend, got {backend!r}")
    return EventEngine(tables, params, backend=backend, queue_capacity=q_cap, device=device,
                       autotune=autotune)


def tune_poker_readout(device: torch.device | str, rng: np.random.Generator) -> np.ndarray:
    """Offline-Hebbian readout selection: one batched calibration run.

    Presents each suit three times (400 events spread over 40 steps) to the
    default-readout network on the reference backend and selects, per
    class, the 64 pool neurons most selective for it.
    """
    cc = compile_poker_cnn()
    eng = EventEngine(cc.tables, poker_neuron_params(), device=device)
    t_steps, reps = 40, 3
    streams = [symbol_dvs_events(sym, 400, rng) for sym in range(4) for _ in range(reps)]
    act = cc.input_activity_batch(streams) / t_steps * 10.0
    inp = torch.as_tensor(act, device=eng.device).expand(t_steps, *act.shape)
    _, spikes = eng.run(eng.init_state(batch=len(streams)), inp)
    pool_rates = (
        spikes[:, :, cc.pool[0]: cc.pool[1]].sum(0).cpu().numpy().reshape(4, reps, -1).sum(1)
    )
    return hebbian_readout_select(pool_rates)


@dataclasses.dataclass(frozen=True)
class AerServeConfig:
    pool_size: int = 8
    drive: float = 8.0  # event count -> tag-activity gain
    decision_threshold: float = 3.0  # cumulative winning-population spikes
    min_steps: int = 2  # never decide before this many steps
    max_steps: int = 60  # forced argmax decision after this many steps
    on_invalid: str = "raise"  # malformed-packet policy (see CompiledCnn)
    # fairness: at most this many of one tenant's sessions resident at once
    # (None = unlimited)
    max_inflight_per_tenant: int | None = None


@dataclasses.dataclass
class DvsSession:
    """One tenant: an event-stream source plus its readout accumulator."""

    session_id: int
    source: DvsStreamSource
    label: int | None = None  # ground truth when known (synthetic streams)
    # which resident model serves this tenant: data, never shape. None
    # resolves to the pool's sole resident model at admission
    model: str | None = None
    # fairness identity for max_inflight_per_tenant; None = its own tenant
    tenant: int | str | None = None
    # runtime state, owned by the pool
    step: int = 0  # steps since admission (= the source's cursor)
    counts: np.ndarray | None = None  # [n_classes] cumulative output spikes
    dropped: int = 0  # cumulative AER-queue drops
    link_dropped: int = 0  # cumulative fabric link-FIFO drops
    error: str | None = None  # input fault: the session failed, not the pool


def _tenant_of(sess: DvsSession):
    return sess.session_id if sess.tenant is None else sess.tenant


@dataclasses.dataclass(frozen=True)
class SessionResult:
    session_id: int
    label: int | None
    prediction: int
    decided: bool  # True: threshold crossed; False: forced at max_steps
    latency_steps: int  # steps from admission to decision
    counts: np.ndarray  # [n_classes] final cumulative output spikes
    dropped: int
    link_dropped: int
    error: str | None = None  # set when the session was terminated on a fault

    @property
    def correct(self) -> bool | None:
        return None if self.label is None else self.prediction == self.label


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy tensors to the host with one wait on the device."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class AerSessionPool:
    """Fixed-slot continuous batching over the batched event engine.

    ``engine`` is an :class:`EventEngine` over the compiled CNN's tables
    (with ``models``: over the resident models' concatenated tables) built
    with ``queue_capacity`` or in fabric mode (as :func:`build_poker_engine`
    does). The carry is allocated once at ``pool_size`` on the engine's
    device and reset per slot on eviction; session bookkeeping stays on the
    host. A fabric engine with ``per_link_stats`` is served with its link
    drops summed per session and feeds :attr:`profile` (``None`` for every
    other engine). A pool built by :meth:`from_models` owns its engine
    recipe (``engine_kw``) and can load and unload models live.
    """

    def __init__(self, cc: CompiledCnn, engine: EventEngine, cfg: AerServeConfig, *,
                 models: dict[str, CompiledCnn] | None = None, engine_kw: dict | None = None):
        if cfg.pool_size <= 0:
            raise ValueError(f"pool_size must be positive, got {cfg.pool_size}")
        # a registry of one by default: the single-model pool is the
        # degenerate case of multi-model residency (DESIGN.md §16)
        self.models: dict[str, CompiledCnn] = dict(models) if models else {"default": cc}
        self.registry = ModelRegistry({name: m.tables for name, m in self.models.items()})
        combined, self.slabs = self.registry.combined()
        if engine.n_neurons != combined.n_neurons:
            raise ValueError(
                f"engine serves {engine.n_neurons} neurons, compiled CNN has "
                f"{combined.n_neurons}"
            )
        if engine.queue_capacity is None and engine.fabric_backend is None:
            raise ValueError("the pool reads drop counts: build the engine with queue_capacity")
        self.cc = cc
        self.engine = engine
        self.cfg = cfg
        self.n_classes = cc.cfg.n_classes
        self._engine_kw = engine_kw  # set by from_models: enables load/unload
        self.carry = engine.init_state(batch=cfg.pool_size)
        self.slots: list[DvsSession | None] = [None] * cfg.pool_size
        self.quarantined: set[int] = set()  # slots withdrawn from admission
        self.n_steps = 0  # engine steps taken (all slots advance together)
        self.last_stats = None  # DeliveryStats of the most recent step()
        # observed-traffic feedback (DESIGN.md §18): the empirical traffic
        # matrix that optimize_placement re-places against
        self.profile = self._fresh_profile(engine)

    @staticmethod
    def _fresh_profile(engine: EventEngine) -> TrafficProfile | None:
        fb = engine.fabric_backend
        if fb is None or not fb.per_link_stats:
            return None
        return TrafficProfile.empty(engine.n_clusters, engine.fabric_model.n_tiles)

    # -- multi-model residency (DESIGN.md §16) -----------------------------
    @staticmethod
    def _engine_for(models: dict[str, CompiledCnn], engine_kw: dict) -> EventEngine:
        """One engine over the concatenated slabs of every resident model.

        On the fabric ring the entry table is assembled slab by slab; a
        faulted fabric needs the full-grid draw, so it builds from the
        concatenated table instead (the two builds are equal).
        """
        registry = ModelRegistry({name: m.tables for name, m in models.items()})
        combined, _ = registry.combined()
        entry_slabs = None
        if len(models) > 1 and engine_kw.get("backend") == "fabric" \
                and engine_kw.get("faults") is None:
            entry_slabs = [(t.src_tag, t.src_dest)
                           for t in (registry.tables_of(n) for n in registry.names)]
        return build_poker_engine(combined, entry_slabs=entry_slabs, **engine_kw)

    @classmethod
    def from_models(
        cls,
        models: dict[str, CompiledCnn],
        cfg: AerServeConfig,
        *,
        backend: str = "reference",
        device: torch.device | str = "cuda",
        faults=None,
        fabric_options: dict | None = None,
        autotune: dict | None = None,
    ) -> "AerSessionPool":
        """Pool with several resident models sharing one engine on ``device``.

        Sessions pick their model by name at admission (``DvsSession.model``):
        model identity is per-slot data, so a mix of tenants on different
        models is one engine step. Pools built this way own their engine
        recipe and support :meth:`load_model` / :meth:`unload_model` on a
        live pool. ``backend``, ``faults``, ``fabric_options`` and
        ``autotune`` are :func:`build_poker_engine`'s.
        """
        if not models:
            raise ValueError("from_models needs at least one resident model")
        engine_kw = {"backend": backend, "device": device, "faults": faults,
                     "fabric_options": fabric_options, "autotune": autotune}
        engine = cls._engine_for(models, engine_kw)
        first = next(iter(models.values()))
        return cls(first, engine, cfg, models=models, engine_kw=engine_kw)

    def fingerprint(self) -> str:
        """Identity of this pool's serving geometry: the resident models
        (tables and slab order) × delivery mode × pool size (× the autotuned
        dispatch decision), hashed as ``repro``'s pool does. Checkpoints
        carry it; restore refuses a mismatch."""
        eng = self.engine
        mode = "ring" if eng.fabric_ring else "fabric" if eng.fabric_backend is not None else "queued"
        h = hashlib.sha256()
        h.update(self.registry.fingerprint().encode())
        h.update(f"|{mode}|P{self.cfg.pool_size}".encode())
        if eng.autotune_decision is not None:
            h.update(f"|{eng.autotune_decision.token()}".encode())
        return h.hexdigest()

    def _resolve_model(self, session: DvsSession) -> str:
        name = session.model
        if name is None:
            if len(self.models) > 1:
                raise ValueError(
                    "session must name its model when several are resident "
                    f"(have {list(self.models)})"
                )
            name = next(iter(self.models))
            session.model = name
        elif name not in self.models:
            raise KeyError(f"model {name!r} is not resident (have {list(self.models)})")
        return name

    def _require_recipe(self) -> None:
        if self._engine_kw is None:
            raise RuntimeError(
                "this pool wraps a caller-built engine and cannot rebuild it;"
                " construct with AerSessionPool.from_models to enable hot-swap"
            )

    def load_model(self, name: str, cc: CompiledCnn) -> None:
        """Make ``cc`` resident under ``name`` on the live pool.

        Sessions in flight keep running: their slots' state moves onto the
        rebuilt engine (slab slice, fresh-init embed, splice) and their
        readout accumulators are untouched.
        """
        self._require_recipe()
        if name in self.models:
            raise ValueError(f"model {name!r} already resident")
        self._rebind({**self.models, name: cc})

    def unload_model(self, name: str) -> None:
        """Remove a resident model from the live pool; refuses while sessions
        still run on it, and refuses the last model."""
        self._require_recipe()
        if name not in self.models:
            raise KeyError(f"model {name!r} is not resident")
        if len(self.models) == 1:
            raise ValueError("cannot unload the last resident model")
        live = [i for i, s in enumerate(self.slots) if s is not None and s.model == name]
        if live:
            raise RuntimeError(
                f"model {name!r} has live sessions in slots {live}; drain "
                "them before unloading"
            )
        self._rebind({n: m for n, m in self.models.items() if n != name})

    def _rebind(self, new_models: dict[str, CompiledCnn]) -> None:
        """Swap the pool onto a rebuilt engine for ``new_models``, moving
        every occupied slot's state across the slab re-layout: one extract,
        slice, embed and splice per model with live sessions."""
        new_engine = self._engine_for(new_models, self._engine_kw)
        new_registry = ModelRegistry({name: m.tables for name, m in new_models.items()})
        new_slabs = new_registry.slabs()
        new_carry = new_engine.init_state(batch=self.cfg.pool_size)
        for name in dict.fromkeys(s.model for s in self.slots if s is not None):
            slots = [i for i, s in enumerate(self.slots) if s is not None and s.model == name]
            part = slice_slot_carry(self.engine.extract_slots(self.carry, slots), self.slabs[name])
            emb = embed_slot_carry(part, new_engine, new_slabs[name])
            new_carry = new_engine.splice_slots(new_carry, slots, emb)
        self.models = dict(new_models)
        self.registry = new_registry
        self.slabs = new_slabs
        self.engine = new_engine
        self.carry = new_carry
        # measurements under the old geometry do not describe the new one
        self.profile = self._fresh_profile(new_engine)

    def clone_onto(self, new_engine: EventEngine, cfg: AerServeConfig | None = None
                   ) -> "AerSessionPool":
        """New pool on ``new_engine`` (same slab geometry) with every live
        session migrated: each tenant's neuron state, previous-step spikes
        and phase-normalized in-flight fabric events (``extract_slots`` /
        ``splice_slots``) and its readout accumulators. The resident model
        set and the engine recipe carry over; quarantine records do not."""
        new_pool = AerSessionPool(self.cc, new_engine, cfg or self.cfg, models=self.models,
                                  engine_kw=self._engine_kw)
        occ = self.occupied
        if occ:
            sc = self.engine.extract_slots(self.carry, occ)
            target = [new_pool.admit_restored(self.slots[i]) for i in occ]
            new_pool.carry = new_engine.splice_slots(new_pool.carry, target, sc)
        new_pool.n_steps = self.n_steps
        return new_pool

    # -- lifecycle ---------------------------------------------------------
    @property
    def occupied(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None and i not in self.quarantined]

    def quarantine_slot(self, slot: int) -> None:
        """Withdraw a free slot from admission (a suspected-faulty lane).

        The watchdog (serve/health.py) quarantines a slot whose successive
        tenants keep faulting. Only free slots can be quarantined: evict the
        tenant first so its result and the slot reset take the normal path.
        """
        if not 0 <= slot < self.cfg.pool_size:
            raise SlotError(f"slot {slot} out of range")
        if self.slots[slot] is not None:
            raise SlotError(f"slot {slot} is occupied; evict before quarantine")
        self.quarantined.add(slot)

    def admit(self, session: DvsSession) -> int:
        """Claim the lowest free slot for ``session``; raises
        :class:`PoolFullError` when no admissible slot remains (all occupied
        or quarantined). The slot was wiped at the previous tenant's
        eviction, so the session starts from fresh state."""
        free = self.free_slots
        if not free:
            raise PoolFullError(
                "session pool is full; evict before admitting"
                if len(self.occupied) == self.cfg.pool_size
                else "no admissible slot: the pool's free slots are all quarantined"
            )
        slot = free[0]
        name = self._resolve_model(session)
        session.step = 0
        session.counts = np.zeros(self.models[name].cfg.n_classes, dtype=np.float64)
        session.dropped = 0
        session.link_dropped = 0
        session.error = None  # a re-admitted session retries with a clean slate
        self.slots[slot] = session
        return slot

    def admit_restored(self, session: DvsSession) -> int:
        """Claim a free slot for a mid-flight session without resetting its
        runtime accumulators (the restore and migration path).

        The caller owns the matching carry surgery: ``splice_slots`` the
        session's serialized state into the slot this returns.
        """
        free = self.free_slots
        if not free:
            raise PoolFullError("session pool is full; evict before admitting")
        if session.counts is None:
            raise ValueError(
                "admit_restored needs a session with live runtime state — "
                "use admit() for new sessions"
            )
        self._resolve_model(session)
        slot = free[0]
        self.slots[slot] = session
        return slot

    def extract_session(self, slot: int) -> tuple[DvsSession, SlotCarry]:
        """Remove the tenant in ``slot`` mid-flight with its runtime state.

        The source half of a live migration: the session carries its readout
        accumulators and stream cursor, the :class:`SlotCarry` its neuron
        state, previous-step spikes and phase-normalized delay line. The
        vacated slot is wiped as an eviction wipes it.
        """
        if not 0 <= slot < self.cfg.pool_size:
            raise SlotError(f"slot {slot} out of range")
        sess = self.slots[slot]
        if sess is None:
            raise SlotError(f"slot {slot} is not occupied")
        sc = self.engine.extract_slots(self.carry, [slot])
        self.slots[slot] = None
        mask = np.zeros(self.cfg.pool_size, dtype=bool)
        mask[slot] = True
        self.carry = self.engine.reset_slots(self.carry, mask)
        return sess, sc

    def inject_session(self, sess: DvsSession, sc: SlotCarry) -> int:
        """Admit a mid-flight session with its serialized state (the inverse
        of :meth:`extract_session`; the destination may run another delivery
        mode). Returns the destination slot."""
        slot = self.admit_restored(sess)
        self.carry = self.engine.splice_slots(self.carry, [slot], sc)
        return slot

    def evict(self, slot: int) -> SessionResult:
        """Finalize and remove the tenant in ``slot``; wipe the slot's state."""
        return self.evict_many([slot])[0]

    def evict_many(self, slots: list[int]) -> list[SessionResult]:
        """Evict several tenants with ONE masked carry reset."""
        slots = list(dict.fromkeys(slots))  # dedupe, preserve order
        # validate before mutating: a bad id must not leave earlier slots
        # freed-but-unreset
        for slot in slots:
            if not 0 <= slot < self.cfg.pool_size:
                raise SlotError(f"slot {slot} out of range")
            if self.slots[slot] is None:
                raise SlotError(f"slot {slot} is not occupied")
        results = []
        mask = np.zeros(self.cfg.pool_size, dtype=bool)
        for slot in slots:
            sess = self.slots[slot]
            decided, _ = self._decision(sess)
            results.append(
                SessionResult(
                    session_id=sess.session_id,
                    label=sess.label,
                    prediction=int(np.argmax(sess.counts)),
                    decided=decided,
                    latency_steps=sess.step,
                    counts=sess.counts.copy(),
                    dropped=sess.dropped,
                    link_dropped=sess.link_dropped,
                    error=sess.error,
                )
            )
            self.slots[slot] = None
            mask[slot] = True
        if mask.any():
            self.carry = self.engine.reset_slots(self.carry, mask)
        return results

    # -- stepping ----------------------------------------------------------
    def step(self) -> np.ndarray:
        """Advance every slot one engine timestep; returns spikes ``[P, N]``.

        Occupied slots are driven by their session's stream events for the
        session's own step counter; vacant slots see zero input. A malformed
        packet under ``on_invalid="raise"`` faults its session (the tenant
        sees zero input and is terminated at the next eviction sweep).
        """
        return self.finish_step(self.begin_step())

    def begin_step(self):
        """Gather this step's inputs on the host and launch the engine step;
        returns without waiting for the device."""
        self.carry, out = self.engine.step(self.carry, self.gather_inputs())
        return out

    def gather_inputs(self) -> np.ndarray:
        """This step's external tag activity ``[P, n_clusters, K]`` (numpy):
        each occupied slot's stream events at the session's own step, times
        ``cfg.drive``, in its model's slab of the grid (``[cluster_lo:
        cluster_hi, :k_tags]``); zero elsewhere, for vacant slots and for a
        session whose packet was refused (which is then marked errored)."""
        inp = np.zeros((self.cfg.pool_size, self.engine.n_clusters, self.engine.k_tags),
                       dtype=np.float32)
        for i, sess in enumerate(self.slots):
            if sess is None:
                continue
            try:
                a = self.models[sess.model].input_activity(
                    sess.source.events(sess.step), on_invalid=self.cfg.on_invalid
                )
            except ValueError as e:
                sess.error = str(e)
                continue
            slab = self.slabs[sess.model]
            inp[i, slab.cluster_lo:slab.cluster_hi, :slab.k_tags] = a * self.cfg.drive
        return inp

    def finish_step(self, out) -> np.ndarray:
        """Bring a launched step's spikes, drop counts, (fabric mode) link
        drop counts and (with a profile) its traffic sums to the host in one
        wait on the device, and apply them per session (each read at its
        model's slab offset) and to the profile."""
        spikes_t, stats = out
        link_t = stats.link_dropped
        if link_t is not None and link_t.ndim > spikes_t.ndim - 1:
            link_t = link_t.sum(-1)  # per_link_stats: [P, T*T] -> per session
        to_copy = (spikes_t, stats.dropped) + (() if link_t is None else (link_t,))
        if self.profile is not None:
            # summed over every slot on the device, empty ones included
            nc, nt = self.profile.n_clusters, self.profile.n_tiles
            to_copy += (stats.delivered.reshape(-1, nc * nc).sum(0),
                        stats.link_dropped.reshape(-1, nt * nt).sum(0))
        spikes, dropped, *rest = _to_host(*to_copy)
        link = rest[:1] if link_t is not None else []
        if self.profile is not None:
            pair, link_pair = rest[-2:]
            self.profile.observe(
                DeliveryStats(dropped=dropped, link_dropped=link_pair, delivered=pair)
            )
        self.last_stats = stats
        self.n_steps += 1
        for i, sess in enumerate(self.slots):
            if sess is None:
                continue
            cc_m = self.models[sess.model]
            base = self.slabs[sess.model].neuron_lo
            o0, o1 = cc_m.out
            sess.counts += spikes[i, base + o0:base + o1].reshape(cc_m.cfg.n_classes, -1).sum(-1)
            sess.step += 1
            sess.dropped += int(dropped[i])
            if link:
                sess.link_dropped += int(link[0][i])
        return spikes

    def _decision(self, sess: DvsSession) -> tuple[bool, bool]:
        """(threshold crossed, finished) for one session."""
        decided = (
            sess.error is None
            and sess.step >= self.cfg.min_steps
            and float(sess.counts.max()) >= self.cfg.decision_threshold
        )
        finished = decided or sess.step >= self.cfg.max_steps or sess.error is not None
        return decided, finished

    def finished_slots(self) -> list[int]:
        """Slots whose tenant has reached a decision (or the step cap)."""
        return [
            i for i, s in enumerate(self.slots) if s is not None and self._decision(s)[1]
        ]

    # -- checkpoint / restore (DESIGN.md §15) ------------------------------
    def _session_meta(self, sess: DvsSession) -> dict:
        src = sess.source
        if isinstance(src, DvsStreamSource):
            source = {
                "kind": "dvs_stream",
                "cfg": dataclasses.asdict(src.cfg),
                "session_id": src.session_id,
            }
        else:
            # restore() rebuilds other sources through its source_factory
            source = {"kind": type(src).__name__}
        return {
            "session_id": sess.session_id,
            "label": sess.label,
            "model": sess.model,
            "tenant": sess.tenant,
            "step": sess.step,
            "counts": None if sess.counts is None else sess.counts.tolist(),
            "dropped": sess.dropped,
            "link_dropped": sess.link_dropped,
            "error": sess.error,
            "source": source,
        }

    def snapshot_tree(self) -> dict:
        """The pool's whole checkpointable state as one tree.

        ``{"carry": <engine carry>, "session_meta": <uint8 JSON blob>}``: the
        engine carry (neuron state, previous-step spikes and the fabric delay
        line: ring and cursor, or the roll buffer) and every live session's
        readout accumulators and stream descriptor.
        """
        meta = {
            "n_steps": self.n_steps,
            "pool_size": self.cfg.pool_size,
            "fingerprint": self.fingerprint(),
            "models": list(self.models),
            "quarantined": sorted(self.quarantined),
            "slots": [None if s is None else self._session_meta(s) for s in self.slots],
        }
        blob = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8).copy()
        return {"carry": self.carry, "session_meta": blob}

    def load_snapshot_tree(self, tree, source_factory=None) -> None:
        """Apply a :meth:`snapshot_tree` onto this (freshly built) pool.

        Checks the pool size and the serving-geometry fingerprint before any
        state is installed (:class:`CheckpointMismatchError`), then installs
        the carry and rebuilds every live session from its meta entry.
        """
        meta = json.loads(np.asarray(tree["session_meta"]).astype(np.uint8).tobytes().decode())
        if int(meta["pool_size"]) != self.cfg.pool_size:
            raise CheckpointMismatchError(
                f"checkpoint was taken at pool_size={meta['pool_size']}, "
                f"restoring into pool_size={self.cfg.pool_size}"
            )
        want = meta.get("fingerprint")
        if want is not None and want != self.fingerprint():
            raise CheckpointMismatchError(
                f"checkpoint fingerprint {want[:12]}... does not match the "
                f"restoring pool's {self.fingerprint()[:12]}... — the engine "
                "geometry, delivery mode, or resident model set changed "
                "since the snapshot (restore into the matching pool, or "
                "migrate with clone_onto after a bit-exact restore)"
            )
        slots = [
            None if sm is None
            else session_from_meta(sm, self.models, source_factory=source_factory, slot=i)
            for i, sm in enumerate(meta["slots"])
        ]
        self.carry = tree["carry"]
        self.n_steps = int(meta["n_steps"])
        self.quarantined = {int(i) for i in meta["quarantined"]}
        self.slots = slots

    def checkpoint(self, ckptr, step: int | None = None, blocking: bool = False):
        """Snapshot the pool into ``ckptr`` (checkpoint/checkpointer.py).

        One atomic tree (:meth:`snapshot_tree`). A :class:`DvsStreamSource`
        is pure in its step counter, so ``(cfg, session_id, step)`` replays
        the exact event stream, and a restored pool resumes bit for bit on
        an engine of the same geometry. ``step`` defaults to ``n_steps``.
        """
        ckptr.save(self.n_steps if step is None else step, self.snapshot_tree(),
                   blocking=blocking)

    @classmethod
    def restore(cls, cc: CompiledCnn, engine: EventEngine, cfg: AerServeConfig, ckptr,
                step: int | None = None, source_factory=None,
                models: dict[str, CompiledCnn] | None = None) -> "AerSessionPool":
        """Rebuild a pool from a :meth:`checkpoint` snapshot.

        ``engine`` must have the checkpointed carry's geometry (same neuron
        and cluster counts and delivery mode); resuming is then bit-exact.
        ``step`` defaults to the latest complete checkpoint. Sessions whose
        source was not a :class:`DvsStreamSource` need
        ``source_factory(slot_meta) -> source``, else restore raises
        ``TypeError``. ``models`` is the resident model set of a
        multi-model pool, in the checkpointed pool's order (another set or
        order raises :class:`CheckpointMismatchError`).
        """
        if step is None:
            step = ckptr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no complete checkpoint under {ckptr.dir}")
        pool = cls(cc, engine, cfg, models=models)
        like = {"carry": pool.carry, "session_meta": np.zeros(0, np.uint8)}
        try:
            tree = ckptr.restore(step, like)
        except ValueError as e:
            # the checkpointed carry does not fit this engine (a leaf's shape
            # changed): refuse before any state is installed
            raise CheckpointMismatchError(
                f"checkpoint at step {step} does not fit the restoring "
                f"engine's carry: {e}"
            ) from e
        pool.load_snapshot_tree(tree, source_factory=source_factory)
        return pool

    # -- drain loop --------------------------------------------------------
    def admit_next(self, pending: deque) -> DvsSession | None:
        """Admit the first admissible session from the ``pending`` queue.

        FIFO except for fairness: with ``max_inflight_per_tenant`` set, a
        session whose tenant already holds that many slots is skipped (it
        keeps its queue position). Returns the admitted session, or ``None``
        when nothing is admissible.
        """
        if not pending or not self.free_slots:
            return None
        cap = self.cfg.max_inflight_per_tenant
        pick = 0
        if cap is not None:
            inflight: dict = {}
            for s in self.slots:
                if s is not None:
                    t = _tenant_of(s)
                    inflight[t] = inflight.get(t, 0) + 1
            pick = next(
                (i for i, s in enumerate(pending) if inflight.get(_tenant_of(s), 0) < cap),
                None,
            )
            if pick is None:
                return None
        sess = pending[pick]
        del pending[pick]
        self.admit(sess)
        return sess

    def serve(self, sessions) -> list[SessionResult]:
        """Serve ``sessions`` to completion with continuous batching.

        Admissions backfill free slots every step, evictions happen the step
        a tenant decides. Results are returned in completion order.
        """
        pending = deque(sessions)
        results: list[SessionResult] = []
        while pending or self.occupied:
            while self.admit_next(pending) is not None:
                pass
            self.step()
            finished = self.finished_slots()
            if finished:
                results.extend(self.evict_many(finished))
        return results
