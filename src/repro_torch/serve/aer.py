"""Continuous-batching AER serving: a DVS session pool (single model).

Counterpart of ``repro.serve.aer`` for one resident Table-V model, in queued
mode or over the executable fabric (``build_poker_engine(tables,
"fabric")``):

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
``fingerprint()`` identifies its serving geometry as ``repro``'s does for a
single resident model named ``"default"``.

Input enters through ``CompiledCnn.input_activity`` with an explicit
malformed-packet policy (``on_invalid``); under ``"raise"`` a bad packet
faults its session, not the pool. Readout is the paper's majority rule over
per-session output-population spike counts, kept on the host in float64.
"""

from __future__ import annotations

import dataclasses
import hashlib
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
from repro_torch.core.event_engine import DeliveryStats, EventEngine
from repro_torch.core.routing import Fabric
from repro_torch.core.tags import RoutingTables
from repro_torch.data.pipeline import DvsStreamSource, symbol_dvs_events

__all__ = [
    "AerServeConfig",
    "DvsSession",
    "SessionResult",
    "AerSessionPool",
    "PoolFullError",
    "SlotError",
    "build_poker_engine",
    "tune_poker_readout",
]


class PoolFullError(RuntimeError):
    """``admit`` beyond capacity: no free slot remains."""


class SlotError(ValueError):
    """A slot operation addressed an invalid target: index out of range or
    eviction of an unoccupied slot."""


def build_poker_engine(
    tables,
    backend: str = "reference",
    device: torch.device | str = "cuda",
    fabric_options: dict | None = None,
    autotune: dict | None = None,
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
    and ``fused`` queues every active source.
    """
    if not isinstance(tables, RoutingTables) and hasattr(tables, "tables"):
        tables = tables.tables
    params = poker_neuron_params()
    q_cap = tables.n_neurons
    if backend == "fabric":
        if autotune is not None:
            raise ValueError("autotune applies to backend='auto', not fabric")
        return EventEngine(
            tables, params, queue_capacity=q_cap, device=device, fabric=Fabric(),
            fabric_options=dict(fabric_options or {}),
        )
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


def _registry_fingerprint(models: dict[str, RoutingTables]) -> str:
    """sha256 over (name, table fingerprint) pairs in slab order, as
    ``repro``'s ``ModelRegistry.fingerprint`` hashes its resident models."""
    h = hashlib.sha256()
    for name, t in models.items():
        h.update(name.encode())
        h.update(b"\x00")
        h.update(t.fingerprint().encode())
        h.update(b"\x01")
    return h.hexdigest()


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy tensors to the host with one wait on the device."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class AerSessionPool:
    """Fixed-slot continuous batching over the batched event engine.

    ``engine`` is an :class:`EventEngine` over the compiled CNN's tables
    built with ``queue_capacity`` or in fabric mode (as
    :func:`build_poker_engine` does). The carry is allocated once at
    ``pool_size`` on the engine's device and reset per slot on eviction;
    session bookkeeping stays on the host. A fabric engine with
    ``per_link_stats`` is served with its link drops summed per session and
    feeds :attr:`profile` (``None`` for every other engine).
    """

    def __init__(self, cc: CompiledCnn, engine: EventEngine, cfg: AerServeConfig):
        if cfg.pool_size <= 0:
            raise ValueError(f"pool_size must be positive, got {cfg.pool_size}")
        if engine.n_neurons != cc.tables.n_neurons:
            raise ValueError(
                f"engine serves {engine.n_neurons} neurons, compiled CNN has "
                f"{cc.tables.n_neurons}"
            )
        if engine.queue_capacity is None and engine.fabric_backend is None:
            raise ValueError("the pool reads drop counts: build the engine with queue_capacity")
        self.cc = cc
        self.engine = engine
        self.cfg = cfg
        self.n_classes = cc.cfg.n_classes
        self.carry = engine.init_state(batch=cfg.pool_size)
        self.slots: list[DvsSession | None] = [None] * cfg.pool_size
        self.n_steps = 0  # engine steps taken (all slots advance together)
        self.last_stats = None  # DeliveryStats of the most recent step()
        self._zero_act = np.zeros((engine.n_clusters, engine.k_tags), dtype=np.float32)
        # observed-traffic feedback (DESIGN.md §18): the empirical traffic
        # matrix that optimize_placement re-places against
        fb = engine.fabric_backend
        self.profile = (
            TrafficProfile.empty(engine.n_clusters, engine.fabric_model.n_tiles)
            if fb is not None and fb.per_link_stats else None
        )

    def fingerprint(self) -> str:
        """Identity of this pool's serving geometry: the resident model
        (a registry of one, named ``"default"``) × delivery mode × pool size
        (× the autotuned dispatch decision), hashed as ``repro``'s pool
        does."""
        eng = self.engine
        mode = "ring" if eng.fabric_ring else "fabric" if eng.fabric_backend is not None else "queued"
        h = hashlib.sha256()
        h.update(_registry_fingerprint({"default": self.cc.tables}).encode())
        h.update(f"|{mode}|P{self.cfg.pool_size}".encode())
        if eng.autotune_decision is not None:
            h.update(f"|{eng.autotune_decision.token()}".encode())
        return h.hexdigest()

    # -- lifecycle ---------------------------------------------------------
    @property
    def occupied(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def admit(self, session: DvsSession) -> int:
        """Claim the lowest free slot for ``session``; raises
        :class:`PoolFullError` when none remains. The slot was wiped at the
        previous tenant's eviction, so the session starts from fresh state."""
        free = self.free_slots
        if not free:
            raise PoolFullError("session pool is full; evict before admitting")
        slot = free[0]
        session.step = 0
        session.counts = np.zeros(self.n_classes, dtype=np.float64)
        session.dropped = 0
        session.link_dropped = 0
        session.error = None  # a re-admitted session retries with a clean slate
        self.slots[slot] = session
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
        ``cfg.drive``; zero for vacant slots and for a session whose packet
        was refused (which is then marked errored)."""
        acts = []
        for sess in self.slots:
            if sess is None:
                acts.append(self._zero_act)
                continue
            try:
                a = self.cc.input_activity(
                    sess.source.events(sess.step), on_invalid=self.cfg.on_invalid
                )
            except ValueError as e:
                sess.error = str(e)
                acts.append(self._zero_act)
                continue
            acts.append(a * self.cfg.drive)
        return np.stack(acts)

    def finish_step(self, out) -> np.ndarray:
        """Bring a launched step's spikes, drop counts, (fabric mode) link
        drop counts and (with a profile) its traffic sums to the host in one
        wait on the device, and apply them per session and to the profile."""
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
        o0, o1 = self.cc.out
        for i, sess in enumerate(self.slots):
            if sess is None:
                continue
            sess.counts += spikes[i, o0:o1].reshape(self.n_classes, -1).sum(-1)
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
