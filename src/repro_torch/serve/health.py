"""Serving health: watchdog, typed fault events, and the resilient drain loop.

Counterpart of ``repro.serve.health``, with the reference's event kinds,
messages, hysteresis and backoff. Degraded-mode
serving (DESIGN.md §15) layers three escalation stages over the session
pool, from cheapest to most disruptive:

  1. **per-session retry**: a faulted tenant (input fault, or silent past
     the watchdog threshold) is evicted and re-enqueued through the normal
     admission queue with bounded exponential backoff in engine steps; the
     stream source is pure in its step counter, so a retry replays the
     session from scratch deterministically.
  2. **slot quarantine**: a slot whose successive tenants keep faulting is
     a lane-correlated symptom; the slot is withdrawn from admission so the
     pool keeps serving on the remaining lanes.
  3. **pool-level degraded mode**: a sustained fabric-wide link-drop rate
     above threshold means the topology itself is sick. The loop emits a
     ``pool-degraded`` event; the ``on_degraded`` callback may hand back a
     replacement pool (typically :func:`migrate_pool` onto an engine built
     around ``compiler.repair_placement``) and serving continues there,
     with surviving tenants' full fabric state spliced across.

The watchdog reads only what the pool already exposes per step
(``pool.last_stats`` and the per-session readout accumulators), so
observing never perturbs the tenants it watches.

:class:`ReplacementController` closes the measure -> optimize -> recompile
loop on a live pool (DESIGN.md §18): it re-places the observed traffic onto
free tiles and loads the result as a new model version under the live
sessions. :class:`FleetWatchdog` scans a sharded fleet
(serve/sharded.py) with one :class:`Watchdog` per shard.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core.compiler import optimize_placement, placement_cost, traffic_matrix
from repro_torch.core.routing import default_tile_of_cluster, tile_hop_matrix
from repro_torch.serve.aer import AerSessionPool, DvsSession, SessionResult

__all__ = [
    "WatchdogConfig",
    "FaultEvent",
    "Watchdog",
    "FleetWatchdog",
    "serve_resilient",
    "migrate_pool",
    "ReplacementConfig",
    "ReplacementController",
]


def _totals(*counts) -> list[float]:
    """Host sums of per-step count tensors (``None`` sums to 0), brought
    over in one copy."""
    sums = [c.sum(dtype=torch.float64) for c in counts if c is not None]
    host = torch.stack(sums).cpu().tolist() if sums else []
    it = iter(host)
    return [0.0 if c is None else next(it) for c in counts]


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    """Thresholds for the per-step health scan (DESIGN.md §15)."""

    silence_steps: int = 12  # steps without output-spike progress -> faulted
    link_drop_threshold: float = 0.25  # windowed drop fraction -> degraded
    window: int = 8  # steps in the link-drop moving window
    max_retries: int = 2  # per-session re-admissions before giving up
    backoff_base: int = 4  # retry n waits base * 2**(n-1) engine steps
    quarantine_after: int = 2  # consecutive faulted tenants -> quarantine slot


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One typed watchdog observation.

    ``kind`` is one of ``"session-error"`` (the pool faulted a tenant on a
    malformed packet), ``"session-silent"`` (no readout progress for
    ``silence_steps``), ``"slot-quarantined"`` (escalation stage 2) and
    ``"pool-degraded"`` (stage 3). ``value`` carries the triggering
    measurement — silent steps, or the windowed link-drop fraction.
    """

    kind: str
    step: int  # pool.n_steps when observed
    slot: int | None = None
    session_id: int | None = None
    value: float | None = None
    message: str = ""


class Watchdog:
    """Per-step scan of a pool's health signals into :class:`FaultEvent` s."""

    def __init__(self, cfg: WatchdogConfig | None = None):
        self.cfg = cfg or WatchdogConfig()
        # (slot, session_id) -> (last counts sum, session step at last progress)
        self._progress: dict[tuple[int, int], tuple[float, int]] = {}
        self._silent_flagged: set[tuple[int, int]] = set()
        self._error_flagged: set[tuple[int, int]] = set()
        self._drop_window: deque[float] = deque(maxlen=self.cfg.window)
        self._degraded_flagged = False

    def link_drop_rate(self) -> float:
        """Current windowed fraction of fabric events lost on links."""
        if not self._drop_window:
            return 0.0
        return float(np.mean(self._drop_window))

    def observe(self, pool: AerSessionPool) -> list[FaultEvent]:
        """Scan ``pool`` after a step; emit newly-detected fault events.

        Each condition fires once per episode: a silent session is flagged
        once until it makes progress again, and ``pool-degraded`` re-arms
        only after the windowed drop rate falls below half the threshold
        (hysteresis, so a rate hovering at the threshold does not flap).
        """
        cfg = self.cfg
        events: list[FaultEvent] = []

        # -- per-session: input faults and readout silence ---------------
        live_keys = set()
        for slot, sess in enumerate(pool.slots):
            if sess is None:
                continue
            key = (slot, sess.session_id)
            live_keys.add(key)
            if sess.error is not None and key not in self._error_flagged:
                self._error_flagged.add(key)
                events.append(
                    FaultEvent(
                        kind="session-error",
                        step=pool.n_steps,
                        slot=slot,
                        session_id=sess.session_id,
                        message=sess.error,
                    )
                )
            total = float(sess.counts.sum()) if sess.counts is not None else 0.0
            last_total, last_step = self._progress.get(key, (-1.0, 0))
            if total > last_total:
                self._progress[key] = (total, sess.step)
                self._silent_flagged.discard(key)
            elif (
                sess.error is None
                and sess.step - last_step >= cfg.silence_steps
                and key not in self._silent_flagged
            ):
                self._silent_flagged.add(key)
                events.append(
                    FaultEvent(
                        kind="session-silent",
                        step=pool.n_steps,
                        slot=slot,
                        session_id=sess.session_id,
                        value=float(sess.step - last_step),
                        message=(
                            f"no readout progress for {sess.step - last_step} "
                            f"steps (threshold {cfg.silence_steps})"
                        ),
                    )
                )
        # evicted tenants free their trackers so a slot's next occupant
        # starts with a clean progress history
        for key in set(self._progress) - live_keys:
            self._progress.pop(key, None)
            self._silent_flagged.discard(key)
            self._error_flagged.discard(key)

        # -- pool-level: windowed fabric link-drop rate -------------------
        stats = pool.last_stats
        if stats is not None and stats.link_dropped is not None:
            lost, delivered = _totals(stats.link_dropped, stats.delivered)
            sent = lost + delivered
            self._drop_window.append(lost / sent if sent > 0 else 0.0)
        rate = self.link_drop_rate()
        if (
            len(self._drop_window) == cfg.window
            and rate >= cfg.link_drop_threshold
            and not self._degraded_flagged
        ):
            self._degraded_flagged = True
            events.append(
                FaultEvent(
                    kind="pool-degraded",
                    step=pool.n_steps,
                    value=rate,
                    message=(
                        f"windowed link-drop rate {rate:.3f} >= "
                        f"{cfg.link_drop_threshold} over {cfg.window} steps"
                    ),
                )
            )
        elif rate < cfg.link_drop_threshold / 2:
            self._degraded_flagged = False
        return events


def _failed_result(sess: DvsSession, error: str) -> SessionResult:
    counts = (
        sess.counts
        if sess.counts is not None
        else np.zeros(1, dtype=np.float64)
    )
    return SessionResult(
        session_id=sess.session_id,
        label=sess.label,
        prediction=int(np.argmax(counts)),
        decided=False,
        latency_steps=sess.step,
        counts=np.asarray(counts, dtype=np.float64).copy(),
        dropped=sess.dropped,
        link_dropped=sess.link_dropped,
        error=error,
    )


def serve_resilient(
    pool: AerSessionPool,
    sessions,
    watchdog: Watchdog | None = None,
    on_degraded=None,
) -> tuple[list[SessionResult], list[FaultEvent]]:
    """Drain ``sessions`` through ``pool`` with the §15 escalation ladder.

    Like ``pool.serve`` but fault-aware: faulted tenants retry through the
    admission queue with exponential backoff (``backoff_base * 2**(n-1)``
    engine steps before attempt ``n``, bounded by ``max_retries`` — the
    intermediate failed results are discarded; the last failure's result is
    kept), slots whose tenants fault ``quarantine_after`` times in a row
    are withdrawn, and a ``pool-degraded`` event is offered to
    ``on_degraded(pool, event)`` which may return a replacement pool
    (serving transparently continues on it — see :func:`migrate_pool`).

    Returns ``(results, events)`` in completion order. When every slot ends
    up quarantined with work still queued, the remainder is failed
    explicitly rather than spinning forever.
    """
    wd = watchdog or Watchdog()
    cfg = wd.cfg
    pending: deque[DvsSession] = deque(sessions)
    waiting: list[tuple[int, DvsSession]] = []  # (admissible at n_steps, sess)
    attempts: dict[int, int] = {}
    slot_faults: dict[int, int] = {}
    results: list[SessionResult] = []
    events: list[FaultEvent] = []

    while pending or waiting or pool.occupied:
        # backoff expiry: move due retries into the admission queue
        due = [s for t, s in waiting if t <= pool.n_steps]
        if due:
            waiting = [(t, s) for t, s in waiting if t > pool.n_steps]
            pending.extend(due)
        while pending and pool.free_slots:
            pool.admit(pending.popleft())
        if not pool.occupied and (pending or waiting):
            if not pool.free_slots:
                # every lane quarantined: fail the remainder rather than spin
                for sess in list(pending) + [s for _, s in waiting]:
                    results.append(
                        _failed_result(
                            sess, "pool exhausted: all slots quarantined"
                        )
                    )
                break
            # nothing admissible yet (all retries still backing off): the
            # empty step below advances n_steps toward their due time

        pool.step()
        evs = wd.observe(pool)
        events.extend(evs)
        for ev in evs:
            if ev.kind == "pool-degraded" and on_degraded is not None:
                replacement = on_degraded(pool, ev)
                if replacement is not None:
                    pool = replacement
            elif ev.kind == "session-silent":
                sess = pool.slots[ev.slot] if ev.slot is not None else None
                if sess is not None and sess.session_id == ev.session_id:
                    sess.error = ev.message  # finishes at the next sweep

        finished = pool.finished_slots()
        if not finished:
            continue
        finished_sessions = [pool.slots[i] for i in finished]
        for slot, sess, res in zip(
            finished, finished_sessions, pool.evict_many(finished)
        ):
            if res.error is None:
                slot_faults[slot] = 0
                results.append(res)
                continue
            slot_faults[slot] = slot_faults.get(slot, 0) + 1
            n = attempts.get(sess.session_id, 0)
            if n < cfg.max_retries:
                attempts[sess.session_id] = n + 1
                waiting.append(
                    (pool.n_steps + cfg.backoff_base * 2**n, sess)
                )
            else:
                results.append(res)  # final failure: keep the error result
            if (
                slot_faults[slot] >= cfg.quarantine_after
                and pool.slots[slot] is None
                and slot not in pool.quarantined
            ):
                pool.quarantine_slot(slot)
                events.append(
                    FaultEvent(
                        kind="slot-quarantined",
                        step=pool.n_steps,
                        slot=slot,
                        value=float(slot_faults[slot]),
                        message=(
                            f"{slot_faults[slot]} consecutive faulted "
                            "tenants"
                        ),
                    )
                )
    return results, events


def migrate_pool(
    pool: AerSessionPool, new_engine, cfg=None
) -> AerSessionPool:
    """Move a pool's live sessions onto ``new_engine`` mid-flight.

    The degraded-mode recovery step: build a fresh pool on the repaired
    engine (typically compiled with the placement from
    ``compiler.repair_placement``), then carry every surviving tenant's
    complete runtime state across — neuron state, previous-step spikes and
    phase-normalized in-flight fabric events via
    ``EventEngine.extract_slots`` / ``splice_slots``, plus the session's
    readout accumulators untouched (``admit_restored``). Bit-exact when the
    two engines share geometry and ``max_delay``; best-effort re-bucketing
    otherwise (DESIGN.md §15). Quarantined-slot state is deliberately NOT
    copied: the new engine's lanes start with a clean record. A multi-model
    pool keeps its whole resident set. The mechanics live in
    :meth:`AerSessionPool.clone_onto`.
    """
    return pool.clone_onto(new_engine, cfg)


class FleetWatchdog:
    """Health scan over a :class:`~repro_torch.serve.sharded.ShardedSessionPool`.

    One independent :class:`Watchdog` per shard: progress trackers and drop
    windows must not mix across shards, whose pools step different tenants
    on different meshes. :meth:`observe` scans every live shard and returns
    ``(shard_id, event)`` pairs; a shard that dies between steps drops out
    of the scan (its watchdog state is kept in case the shard index is
    later recovered onto a replacement pool).
    """

    def __init__(self, cfg: WatchdogConfig | None = None):
        self.cfg = cfg or WatchdogConfig()
        self._per_shard: dict[int, Watchdog] = {}

    def shard_watchdog(self, shard_id: int) -> Watchdog:
        if shard_id not in self._per_shard:
            self._per_shard[shard_id] = Watchdog(self.cfg)
        return self._per_shard[shard_id]

    def observe(self, fleet) -> list[tuple[int, FaultEvent]]:
        events: list[tuple[int, FaultEvent]] = []
        for i in fleet.live_shards():
            wd = self.shard_watchdog(i)
            events.extend((i, ev) for ev in wd.observe(fleet.pools[i]))
        return events

    def link_drop_rate(self) -> float:
        """Worst windowed link-drop rate across shards (the fleet's health
        is gated by its sickest shard, not the average)."""
        rates = [w.link_drop_rate() for w in self._per_shard.values()]
        return max(rates) if rates else 0.0


@dataclasses.dataclass(frozen=True)
class ReplacementConfig:
    """Thresholds and hysteresis for profile-guided re-placement.

    ``drift_threshold`` is a total-variation distance in ``[0, 1]`` between
    the observed (cluster, cluster) traffic matrix and the compile-time
    assumption. ``min_steps`` is the observation a judgement needs, and
    ``cooldown_steps`` spaces consecutive swaps (the observation window
    also restarts at every swap).
    """

    drift_threshold: float = 0.25  # TV distance observed vs assumed -> swap
    min_steps: int = 16  # observed pool steps before drift is judged
    cooldown_steps: int = 32  # pool steps between consecutive swaps
    anneal_steps: int | None = None  # optimize_placement budget (None = auto)
    seed: int = 0  # annealer seed (the swap is deterministic given the profile)


class ReplacementController:
    """Closes the loop: observed traffic -> new placement -> live swap.

    Watches a pool's :class:`~repro_torch.core.compiler.TrafficProfile` (the
    pool's engine must be built with ``fabric_options={"per_link_stats":
    True}``) and, when the observed delivery matrix of :attr:`current`
    drifts past ``drift_threshold`` from the uniform compile-time
    assumption, re-runs ``optimize_placement`` on the measured matrix.

    The swap is the bit-exact rung of the §15/§16 ladder: the new placement
    is loaded as a fresh model version (``name@r1``, ``name@r2``, ...)
    through :meth:`AerSessionPool.load_model`, on tiles no resident model
    occupies. Sessions in flight keep serving on the old version (a slot's
    spikes live in its model's slab), new admissions go to :attr:`current`
    (:meth:`retarget`), and :meth:`drain_retired` unloads an old version
    once its sessions are gone. Without enough free tiles the rung is
    infeasible and :meth:`maybe_replace` raises, pointing at
    :func:`migrate_pool`.
    """

    def __init__(self, pool: AerSessionPool, model: str | None = None,
                 cfg: ReplacementConfig | None = None):
        self.pool = pool
        self.cfg = cfg or ReplacementConfig()
        if pool.profile is None:
            raise ValueError(
                "pool has no traffic profile — build the engine with "
                'fabric_options={"per_link_stats": True}'
            )
        if model is None:
            if len(pool.models) != 1:
                raise ValueError(
                    f"multi-model pool: pass model= explicitly (have {list(pool.models)})"
                )
            model = next(iter(pool.models))
        elif model not in pool.models:
            raise ValueError(f"model {model!r} is not resident (have {list(pool.models)})")
        self.base = model  # versions are named f"{base}@r{n}"
        self.current = model  # where new admissions go
        self.version = 0
        self.retired: list[str] = []  # old versions awaiting drain
        self.history: list[dict] = []  # one record per swap
        self._last_swap_step = -(10**9)
        self._stamp_effective_placements()

    # -- placement bookkeeping -------------------------------------------
    def _fabric(self):
        return self.pool.engine.fabric_backend.fabric

    def _stamp_effective_placements(self) -> None:
        """Give every resident model an explicit ``tile_of_cluster``.

        ``concat_tables`` composes placements all or none, so the versioned
        swap needs every resident placed. A model compiled without one runs
        on its slice of the engine's default placement; stamping that slice
        changes no routing.
        """
        pool = self.pool
        if all(m.tables.tile_of_cluster is not None for m in pool.models.values()):
            return
        engine = pool.engine
        tiles = engine.fabric_backend.tile_of_cluster
        if tiles is None:
            tiles = default_tile_of_cluster(engine.n_clusters, self._fabric())
        tiles = np.asarray(tiles)
        for name, cc in pool.models.items():
            if cc.tables.tile_of_cluster is not None:
                continue
            slab = pool.slabs[name]
            placed = tiles[slab.cluster_lo:slab.cluster_hi].copy()
            pool.models[name] = dataclasses.replace(
                cc, tables=dataclasses.replace(cc.tables, tile_of_cluster=placed))

    def _occupied_tiles(self) -> np.ndarray:
        """Per-tile core occupancy over every resident model."""
        n_tiles = self._fabric().n_tiles
        count = np.zeros(n_tiles, dtype=np.int64)
        for cc in self.pool.models.values():
            toc = cc.tables.tile_of_cluster
            if toc is not None:
                count += np.bincount(np.asarray(toc), minlength=n_tiles)
        return count

    # -- observation ------------------------------------------------------
    def observed_matrix(self) -> np.ndarray:
        """Measured per-step (src, dst) cluster matrix of :attr:`current`,
        its slab of the pool's profile."""
        slab = self.pool.slabs[self.current]
        m = self.pool.profile.matrix()
        return m[slab.cluster_lo:slab.cluster_hi, slab.cluster_lo:slab.cluster_hi]

    def drift(self) -> float:
        """TV distance of the observed slab matrix from the compile-time
        uniform assumption, in ``[0, 1]`` (0.0 until traffic is observed)."""
        prof = self.pool.profile
        if prof is None or prof.steps == 0:
            return 0.0
        obs = self.observed_matrix()
        so = float(obs.sum())
        if so <= 0.0:
            return 0.0
        assumed = traffic_matrix(self.pool.models[self.current].tables)
        sa = float(assumed.sum())
        if sa <= 0.0:
            return 0.0
        return 0.5 * float(np.abs(obs / so - assumed / sa).sum())

    # -- the swap ---------------------------------------------------------
    def maybe_replace(self, force: bool = False) -> dict | None:
        """Judge drift and, past threshold, make the versioned swap.

        Returns a report (also appended to :attr:`history`) when a swap
        happened, else ``None``. ``force=True`` skips the drift and cooldown
        gates but still needs an observed matrix to optimize on.
        """
        cfg = self.cfg
        pool = self.pool
        prof = pool.profile
        if prof is None or prof.steps == 0:
            return None
        if not force:
            if prof.steps < cfg.min_steps:
                return None
            if pool.n_steps - self._last_swap_step < cfg.cooldown_steps:
                return None
        drift = self.drift()
        if not force and drift < cfg.drift_threshold:
            return None
        obs = self.observed_matrix()
        if float(obs.sum()) <= 0.0:
            return None

        fabric = self._fabric()
        cc = pool.models[self.current]
        nc = obs.shape[0]
        free = np.flatnonzero(self._occupied_tiles() == 0)
        if free.size * fabric.cores_per_tile < nc:
            raise RuntimeError(
                f"bit-exact re-placement needs {nc} free cores on unoccupied "
                f"tiles but only {free.size} tiles "
                f"({free.size * fabric.cores_per_tile} cores) are free — "
                "drain retired versions first, or fall back to migrate_pool "
                "(best-effort rung)"
            )
        # seed: pack the free tiles in order, cores_per_tile clusters each
        init = free[np.arange(nc) // fabric.cores_per_tile]
        allowed = np.zeros(fabric.n_tiles, dtype=bool)
        allowed[free] = True
        placement, info = optimize_placement(obs, fabric, init=init, seed=cfg.seed,
                                             anneal_steps=cfg.anneal_steps,
                                             allowed_tiles=allowed)
        # what the swap buys, measured on the same observed matrix
        h = tile_hop_matrix(fabric).astype(np.float64)
        cost_old = placement_cost(obs, h, np.asarray(cc.tables.tile_of_cluster))

        new_name = f"{self.base}@r{self.version + 1}"
        cc_new = dataclasses.replace(
            cc, tables=dataclasses.replace(cc.tables, tile_of_cluster=placement))
        pool.load_model(new_name, cc_new)  # restarts the observation window
        self.retired.append(self.current)
        self.current = new_name
        self.version += 1
        self._last_swap_step = pool.n_steps
        report = {
            "name": new_name,
            "step": pool.n_steps,
            "drift": drift,
            "placement": np.asarray(placement),
            "cost_observed_old": float(cost_old),
            "cost_observed_new": float(info["cost_final"]),
            "mean_hops_old": float(cost_old / obs.sum()),
            "mean_hops_new": float(info["mean_hops_final"]),
        }
        self.history.append(report)
        return report

    def retarget(self, sess: DvsSession) -> DvsSession:
        """Point a session not yet admitted at the newest version."""
        sess.model = self.current
        return sess

    def drain_retired(self) -> list[str]:
        """Unload retired versions with no live sessions; returns their names."""
        pool = self.pool
        unloaded = []
        for name in list(self.retired):
            if any(s is not None and s.model == name for s in pool.slots):
                continue
            pool.unload_model(name)
            self.retired.remove(name)
            unloaded.append(name)
        return unloaded
