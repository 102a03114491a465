"""Serving health: watchdog, typed fault events, and the resilient drain loop.

Counterpart of ``repro.serve.health`` for the single-model pool, with the
reference's event kinds, messages, hysteresis and backoff. Degraded-mode
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

``FleetWatchdog`` (sharded pools) waits for the ROADMAP item
"Multi-device", and ``ReplacementConfig`` / ``ReplacementController`` (the
live versioned swap, which needs ``load_model`` / ``unload_model``) for
"Multi-model": they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

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
    copied: the new engine's lanes start with a clean record. The mechanics
    live in :meth:`AerSessionPool.clone_onto`.
    """
    return pool.clone_onto(new_engine, cfg)


class FleetWatchdog:
    """Health scan over a sharded session pool: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FleetWatchdog watches a sharded session pool, which comes with the "
            "ROADMAP item 'Multi-device'"
        )


class ReplacementConfig:
    """Thresholds of profile-guided live re-placement: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ReplacementConfig configures the live versioned swap, which needs "
            "load_model / unload_model and comes with the ROADMAP item 'Multi-model'"
        )


class ReplacementController:
    """Observed traffic -> new placement -> live swap: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ReplacementController swaps a new model version in under live "
            "sessions; it needs load_model / unload_model and comes with the "
            "ROADMAP item 'Multi-model'"
        )
