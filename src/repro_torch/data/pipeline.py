"""DVS event streams for the AER serving path (paper §V poker symbols).

Counterpart of the DVS part of ``repro.data.pipeline``. Numpy only:
``DvsStreamSource.events(step)`` is a pure function of (seed, session_id,
step) through ``np.random.default_rng([seed, session, step])``, so a slot
evicted and re-admitted replays the identical event sequence, and the
streams are bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["symbol_dvs_events", "DvsStreamConfig", "DvsStreamSource"]


def symbol_dvs_events(
    symbol: int, n_events: int, rng, input_hw: int = 32, jitter: float = 1.0
) -> np.ndarray:
    """Synthetic DVS event cloud for one poker-suit flash: ``[n_events, 2]``
    (y, x) rows on a ``input_hw x input_hw`` sensor.

    0 = vertical bar (diamond edge), 1 = horizontal bar (club), 2 = upward
    vertex (spade), 3 = downward vertex (heart).
    """
    if not 0 <= symbol < 4:
        raise ValueError(f"symbol must be in [0, 4), got {symbol}")
    s = input_hw / 32.0  # geometry scales with sensor resolution
    if symbol == 0:
        ys = rng.integers(int(6 * s), int(26 * s), n_events)
        xs = 15 * s + rng.normal(0, jitter, n_events)
    elif symbol == 1:
        xs = rng.integers(int(6 * s), int(26 * s), n_events)
        ys = 15 * s + rng.normal(0, jitter, n_events)
    elif symbol == 2:
        t = rng.uniform(-1, 1, n_events)
        xs = 16 * s + t * 10 * s + rng.normal(0, jitter, n_events)
        ys = 8 * s + np.abs(t) * 14 * s
    else:
        t = rng.uniform(-1, 1, n_events)
        xs = 16 * s + t * 10 * s + rng.normal(0, jitter, n_events)
        ys = 24 * s - np.abs(t) * 14 * s
    hi = input_hw - 1
    return np.stack(
        [np.clip(ys, 0, hi).astype(np.int64), np.clip(xs, 0, hi).astype(np.int64)], 1
    )


@dataclasses.dataclass(frozen=True)
class DvsStreamConfig:
    """One tenant's synthetic DVS stream (a user holding a card to a sensor)."""

    symbol: int  # poker suit in [0, 4)
    events_per_step: int = 16  # sensor events per engine timestep
    input_hw: int = 32
    jitter: float = 1.0
    seed: int = 0


class DvsStreamSource:
    """Stateless per-session DVS stream: ``events(step)`` is a pure function."""

    def __init__(self, cfg: DvsStreamConfig, session_id: int = 0):
        self.cfg = cfg
        self.session_id = int(session_id)

    def events(self, step: int) -> np.ndarray:
        """DVS events ``[events_per_step, 2]`` emitted during ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, self.session_id, int(step)])
        return symbol_dvs_events(
            cfg.symbol, cfg.events_per_step, rng, cfg.input_hw, cfg.jitter
        )
