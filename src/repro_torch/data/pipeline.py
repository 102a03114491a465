"""Deterministic, resumable token sources for training, and DVS event streams
for the AER serving path (paper §V poker symbols).

The port of ``repro.data.pipeline``. Every source's ``batch(step)`` /
``events(step)`` is a pure function of its seed and the step counter, never
of consumed state, so a restarted job continues from ``step`` with the
same batches:

* ``SyntheticSource``: ``batch(step)`` draws tokens in ``[0, vocab)`` from a
  ``torch.Generator`` seeded from (seed, step, host_id); ``repro`` draws from
  ``jax.random`` (threefry), so the two packages' tokens differ, as their
  random inits do;
* ``FileSource``: a memory-mapped flat token file (uint16 / uint32), rows
  strided by (host, step): numpy only, byte-equal to ``repro``'s;
* ``DvsStreamSource``: ``events(step)`` through ``np.random.default_rng([seed,
  session, step])``, bit-identical to ``repro``'s, so a slot evicted and
  re-admitted replays the identical event sequence.

``labels`` are ``tokens`` shifted by one; a batch is ``{"tokens", "labels"}``,
int32 numpy arrays ``[global_batch / n_hosts, seq_len]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "DataConfig", "DvsStreamConfig", "DvsStreamSource", "FileSource", "SyntheticSource",
    "make_source", "symbol_dvs_events",
]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    path: str | None = None  # file-backed when set
    token_dtype: str = "uint16"


class SyntheticSource:
    """Stateless synthetic LM data: ``batch(step)`` is a pure function of
    (seed, step, host_id)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        assert cfg.global_batch % n_hosts == 0
        self.local_batch = cfg.global_batch // n_hosts

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        seed = np.random.SeedSequence([cfg.seed, int(step), self.host_id]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(seed))
        toks = torch.randint(0, cfg.vocab, (self.local_batch, cfg.seq_len + 1), generator=gen,
                             dtype=torch.int32).numpy()
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FileSource:
    """Flat-token-file source; cursor = f(step), never mutable state."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self.tokens = np.memmap(cfg.path, dtype=np.dtype(cfg.token_dtype), mode="r")
        self.n_tokens = len(self.tokens)
        self.samples = self.n_tokens // (cfg.seq_len + 1)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        sl = cfg.seq_len + 1
        base = step * cfg.global_batch + self.host_id * self.local_batch
        idx = (base + np.arange(self.local_batch)) % self.samples
        rows = np.stack([self.tokens[i * sl : (i + 1) * sl] for i in idx]).astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_source(cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
    if cfg.path:
        return FileSource(cfg, host_id, n_hosts)
    return SyntheticSource(cfg, host_id, n_hosts)


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
