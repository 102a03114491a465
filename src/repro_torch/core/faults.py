"""Declarative fault injection for the executable fabric (DESIGN.md §15).

Counterpart of ``repro.core.faults`` (numpy only; the port carries its own
copy so it never imports ``repro``). The draws are the reference's, in its
order, so fault masks and corrupted tables are byte-equal in both packages.

Real deployments of this architecture treat partial failure as a normal
operating condition: dead tiles, broken mesh links, lossy channels, stuck
cores, and corrupted CAM/SRAM words. This module is the single declarative
description of such a fault load (:class:`FaultSpec`) plus the *functional*
machinery that applies it:

  * **Topology faults** (dead tiles / dead directed mesh links / per-link
    stochastic drop rates) are resolved against the mesh's deterministic XY
    routes into per-tile-pair reachability and compound drop-rate matrices
    (:func:`tile_fault_matrices`), then gathered through the placement into
    per-cluster-pair form (:func:`pair_fault_matrices`). ``routing.
    build_delivery_model(..., faults=...)`` stores them on the delivery
    model, and the per-SRAM-entry liveness mask (:func:`entry_alive_mask`)
    feeds both fabric delivery paths — the ring fast path bakes it into the
    static entry table, the roll oracle threads it per step — so ring and
    roll stay bit-identical under faults. Fault-severed events are counted
    in ``DeliveryStats.link_dropped`` (a dead link is a zero-capacity link).
  * **Stochastic link loss** is modeled as route-level erasure: a link with
    drop rate ``p`` severs each SRAM entry routed across it independently
    with probability ``p`` (compounded along the XY path), drawn once from
    ``FaultSpec.seed`` — deterministic and bit-reproducible thereafter, so
    parity oracles and checkpointed resume stay exact under injected loss.
  * **Memory faults** (:func:`apply_table_faults`) flip bits of programmed
    CAM/SRAM words at compile output — downstream of the compiler, upstream
    of the engine — and :func:`fault_blast_radius` quantifies the damage
    against the ``dense_equivalent`` parity oracle (connections lost /
    gained / rewired).

Everything here is host-side numpy; nothing mutates shared state. A faulted
engine is just an engine built from a faulted model/tables.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import numpy as np

__all__ = [
    "FaultSpec",
    "mesh_links",
    "xy_path",
    "tile_fault_matrices",
    "pair_fault_matrices",
    "entry_alive_mask",
    "apply_table_faults",
    "fault_blast_radius",
]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault load against a :class:`~repro_torch.core.routing.Fabric`.

    ``dead_tiles`` — linear tile ids whose routers (and hosted cores) are
    gone: clusters placed there neither send nor receive, and XY routes
    *through* them are severed.
    ``dead_links`` — failed directed physical mesh links as adjacent
    ``(from_tile, to_tile)`` pairs; every cluster pair whose XY route uses
    the link becomes unreachable (zero capacity).
    ``link_drop_rate`` — stochastic per-event loss: a global float applied
    to every directed link, or a mapping ``{(from, to): p}``; rates
    compound along multi-hop XY paths.
    ``stuck_clusters`` — cores whose output bus is stuck: no routed events
    leave them (their neurons still integrate external input).
    ``cam_bit_flips`` / ``sram_bit_flips`` — number of single-bit
    corruptions injected into programmed CAM / SRAM words at compile output
    (:func:`apply_table_faults`).
    ``seed`` — drives both the Bernoulli route erasure and the bit-flip
    positions; same spec + same seed = bit-identical fault load.
    """

    dead_tiles: tuple[int, ...] = ()
    dead_links: tuple[tuple[int, int], ...] = ()
    link_drop_rate: float | Mapping[tuple[int, int], float] = 0.0
    stuck_clusters: tuple[int, ...] = ()
    cam_bit_flips: int = 0
    sram_bit_flips: int = 0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "dead_tiles", tuple(int(t) for t in self.dead_tiles))
        object.__setattr__(
            self,
            "dead_links",
            tuple((int(a), int(b)) for a, b in self.dead_links),
        )
        object.__setattr__(
            self, "stuck_clusters", tuple(int(c) for c in self.stuck_clusters)
        )
        if self.cam_bit_flips < 0 or self.sram_bit_flips < 0:
            raise ValueError("bit-flip counts must be non-negative")
        if not isinstance(self.link_drop_rate, Mapping):
            rate = float(self.link_drop_rate)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"link_drop_rate {rate} outside [0, 1]")
        else:
            for link, rate in self.link_drop_rate.items():
                if not 0.0 <= float(rate) <= 1.0:
                    raise ValueError(f"link_drop_rate[{link}]={rate} outside [0, 1]")

    # ------------------------------------------------------------------
    @property
    def routes_faulted(self) -> bool:
        """True when the spec affects event routing (not just table words)."""
        has_rate = (
            bool(self.link_drop_rate)
            if isinstance(self.link_drop_rate, Mapping)
            else float(self.link_drop_rate) > 0.0
        )
        return bool(self.dead_tiles or self.dead_links or self.stuck_clusters or has_rate)

    def validate(self, fabric) -> None:
        """Check tile ids and link adjacency against a fabric geometry."""
        for t in self.dead_tiles:
            if not 0 <= t < fabric.n_tiles:
                raise ValueError(
                    f"dead tile {t} out of range ({fabric.n_tiles} tiles)"
                )
        links = set(mesh_links(fabric))
        named = list(self.dead_links)
        if isinstance(self.link_drop_rate, Mapping):
            named += [tuple(k) for k in self.link_drop_rate]
        for link in named:
            if tuple(link) not in links:
                raise ValueError(
                    f"link {link} is not a directed adjacent mesh link of a "
                    f"{fabric.grid_x}x{fabric.grid_y} fabric"
                )

    def rate_of(self, link: tuple[int, int]) -> float:
        if isinstance(self.link_drop_rate, Mapping):
            return float(self.link_drop_rate.get(tuple(link), 0.0))
        return float(self.link_drop_rate)


# ---------------------------------------------------------------------------
# Topology: XY routes vs the fault set
# ---------------------------------------------------------------------------
def mesh_links(fabric) -> list[tuple[int, int]]:
    """All directed adjacent (from_tile, to_tile) physical mesh links."""
    links = []
    for t in range(fabric.n_tiles):
        x, y = fabric.tile_xy(t)
        if x + 1 < fabric.grid_x:
            r = t + 1
            links += [(t, r), (r, t)]
        if y + 1 < fabric.grid_y:
            d = t + fabric.grid_x
            links += [(t, d), (d, t)]
    return links


def xy_path(fabric, t_src: int, t_dst: int) -> list[tuple[int, int]]:
    """Directed physical links on the deterministic X-then-Y route."""
    sx, sy = fabric.tile_xy(t_src)
    dx, dy = fabric.tile_xy(t_dst)
    path = []
    x, y = sx, sy
    step_x = 1 if dx > sx else -1
    while x != dx:
        nxt = x + step_x
        path.append((y * fabric.grid_x + x, y * fabric.grid_x + nxt))
        x = nxt
    step_y = 1 if dy > sy else -1
    while y != dy:
        nxt = y + step_y
        path.append((y * fabric.grid_x + x, nxt * fabric.grid_x + x))
        y = nxt
    return path


def tile_fault_matrices(fabric, spec: FaultSpec) -> tuple[np.ndarray, np.ndarray]:
    """Per-ordered-tile-pair ``(alive [T,T] bool, drop_rate [T,T] float64)``.

    A pair is dead when either endpoint tile is dead, any intermediate tile
    on the XY route is dead, or any link on the route is in ``dead_links``.
    The stochastic rate compounds along the route:
    ``1 - prod(1 - p_link)``. The diagonal is alive (rate 0) unless the
    tile itself is dead.
    """
    spec.validate(fabric)
    n = fabric.n_tiles
    dead_tiles = set(spec.dead_tiles)
    dead_links = set(spec.dead_links)
    alive = np.ones((n, n), dtype=bool)
    rate = np.zeros((n, n), dtype=np.float64)
    for a in range(n):
        for b in range(n):
            if a in dead_tiles or b in dead_tiles:
                alive[a, b] = False
                continue
            survive = 1.0
            for link in xy_path(fabric, a, b):
                if link in dead_links or link[1] in dead_tiles:
                    alive[a, b] = False
                    break
                survive *= 1.0 - spec.rate_of(link)
            else:
                rate[a, b] = 1.0 - survive
    return alive, rate


def pair_fault_matrices(
    fabric, tile_of_cluster: np.ndarray, spec: FaultSpec
) -> tuple[np.ndarray, np.ndarray]:
    """Cluster-pair ``(alive [nc,nc] bool, drop_rate [nc,nc] float32)``.

    Gathers the tile matrices through the placement and severs every route
    *out of* a stuck cluster (its output bus is stuck; delivery to it still
    works — external input bypasses the R1 output arbiter, Fig. 7).
    """
    tiles = np.asarray(tile_of_cluster)
    t_alive, t_rate = tile_fault_matrices(fabric, spec)
    alive = t_alive[tiles[:, None], tiles[None, :]].copy()
    rate = t_rate[tiles[:, None], tiles[None, :]].astype(np.float32)
    for c in spec.stuck_clusters:
        if not 0 <= c < tiles.shape[0]:
            raise ValueError(f"stuck cluster {c} out of range ({tiles.shape[0]})")
        alive[c, :] = False
    return alive, rate


def entry_alive_mask(
    src_tag: np.ndarray,  # [N, E] int32, -1 = empty
    src_dest: np.ndarray,  # [N, E] int32 destination cluster ids
    cluster_size: int,
    model,  # routing.FabricDeliveryModel with pair_alive/pair_drop_rate set
) -> np.ndarray | None:
    """Static per-SRAM-entry liveness ``[N, E]`` bool, or ``None`` (healthy).

    The one fault mask both fabric delivery paths consume: the ring fast
    path bakes it into the static entry table (a severed entry always drops
    and is counted in ``link_dropped``), the roll oracle gathers it per
    queued event. Entries on dead pairs are deterministically severed;
    entries on lossy pairs are severed i.i.d. with the pair's compound
    drop rate, drawn once from ``FaultSpec.seed`` (route-level erasure —
    see the module docstring). Empty entries stay "alive" (they carry no
    events, so liveness is moot and the mask stays congruent with
    ``valid``-style filtering downstream).
    """
    if model.pair_alive is None:
        return None
    src_tag = np.asarray(src_tag)
    src_dest = np.asarray(src_dest)
    n, e = src_tag.shape
    nc = model.pair_alive.shape[0]
    src_cl = (np.arange(n) // cluster_size)[:, None]
    dst_cl = np.clip(src_dest, 0, nc - 1)
    alive = model.pair_alive[np.broadcast_to(src_cl, (n, e)), dst_cl].copy()
    rate = model.pair_drop_rate[np.broadcast_to(src_cl, (n, e)), dst_cl]
    if (rate > 0).any():
        seed = model.faults.seed if model.faults is not None else 0
        u = np.random.default_rng(seed).random((n, e))
        alive &= u >= rate
    alive[src_tag < 0] = True
    return alive


# ---------------------------------------------------------------------------
# Memory faults: CAM/SRAM bit corruption at compile output
# ---------------------------------------------------------------------------
def _flip_words(rng, table, n_flips, n_bits, clip_max):
    """Flip ``n_flips`` random bits in occupied entries of ``table`` (copy)."""
    out = np.array(table, dtype=np.int32, copy=True)
    occ = np.argwhere(out >= 0)
    flips = []
    if occ.size == 0 or n_flips == 0 or n_bits == 0:
        return out, flips
    for _ in range(n_flips):
        r, c = occ[int(rng.integers(occ.shape[0]))]
        bit = int(rng.integers(n_bits))
        old = int(out[r, c])
        new = min(old ^ (1 << bit), clip_max)
        out[r, c] = new
        flips.append({"pos": (int(r), int(c)), "bit": bit, "old": old, "new": new})
    return out, flips


def apply_table_faults(tables, spec: FaultSpec):
    """Inject ``spec``'s bit corruptions into compiled routing tables.

    Returns ``(corrupted RoutingTables, report)`` where the report lists
    every flip (table, position, bit, old/new word). Only *programmed*
    words are corrupted — an empty CAM/SRAM slot has no stored word to
    flip. CAM flips hit ``cam_tag`` (the match field: a flipped tag either
    deafens the synapse or re-aims it at another tag); SRAM flips alternate
    between ``src_tag`` (the emitted tag) and ``src_dest`` (the target
    cluster — a flipped dest bit physically misroutes the event). Flipped
    words are clipped into their field's range so the corrupted tables stay
    loadable. Purely functional: the input tables are untouched.
    """
    rng = np.random.default_rng([spec.seed, 0xFA017])
    tag_bits = max(1, math.ceil(math.log2(max(2, tables.k_tags))))
    dest_bits = max(1, math.ceil(math.log2(max(2, tables.n_clusters))))
    cam_tag, cam_flips = _flip_words(
        rng, tables.cam_tag, spec.cam_bit_flips, tag_bits, tables.k_tags - 1
    )
    n_dest = spec.sram_bit_flips // 2
    src_tag, sram_tag_flips = _flip_words(
        rng, tables.src_tag, spec.sram_bit_flips - n_dest, tag_bits,
        tables.k_tags - 1,
    )
    # dest words are only meaningful where the entry is programmed — mask
    # unprogrammed rows to -1 for occupancy selection, then restore
    dest_occ = np.where(np.asarray(tables.src_tag) >= 0, tables.src_dest, -1)
    src_dest_f, sram_dest_flips = _flip_words(
        rng, dest_occ, n_dest, dest_bits, tables.n_clusters - 1
    )
    src_dest = np.where(
        np.asarray(tables.src_tag) >= 0, src_dest_f, tables.src_dest
    ).astype(np.int32)
    report = (
        [{"table": "cam_tag", **f} for f in cam_flips]
        + [{"table": "src_tag", **f} for f in sram_tag_flips]
        + [{"table": "src_dest", **f} for f in sram_dest_flips]
    )
    corrupted = dataclasses.replace(
        tables, cam_tag=cam_tag, src_tag=src_tag, src_dest=src_dest
    )
    return corrupted, report


def fault_blast_radius(before, after) -> dict:
    """Parity-oracle damage report between two routing tables.

    Compares the ``dense_equivalent`` connection multisets: how many
    (src, dst, syn) connections the corruption removed, added, and kept.
    """
    from collections import Counter

    b = Counter(map(tuple, before.dense_equivalent()))
    a = Counter(map(tuple, after.dense_equivalent()))
    lost = sum((b - a).values())
    gained = sum((a - b).values())
    total = sum(b.values())
    return {
        "connections_before": total,
        "connections_lost": lost,
        "connections_gained": gained,
        "connections_kept": total - lost,
        "blast_fraction": (lost + gained) / total if total else 0.0,
    }
