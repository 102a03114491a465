"""Routing compiler v2: tag-reuse allocation + traffic-aware placement.

Counterpart of ``repro.core.compiler``, host-side numpy, byte-equal to the
reference for the same inputs: tag numbers, placements (the annealer draws
from ``np.random.default_rng(seed)`` in the reference's order and adds its
float64 deltas in the reference's order), reports, artifact files and
fingerprints. ``repair_placement`` needs fault injection and raises
``NotImplementedError`` until the faults slice of the port.

The paper's Appendix A argues two optimizations make two-stage tag routing
deployable: *tag re-assignment* (reusing the per-cluster tag space so K stays
bounded) and *clustered placement* (keeping traffic below the R3 mesh —
Table IV's ~2.1x mean-hop advantage). The v1 compiler (core/tags.py) does
neither: it burns a fresh tag per allocation unit until K is exhausted and
places clusters linearly. This module adds both, plus a compile report, while
staying **bit-exact**: a network compiled with v2 realizes the identical
dense connectivity (multiset of (src, dst, syn) connections, multiplicity
included) and delivers the identical spike-by-spike trajectory whenever no
events are dropped (tests/test_torch_compiler.py holds the port to the
reference and to the dense oracle). Two capacity caveats are inherent to
doing *less* work: the AER output queue compacts active sources — not SRAM
entries — so queue-overflow drops are identical
under v1 and v2 tables; inter-tile link FIFOs, however, count routed
entries, and a reuse-merged source emits fewer of them, so under finite
link capacity v2 presents strictly less load and the surviving-event set
(always the lowest-source-id prefix per link) can differ from v1's.

Tag-reuse allocation (DESIGN.md §13)
------------------------------------
Broadcast semantics make most tag sharing unsound: an event (tag t, cluster
c) reaches *every* CAM word matching t in c, so merging two units' tags
cross-wires their sources into each other's audiences. The only merge that
is exact is between units with **identical source sets**: each shared source
then emits ONE event where it used to emit several, and the destination's
(unchanged, separately kept) CAM words still fire exactly the same multiset
of pulses. We therefore build, per cluster, a conflict graph whose vertices
are allocation units and whose edges join units with *different* source sets
(merging them would create cross-talk), and greedily color it — same color =
same tag. Because "identical source set" is an equivalence relation the
conflict graph is a disjoint union of cliques-complement, so greedy coloring
is exactly optimal for this compatibility relation: tags per cluster =
number of distinct source sets, always <= v1's unit count, and SRAM entries
(deduped per (source, tag, cluster)) and CAM words never exceed v1's.

Traffic-aware placement
-----------------------
``optimize_placement`` minimizes expected hop-weighted mesh traffic
``sum_{a,b} T[a,b] * H[tile(a), tile(b)]`` (T from per-neuron rates x SRAM
entries, H the XY-mesh hop matrix of routing.tile_hop_matrix) over
cluster->tile maps subject to ``validate_placement`` capacity, via simulated
annealing over pairwise swaps/relocations with a greedy-refinement finish,
seeded from the hierarchical-linear default — a classic QAP local search
with O(n_clusters) incremental cost deltas. ``device_slabs`` restricts moves
so each tile's clusters stay inside one contiguous cluster slab, which is
exactly the constraint the sharded fabric step (tiles -> devices,
DESIGN.md §11) enforces — optimized placements then run multi-device as-is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Sequence

import numpy as np

from repro_torch.core import memory_model as mm
from repro_torch.core.routing import (
    Fabric,
    build_delivery_model,
    default_tile_of_cluster,
    tile_hop_matrix,
    validate_placement,
)
from repro_torch.core.tags import (
    AllocUnit,
    NetworkSpec,
    RoutingTables,
    compile_network,
    expand_units,
)

__all__ = [
    "CompileReport",
    "CompileResult",
    "Geometry",
    "FeasibilityReport",
    "InfeasibleGeometryError",
    "CompiledArtifact",
    "allocate_tags_reuse",
    "traffic_matrix",
    "TrafficProfile",
    "placement_cost",
    "optimize_placement",
    "device_slab_placement",
    "session_rate",
    "repair_placement",
    "build_report",
    "compile_network_v2",
    "artifact_from_tables",
    "retarget",
]


# ---------------------------------------------------------------------------
# tag-reuse allocation: conflict-graph coloring
# ---------------------------------------------------------------------------
def allocate_tags_reuse(spec: NetworkSpec, units: list[AllocUnit]):
    """Color each cluster's unit conflict graph: ``(tags, tags_used)``.

    Two units conflict (must take different tags) unless their source sets
    are identical — the only bit-exact merge under broadcast semantics (see
    module docstring). Greedy first-fit coloring in unit order; since the
    no-conflict relation is an equivalence, first-fit is optimal: each
    distinct (cluster, source-set) key gets the next free tag of its
    cluster, and later units with the same key reuse it. Raises the v2
    tag-overflow diagnostic naming the cluster and the binding constraint.
    """
    tags: list[int] = []
    tags_used = np.zeros(spec.n_clusters, dtype=np.int64)
    color_of_key: dict[tuple[int, tuple[int, ...]], int] = {}
    for u in units:
        key = (u.cluster, u.sources)
        color = color_of_key.get(key)
        if color is None:
            color = int(tags_used[u.cluster])
            if color >= spec.k_tags:
                raise ValueError(
                    f"tag overflow in cluster {u.cluster}: K={spec.k_tags} "
                    f"exhausted even with tag reuse — the cluster's CAM "
                    f"audience needs {color + 1}+ distinct source sets "
                    "(binding constraint: tags per cluster); increase alpha "
                    "(more tags) or re-cluster the network (Appendix A)"
                )
            tags_used[u.cluster] += 1
            color_of_key[key] = color
        tags.append(color)
    return tags, tags_used


# ---------------------------------------------------------------------------
# traffic model + placement optimization
# ---------------------------------------------------------------------------
def traffic_matrix(
    tables: RoutingTables, rates: np.ndarray | Sequence[float] | None = None
) -> np.ndarray:
    """Expected inter-cluster event traffic ``T[src_cluster, dst_cluster]``.

    Every occupied SRAM entry of neuron ``s`` is one AER event per spike of
    ``s``, so the expected events/s from cluster a to cluster b is the sum of
    ``rates[s]`` over entries ``(s -> b)`` with ``s`` in ``a``. ``rates``
    defaults to uniform (1.0 per neuron) — the placement objective then
    weights every SRAM entry equally, matching the fabric stats' per-entry
    hop accounting under all-sources-spiking traffic.
    """
    src_tag = np.asarray(tables.src_tag)
    src_dest = np.asarray(tables.src_dest)
    n = tables.n_neurons
    if rates is None:
        rates = np.ones(n, dtype=np.float64)
    else:
        rates = np.asarray(rates, dtype=np.float64)
        if rates.shape != (n,):
            raise ValueError(f"rates has shape {rates.shape}, expected ({n},)")
    src, ent = np.nonzero(src_tag >= 0)
    t = np.zeros((tables.n_clusters, tables.n_clusters), dtype=np.float64)
    np.add.at(t, (src // tables.cluster_size, src_dest[src, ent]), rates[src])
    return t


@dataclasses.dataclass
class TrafficProfile:
    """Measured inter-cluster traffic, accumulated from per-link DeliveryStats.

    The feedback half of the measure→optimize→recompile loop (DESIGN.md
    §18): a fabric engine built with ``per_link_stats`` emits ``delivered``
    per (src_cluster, dst_cluster) pair and ``link_dropped`` per directed
    tile link; :meth:`observe` folds each step's stats in, and the
    accumulated :meth:`matrix` is the *empirical* counterpart of
    :func:`traffic_matrix` — under all-sources-spiking, drop-free traffic
    the two are equal entry for entry (each delivered SRAM entry is one
    unit of entry-weighted traffic; the conformance test locks this). Feed
    :meth:`matrix` straight into :func:`optimize_placement`, or
    :meth:`rates` into :func:`traffic_matrix` when the tables' entry
    structure should re-derive the matrix.
    """

    n_clusters: int
    n_tiles: int
    pair_delivered: np.ndarray  # [nc, nc] cumulative delivered events
    link_dropped: np.ndarray  # [T, T] cumulative per-directed-link drops
    dropped: float = 0.0  # cumulative AER-queue drops
    steps: int = 0  # observed engine steps
    last: np.ndarray | None = None  # most recent observation's [nc, nc]

    @classmethod
    def empty(cls, n_clusters: int, n_tiles: int) -> "TrafficProfile":
        return cls(
            n_clusters=int(n_clusters),
            n_tiles=int(n_tiles),
            pair_delivered=np.zeros((n_clusters, n_clusters), dtype=np.float64),
            link_dropped=np.zeros((n_tiles, n_tiles), dtype=np.float64),
        )

    def observe(self, stats, steps: int = 1) -> None:
        """Fold one step's (or one stacked run's) per-link DeliveryStats in.

        ``stats.delivered`` must be the per-pair ``[..., nc*nc]`` form and
        ``stats.link_dropped`` the per-link ``[..., T*T]`` form — leading
        batch/time axes are summed (every stream shares the fabric).
        ``steps`` is how many engine steps the observation spans.
        """
        nc, t = self.n_clusters, self.n_tiles
        d = np.asarray(stats.delivered)
        if d.ndim == 0 or d.shape[-1] != nc * nc:
            raise ValueError(
                f"delivered has shape {d.shape}, expected [..., {nc * nc}] — "
                "was the engine built with per_link_stats?"
            )
        pair = d.reshape(-1, nc * nc).sum(0).astype(np.float64).reshape(nc, nc)
        ld = np.asarray(stats.link_dropped)
        if ld.ndim == 0 or ld.shape[-1] != t * t:
            raise ValueError(
                f"link_dropped has shape {ld.shape}, expected [..., {t * t}] — "
                "was the engine built with per_link_stats?"
            )
        self.pair_delivered += pair
        self.last = pair
        self.link_dropped += (
            ld.reshape(-1, t * t).sum(0).astype(np.float64).reshape(t, t)
        )
        self.dropped += float(np.asarray(stats.dropped).sum())
        self.steps += int(steps)

    @property
    def total_link_dropped(self) -> float:
        return float(self.link_dropped.sum())

    def matrix(self) -> np.ndarray:
        """Observed traffic ``[nc, nc]`` in events per step (empirical
        :func:`traffic_matrix`)."""
        return self.pair_delivered / max(self.steps, 1)

    def rates(self, tables: RoutingTables) -> np.ndarray:
        """Per-neuron empirical rate vector for :func:`traffic_matrix`.

        The fabric observes traffic per *cluster pair*, so the estimate is
        uniform within a source cluster: the cluster's observed events per
        step spread over its occupied SRAM entries. Exact whenever spiking
        is uniform within each cluster (e.g. the conformance workload);
        otherwise the best rank-respecting estimate the stats carry.
        """
        entries = (np.asarray(tables.src_tag) >= 0).sum(1).astype(np.float64)
        cs = tables.cluster_size
        per_cluster = entries.reshape(self.n_clusters, cs).sum(1)
        row = self.pair_delivered.sum(1) / max(self.steps, 1)
        r = np.divide(
            row, per_cluster, out=np.zeros_like(row), where=per_cluster > 0
        )
        return np.repeat(r, cs)

    def drift(self, assumed: np.ndarray) -> float:
        """Total-variation distance between the observed and assumed traffic
        distributions, in ``[0, 1]`` (0 = identical shape, 1 = disjoint).
        Returns 0.0 while either side is empty — no evidence, no drift."""
        obs = self.pair_delivered
        a = np.asarray(assumed, dtype=np.float64)
        if a.shape != obs.shape:
            raise ValueError(f"assumed has shape {a.shape}, expected {obs.shape}")
        so, sa = obs.sum(), a.sum()
        if so <= 0 or sa <= 0:
            return 0.0
        return float(0.5 * np.abs(obs / so - a / sa).sum())


def placement_cost(
    traffic: np.ndarray, hop_matrix: np.ndarray, placement: np.ndarray
) -> float:
    """Hop-weighted traffic ``sum_{a,b} T[a,b] * H[p[a], p[b]]``."""
    p = np.asarray(placement)
    return float((traffic * hop_matrix[p[:, None], p[None, :]]).sum())


def _swap_delta(s, h, p, i, j):
    """Cost change of swapping the tiles of clusters i and j (O(n_clusters)).

    ``s`` is the symmetrized traffic ``T + T.T`` so one row per cluster
    carries both directions; the k=i / k=j self terms are excluded (their
    hop contribution is invariant under the swap because H is symmetric)."""
    hpi, hpj = h[p[i]][p], h[p[j]][p]
    v = hpj - hpi
    delta = float((s[i] - s[j]) @ v)
    delta -= float((s[i, i] - s[j, i]) * v[i] + (s[i, j] - s[j, j]) * v[j])
    return delta


def _move_delta(s, h, p, i, t):
    """Cost change of relocating cluster i to tile t (O(n_clusters)).

    The self term needs care: after the move, cluster i's own-traffic hop
    count is H[t, t] = 0 (it moved *with* itself), not H[t, p_old[i]]."""
    d = float(s[i] @ (h[t][p] - h[p[i]][p]))
    return d - float(s[i, i] * h[t][p[i]])


def optimize_placement(
    traffic: np.ndarray,
    fabric,
    *,
    init: np.ndarray | None = None,
    seed: int = 0,
    anneal_steps: int | None = None,
    device_slabs: int | None = None,
    hop_matrix: np.ndarray | None = None,
    allowed_tiles: np.ndarray | None = None,
) -> tuple[np.ndarray, dict]:
    """Traffic-aware cluster->tile placement (simulated annealing + greedy).

    Minimizes :func:`placement_cost` subject to the fabric's per-tile core
    capacity, starting from ``init`` (default: the hierarchical linear
    placement). Returns ``(placement, info)`` where ``info`` records the
    initial/final cost and predicted mean hops per delivered event.

    ``hop_matrix`` overrides the fabric's XY-hop matrix as the objective —
    it must be symmetric (the incremental swap/move deltas assume it); the
    degraded-mode repair path (:func:`repair_placement`) passes a penalty
    matrix here so traffic is steered off dead links. ``allowed_tiles`` is
    a boolean ``[n_tiles]`` mask restricting the search (and ``init``,
    which must already comply) to live tiles.

    ``device_slabs=g`` restricts the search to placements where every tile's
    clusters lie inside one of ``g`` equal contiguous cluster slabs — the
    invariant the reference's ``EventEngine.make_sharded_step`` requires to
    map tiles onto ``g`` devices — by only swapping within a slab and
    relocating to tiles currently owned by the same slab (or empty). The
    seed placement must already satisfy it (the hierarchical linear default
    does whenever slabs align with whole tiles).

    Deterministic for a given ``seed``; annealing proposes random pairwise
    swaps (and relocations when tiles have spare capacity) with O(n_clusters)
    incremental deltas, then a greedy all-pairs refinement sweep runs until
    no improving swap remains.
    """
    traffic = np.asarray(traffic, dtype=np.float64)
    nc = traffic.shape[0]
    if traffic.shape != (nc, nc):
        raise ValueError(f"traffic must be square, got {traffic.shape}")
    p = validate_placement(fabric, nc, init).astype(np.int64).copy()
    if hop_matrix is None:
        h = tile_hop_matrix(fabric).astype(np.float64)
    else:
        h = np.asarray(hop_matrix, dtype=np.float64)
        if h.shape != (fabric.n_tiles, fabric.n_tiles):
            raise ValueError(
                f"hop_matrix has shape {h.shape}, expected "
                f"({fabric.n_tiles}, {fabric.n_tiles})"
            )
        if not np.array_equal(h, h.T):
            raise ValueError(
                "hop_matrix must be symmetric — the incremental swap/move "
                "deltas assume H[a, b] == H[b, a]"
            )
    allowed = None
    if allowed_tiles is not None:
        allowed = np.asarray(allowed_tiles, dtype=bool)
        if allowed.shape != (fabric.n_tiles,):
            raise ValueError(
                f"allowed_tiles has shape {allowed.shape}, expected "
                f"({fabric.n_tiles},)"
            )
        live_capacity = int(allowed.sum()) * fabric.cores_per_tile
        if live_capacity < nc:
            raise ValueError(
                f"{nc} clusters cannot fit on {int(allowed.sum())} live tiles "
                f"x {fabric.cores_per_tile} cores ({live_capacity} slots)"
            )
        if not allowed[p].all():
            bad = np.flatnonzero(~allowed[p])
            raise ValueError(
                f"init places clusters {bad.tolist()} on disallowed tiles "
                f"{np.unique(p[bad]).tolist()}"
            )
    s = traffic + traffic.T
    cost0 = placement_cost(traffic, h, p)
    total = float(traffic.sum())
    info = {
        "cost_init": cost0,
        "mean_hops_init": cost0 / total if total else 0.0,
    }

    slab_of = None
    if device_slabs is not None:
        if device_slabs <= 0 or nc % device_slabs:
            raise ValueError(
                f"device_slabs={device_slabs} must divide n_clusters={nc}"
            )
        slab_of = np.arange(nc) // (nc // device_slabs)
        tiles_of_slab = [set(p[slab_of == g]) for g in range(device_slabs)]
        for g in range(device_slabs):
            for g2 in range(g + 1, device_slabs):
                shared = tiles_of_slab[g] & tiles_of_slab[g2]
                if shared:
                    raise ValueError(
                        f"seed placement splits tiles {sorted(shared)} across "
                        f"device slabs {g} and {g2}"
                    )

    if nc >= 2 and fabric.n_tiles >= 2 and total > 0:
        rng = np.random.default_rng(seed)
        tile_count = np.bincount(p, minlength=fabric.n_tiles)
        # tile -> owning slab (-1 = empty), for the device_slabs constraint
        tile_owner = np.full(fabric.n_tiles, -1, dtype=np.int64)
        if slab_of is not None:
            tile_owner[p] = slab_of  # each tile has one owner by the check above
        steps = anneal_steps if anneal_steps is not None else 4000 + 250 * nc
        # temperature from the observed swap-delta scale
        probe = [
            abs(_swap_delta(s, h, p, *sorted(rng.choice(nc, 2, replace=False))))
            for _ in range(min(64, steps))
        ]
        t0 = max(1e-9, float(np.median([d for d in probe if d > 0] or [1.0])))
        t_end = t0 * 1e-3
        cool = (t_end / t0) ** (1.0 / max(1, steps))
        temp = t0
        for _ in range(steps):
            temp *= cool
            i = int(rng.integers(nc))
            spare = tile_count < fabric.cores_per_tile
            if allowed is not None:
                spare &= allowed
            if slab_of is not None:
                spare &= (tile_owner == -1) | (tile_owner == slab_of[i])
            do_move = spare.any() and rng.random() < 0.3
            if do_move:
                t = int(rng.choice(np.flatnonzero(spare)))
                if t == p[i]:
                    continue
                delta = _move_delta(s, h, p, i, t)
                if delta < 0 or rng.random() < math.exp(-delta / temp):
                    tile_count[p[i]] -= 1
                    if slab_of is not None and tile_count[p[i]] == 0:
                        tile_owner[p[i]] = -1
                    p[i] = t
                    tile_count[t] += 1
                    if slab_of is not None:
                        tile_owner[t] = slab_of[i]
            else:
                j = int(rng.integers(nc))
                if i == j or p[i] == p[j]:
                    continue
                if slab_of is not None and slab_of[i] != slab_of[j]:
                    continue
                delta = _swap_delta(s, h, p, i, j)
                if delta < 0 or rng.random() < math.exp(-delta / temp):
                    p[i], p[j] = p[j], p[i]
        # greedy refinement: all-pairs improving swaps to a local optimum
        improved = True
        sweeps = 0
        while improved and sweeps < 16:
            improved = False
            sweeps += 1
            for i in range(nc):
                for j in range(i + 1, nc):
                    if p[i] == p[j]:
                        continue
                    if slab_of is not None and slab_of[i] != slab_of[j]:
                        continue
                    if _swap_delta(s, h, p, i, j) < -1e-12:
                        p[i], p[j] = p[j], p[i]
                        improved = True

    placement = validate_placement(fabric, nc, p.astype(np.int32))
    cost1 = placement_cost(traffic, h, placement)
    info["cost_final"] = cost1
    info["mean_hops_final"] = cost1 / total if total else 0.0
    return placement, info


def device_slab_placement(
    tables: RoutingTables,
    fabric,
    n_slabs: int,
    *,
    rates: np.ndarray | Sequence[float] | None = None,
    seed: int = 0,
    anneal_steps: int | None = None,
) -> tuple[np.ndarray, dict]:
    """Traffic-aware placement constrained to ``n_slabs`` device slabs.

    The reference's ``EventEngine.make_sharded_step`` (and its
    ``ShardedEventEngine``, not ported yet) maps ``n_slabs`` equal
    contiguous cluster slabs onto devices, which requires
    every tile's clusters to live inside one slab. The hierarchical linear
    default placement packs clusters densely and often violates that (the
    poker CNN's 6 clusters land 4-to-a-tile, straddling a 2-slab split), so
    ``optimize_placement(device_slabs=...)`` cannot seed from it. This
    helper builds a compliant seed — slab ``g`` gets its own contiguous run
    of tiles, clusters packed ``cores_per_tile`` to a tile within it — and
    anneals from there under the slab constraint. Returns ``(placement,
    info)`` like :func:`optimize_placement`.
    """
    if not isinstance(tables, RoutingTables) and hasattr(tables, "tables"):
        tables = tables.tables
    nc = tables.n_clusters
    if n_slabs <= 0 or nc % n_slabs:
        raise ValueError(f"n_slabs={n_slabs} must divide n_clusters={nc}")
    per_slab = nc // n_slabs
    tiles_per_slab = -(-per_slab // fabric.cores_per_tile)
    if tiles_per_slab * n_slabs > fabric.n_tiles:
        raise ValueError(
            f"{n_slabs} slabs x {per_slab} clusters need "
            f"{tiles_per_slab * n_slabs} tiles, fabric has {fabric.n_tiles}"
        )
    init = np.empty(nc, dtype=np.int32)
    for g in range(n_slabs):
        lo = g * per_slab
        local = np.arange(per_slab) // fabric.cores_per_tile
        init[lo : lo + per_slab] = g * tiles_per_slab + local
    return optimize_placement(
        traffic_matrix(tables, rates),
        fabric,
        init=init,
        seed=seed,
        anneal_steps=anneal_steps,
        device_slabs=n_slabs,
    )


def session_rate(tables: RoutingTables) -> float:
    """Predicted fabric event rate of ONE session of this model (events per
    neuron-spike-rate unit): the total expected inter-cluster AER traffic of
    the compiled network under uniform firing — :func:`traffic_matrix`
    summed. The reference's admission controller (serve/sharded.py) scores
    shards by the summed predicted rate of their resident sessions, so a
    model with a
    heavy routing graph counts for proportionally more of a shard's budget
    than a sparse one (DESIGN.md §17).
    """
    if not isinstance(tables, RoutingTables) and hasattr(tables, "tables"):
        tables = tables.tables
    return float(traffic_matrix(tables).sum())


def repair_placement(
    tables: RoutingTables,
    fabric,
    faults,
    *,
    rates: np.ndarray | Sequence[float] | None = None,
    seed: int = 0,
    anneal_steps: int | None = None,
) -> tuple[np.ndarray, dict]:
    """Degraded-mode placement repair around a ``FaultSpec`` (the
    reference's ``repro.core.compiler.repair_placement``): not ported yet."""
    raise NotImplementedError(
        "repair_placement needs fault injection (FaultSpec, tile fault "
        "matrices), which comes with the faults slice of the port (ROADMAP "
        "queue 1, 'Faults and recovery')"
    )


# ---------------------------------------------------------------------------
# compile report
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompileReport:
    """What the compiler actually spent, vs the paper's analytical model.

    ``tags_used[c]`` counts distinct routed tags per cluster (v2 occupancy);
    ``tags_v1[c]`` is the greedy baseline (one per allocation unit) for the
    same spec — the reuse saving is their difference. ``sram_fill[n]`` /
    ``cam_fill[n]`` are per-neuron occupied entries. ``eq2_bits_per_neuron``
    evaluates memory_model eq.(2) at the network's empirical fan-out F and
    broadcast fan-out M (mean CAM audience per SRAM entry);
    ``measured_bits_per_neuron`` is the occupied-bit count of the emitted
    tables. ``mean_hops`` is the traffic-weighted predicted mesh hops per
    delivered event under ``tile_of_cluster`` (None without a fabric).
    """

    k_tags: int
    cluster_size: int
    tags_used: np.ndarray  # [n_clusters] int64
    tags_v1: np.ndarray  # [n_clusters] int64
    sram_fill: np.ndarray  # [N] int64
    cam_fill: np.ndarray  # [N] int64
    sram_bits: int
    cam_bits: int
    eq2_bits_per_neuron: float
    measured_bits_per_neuron: float
    mean_hops: float | None = None
    tile_of_cluster: np.ndarray | None = None

    def summary(self) -> str:
        lines = [
            f"clusters={len(self.tags_used)} K={self.k_tags} "
            f"C={self.cluster_size}",
            f"tags/cluster: v2 max {int(self.tags_used.max(initial=0))} "
            f"(v1 greedy would use {int(self.tags_v1.max(initial=0))}), "
            f"total {int(self.tags_used.sum())} vs {int(self.tags_v1.sum())}",
            f"SRAM fill: mean {self.sram_fill.mean():.2f} max "
            f"{int(self.sram_fill.max(initial=0))} entries/neuron "
            f"({self.sram_bits} bits)",
            f"CAM fill: mean {self.cam_fill.mean():.2f} max "
            f"{int(self.cam_fill.max(initial=0))} words/neuron "
            f"({self.cam_bits} bits)",
            f"bits/neuron: measured {self.measured_bits_per_neuron:.1f} vs "
            f"eq.(2) {self.eq2_bits_per_neuron:.1f}",
        ]
        if self.mean_hops is not None:
            lines.append(f"predicted mean mesh hops/event: {self.mean_hops:.2f}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class CompileResult:
    """Routing tables + the report describing what compiling them cost."""

    tables: RoutingTables
    report: CompileReport


def build_report(
    spec: NetworkSpec,
    tables: RoutingTables,
    fabric=None,
    rates: np.ndarray | None = None,
) -> CompileReport:
    """Measure a compiled network's resource occupancy against the model."""
    src_tag = np.asarray(tables.src_tag)
    src_dest = np.asarray(tables.src_dest)
    cam_tag = np.asarray(tables.cam_tag)
    n, nc = tables.n_neurons, tables.n_clusters

    # encode (cluster, tag) pairs as flat ints for vectorized set/count ops;
    # span covers spliced external tags (cnn.py) that may sit past k_tags-1
    span = int(
        max(tables.k_tags, src_tag.max(initial=0) + 1, cam_tag.max(initial=0) + 1)
    )
    src, ent = np.nonzero(src_tag >= 0)
    entry_codes = src_dest[src, ent].astype(np.int64) * span + src_tag[src, ent]
    # per-cluster distinct routed tags (what the allocator actually spent)
    uniq_entry_codes = np.unique(entry_codes)
    tags_used = np.bincount(
        uniq_entry_codes // span, minlength=nc
    ).astype(np.int64)
    # v1 greedy baseline: one tag per allocation unit
    tags_v1 = np.zeros(nc, dtype=np.int64)
    for u in expand_units(spec):
        tags_v1[u.cluster] += 1

    sram_fill = (src_tag >= 0).sum(1).astype(np.int64)
    cam_fill = (cam_tag >= 0).sum(1).astype(np.int64)

    # empirical eq.(2): audience size per routed (cluster, tag) gives the
    # realized second-stage fan-out M; F is the realized dense fan-out.
    # Vectorized: count CAM words per (cluster, tag), then gather each SRAM
    # entry's audience — per ENTRY, not per distinct tag, since every entry
    # reaches its tag's whole audience (that sum is the dense connection
    # count)
    cam_j, cam_s = np.nonzero(cam_tag >= 0)
    cam_codes = (
        (cam_j // tables.cluster_size).astype(np.int64) * span
        + cam_tag[cam_j, cam_s]
    )
    aud_codes, aud_counts = np.unique(cam_codes, return_counts=True)
    pos = np.searchsorted(aud_codes, entry_codes)
    pos_c = np.clip(pos, 0, max(0, len(aud_codes) - 1))
    hit = (len(aud_codes) > 0) & (aud_codes[pos_c] == entry_codes)
    n_entries = int(sram_fill.sum())
    n_connections = int(np.where(hit, aud_counts[pos_c], 0).sum()) if n_entries else 0
    eq2 = 0.0
    if n_entries and n_connections:
        f_emp = n_connections / n
        m_emp = n_connections / n_entries  # mean audience per SRAM entry
        eq2 = mm.mem_total_bits(
            n=max(2, n), f=f_emp, c=tables.cluster_size, m=m_emp,
            k=max(2, tables.k_tags),
        )
    measured = (tables.sram_bits() + tables.cam_bits()) / n

    mean_hops = None
    if fabric is not None and tables.tile_of_cluster is not None:
        t = traffic_matrix(tables, rates)
        h = tile_hop_matrix(fabric).astype(np.float64)
        total = float(t.sum())
        if total:
            mean_hops = placement_cost(t, h, tables.tile_of_cluster) / total

    return CompileReport(
        k_tags=tables.k_tags,
        cluster_size=tables.cluster_size,
        tags_used=tags_used,
        tags_v1=tags_v1,
        sram_fill=sram_fill,
        cam_fill=cam_fill,
        sram_bits=tables.sram_bits(),
        cam_bits=tables.cam_bits(),
        eq2_bits_per_neuron=float(eq2),
        measured_bits_per_neuron=float(measured),
        mean_hops=mean_hops,
        tile_of_cluster=tables.tile_of_cluster,
    )


# ---------------------------------------------------------------------------
# the v2 front-end
# ---------------------------------------------------------------------------
def compile_network_v2(
    spec: NetworkSpec,
    fabric=None,
    tile_of_cluster: np.ndarray | Sequence[int] | None = None,
    *,
    allocator: str = "reuse",
    optimize: bool = True,
    rates: np.ndarray | None = None,
    seed: int = 0,
    anneal_steps: int | None = None,
    device_slabs: int | None = None,
) -> CompileResult:
    """Routing compiler v2: reuse allocation + traffic-aware placement.

    Compiles ``spec`` with the tag-reuse allocator (bit-exact vs v1, never
    more tags/SRAM/CAM), then — when a ``fabric`` is given and no explicit
    ``tile_of_cluster`` pins the layout — optimizes the cluster->tile
    placement against the network's expected traffic (``rates`` per neuron,
    default uniform) with :func:`optimize_placement`. Returns the stamped
    :class:`RoutingTables` plus a :class:`CompileReport`.
    """
    tables = compile_network(spec, allocator=allocator)
    if tile_of_cluster is not None and fabric is None:
        raise ValueError("tile_of_cluster requires a fabric to validate against")
    if fabric is not None:
        if tile_of_cluster is not None or not optimize:
            placement = validate_placement(fabric, spec.n_clusters, tile_of_cluster)
        else:
            placement, _ = optimize_placement(
                traffic_matrix(tables, rates),
                fabric,
                seed=seed,
                anneal_steps=anneal_steps,
                device_slabs=device_slabs,
            )
        tables = dataclasses.replace(tables, tile_of_cluster=placement)
    report = build_report(spec, tables, fabric=fabric, rates=rates)
    return CompileResult(tables=tables, report=report)


# ---------------------------------------------------------------------------
# compiled-network artifacts + geometry retargeting (DESIGN.md §16)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Geometry:
    """A target hardware geometry: mesh extent, core layout, memory budgets.

    The paper's prototype fixes (3x3 chips, 4 cores/chip, 256 neurons/core,
    K = 1024, 64 CAM words, 16 SRAM entries) — those are the defaults here.
    :func:`retarget` recompiles a :class:`~repro_torch.core.tags.NetworkSpec` to
    any other point of this space and reports which of eq. (2)'s budgets
    binds first.
    """

    grid_x: int = 3
    grid_y: int = 3
    cores_per_tile: int = 4
    neurons_per_core: int = 256  # cluster_size: cluster <-> core is 1:1
    k_tags: int = 1024
    max_cam_words: int = 64
    max_sram_entries: int = 16

    @property
    def n_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def n_cores(self) -> int:
        return self.n_tiles * self.cores_per_tile

    @property
    def capacity(self) -> int:
        """Total neuron slots the geometry can host."""
        return self.n_cores * self.neurons_per_core

    def fabric(self):
        """The equivalent executable :class:`~repro_torch.core.routing.Fabric`."""
        return Fabric(
            grid_x=self.grid_x,
            grid_y=self.grid_y,
            cores_per_tile=self.cores_per_tile,
            neurons_per_core=self.neurons_per_core,
        )

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FeasibilityReport:
    """Which resource budget binds a network on a geometry (per eq. (2)).

    ``utilization`` maps each constraint to its fraction of budget used:
    ``"tags"`` (max per-cluster distinct routed tags / K), ``"cam"`` (max
    CAM words per neuron / budget), ``"sram"`` (max SRAM entries per neuron
    / budget), ``"cores"`` (clusters / cores), and ``"link"`` (peak expected
    per-step directed-link load / link FIFO capacity, under the given
    rates). ``binding`` names the constraint with the highest utilization —
    on an infeasible geometry, the one that overflowed.
    """

    feasible: bool
    binding: str
    utilization: dict
    detail: str = ""

    def asdict(self) -> dict:
        return {
            "feasible": self.feasible,
            "binding": self.binding,
            "utilization": {k: float(v) for k, v in self.utilization.items()},
            "detail": self.detail,
        }


class InfeasibleGeometryError(ValueError):
    """A network does not fit a target geometry; ``.report`` names the
    binding constraint (:class:`FeasibilityReport` with ``feasible=False``)."""

    def __init__(self, message: str, report: FeasibilityReport):
        super().__init__(message)
        self.report = report


def _tags_used_per_cluster(tables: RoutingTables) -> np.ndarray:
    """Distinct routed (cluster, tag) pairs per destination cluster."""
    src_tag = np.asarray(tables.src_tag)
    src_dest = np.asarray(tables.src_dest)
    src, ent = np.nonzero(src_tag >= 0)
    if src.size == 0:
        return np.zeros(tables.n_clusters, dtype=np.int64)
    span = int(max(tables.k_tags, src_tag.max(initial=0) + 1))
    codes = src_dest[src, ent].astype(np.int64) * span + src_tag[src, ent]
    return np.bincount(
        np.unique(codes) // span, minlength=tables.n_clusters
    ).astype(np.int64)


def _link_peak_load(
    tables: RoutingTables,
    geometry: Geometry,
    placement: np.ndarray,
    rates: np.ndarray | None,
) -> float:
    """Peak expected per-step load on any directed inter-tile link."""
    t = traffic_matrix(tables, rates)
    p = np.asarray(placement, dtype=np.int64)
    nt = geometry.n_tiles
    pair = p[:, None] * nt + p[None, :]
    loads = np.bincount(
        pair.ravel(), weights=t.ravel(), minlength=nt * nt
    ).reshape(nt, nt)
    np.fill_diagonal(loads, 0.0)  # intra-tile traffic never touches a link
    return float(loads.max(initial=0.0))


def _feasibility(
    tables: RoutingTables,
    geometry: Geometry,
    placement: np.ndarray | None,
    rates: np.ndarray | None,
    dt: float,
) -> FeasibilityReport:
    """Measure a compiled table against a geometry's budgets."""
    src_tag = np.asarray(tables.src_tag)
    cam_tag = np.asarray(tables.cam_tag)
    # tag *values* must be addressable in the geometry's [0, K) space —
    # spliced external tags (cnn.py input taps) count like any other
    tag_span = int(
        max(src_tag.max(initial=-1), cam_tag.max(initial=-1)) + 1
    )
    util = {
        "tags": max(
            int(_tags_used_per_cluster(tables).max(initial=0)), tag_span
        ) / geometry.k_tags,
        "cam": int((cam_tag >= 0).sum(1).max(initial=0)) / geometry.max_cam_words,
        "sram": int((src_tag >= 0).sum(1).max(initial=0))
        / geometry.max_sram_entries,
        "cores": tables.n_clusters / geometry.n_cores,
    }
    if placement is not None:
        model = build_delivery_model(
            geometry.fabric(), tables.n_clusters, dt, tile_of_cluster=placement
        )
        util["link"] = (
            _link_peak_load(tables, geometry, placement, rates)
            / model.link_capacity
        )
    hard = ("tags", "cam", "sram", "cores")
    feasible = all(util[k] <= 1.0 for k in hard)
    binding = max(util, key=util.get)
    over = [k for k in hard if util[k] > 1.0]
    detail = (
        f"over budget: {', '.join(over)}"
        if over
        else f"tightest budget: {binding} at {util[binding]:.0%}"
    )
    return FeasibilityReport(
        feasible=feasible, binding=binding, utilization=util, detail=detail
    )


@dataclasses.dataclass(frozen=True)
class CompiledArtifact:
    """A self-contained, serializable compiled network (DESIGN.md §16).

    The unit of loading for multi-model serving: routing tables (with the
    physical placement stamped in), the geometry they were compiled for, a
    :class:`FeasibilityReport` naming the binding budget, and optionally the
    :class:`CompileReport`. ``fingerprint()`` identifies the artifact
    content-exactly; the fabric entry table is a pure function of the
    tables + geometry and is reconstructed deterministically by
    :meth:`entry_table` rather than stored.
    """

    tables: RoutingTables
    geometry: Geometry
    feasibility: FeasibilityReport
    report: CompileReport | None = None

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(json.dumps(self.geometry.asdict(), sort_keys=True).encode())
        h.update(self.tables.fingerprint().encode())
        return h.hexdigest()

    def entry_table(self, device="cuda", *, dt: float = 1e-3):
        """Deterministically rebuild the static fabric entry table
        (:class:`~repro_torch.kernels.fabric_deliver.ops.FabricEntries`) on
        ``device`` (CUDA unless the caller asks for the CPU)."""
        from repro_torch.kernels.fabric_deliver.ops import build_fabric_entries

        t = self.tables
        fab = self.geometry.fabric()
        placement = t.tile_of_cluster
        if placement is None:
            placement = default_tile_of_cluster(t.n_clusters, fab)
        model = build_delivery_model(
            fab, t.n_clusters, dt, tile_of_cluster=placement
        )
        return build_fabric_entries(
            t.src_tag, t.src_dest, t.cluster_size, t.k_tags, model, device=device
        )

    # -- serialization ------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the artifact under directory ``path`` (created if needed):
        ``tables.npz`` holds every array, ``artifact.json`` the metadata and
        the content fingerprint (verified on :meth:`load`)."""
        os.makedirs(path, exist_ok=True)
        t = self.tables
        arrays = {
            "src_tag": np.asarray(t.src_tag),
            "src_dest": np.asarray(t.src_dest),
            "cam_tag": np.asarray(t.cam_tag),
            "cam_syn": np.asarray(t.cam_syn),
        }
        if t.tile_of_cluster is not None:
            arrays["tile_of_cluster"] = np.asarray(t.tile_of_cluster)
        rep_meta = None
        if self.report is not None:
            r = self.report
            for k in ("tags_used", "tags_v1", "sram_fill", "cam_fill"):
                arrays[f"report_{k}"] = np.asarray(getattr(r, k))
            if r.tile_of_cluster is not None:
                arrays["report_tile_of_cluster"] = np.asarray(r.tile_of_cluster)
            rep_meta = {
                "k_tags": r.k_tags,
                "cluster_size": r.cluster_size,
                "sram_bits": r.sram_bits,
                "cam_bits": r.cam_bits,
                "eq2_bits_per_neuron": r.eq2_bits_per_neuron,
                "measured_bits_per_neuron": r.measured_bits_per_neuron,
                "mean_hops": r.mean_hops,
            }
        np.savez(os.path.join(path, "tables.npz"), **arrays)
        meta = {
            "format": 1,
            "geometry": self.geometry.asdict(),
            "cluster_size": t.cluster_size,
            "k_tags": t.k_tags,
            "feasibility": self.feasibility.asdict(),
            "report": rep_meta,
            "fingerprint": self.fingerprint(),
        }
        with open(os.path.join(path, "artifact.json"), "w") as f:
            json.dump(meta, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str) -> "CompiledArtifact":
        """Read an artifact saved by :meth:`save`; raises ``ValueError`` when
        the stored fingerprint does not match the loaded content."""
        with open(os.path.join(path, "artifact.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "tables.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        tables = RoutingTables(
            src_tag=arrays["src_tag"],
            src_dest=arrays["src_dest"],
            cam_tag=arrays["cam_tag"],
            cam_syn=arrays["cam_syn"],
            cluster_size=int(meta["cluster_size"]),
            k_tags=int(meta["k_tags"]),
            tile_of_cluster=arrays.get("tile_of_cluster"),
        )
        report = None
        if meta["report"] is not None:
            rm = meta["report"]
            report = CompileReport(
                k_tags=int(rm["k_tags"]),
                cluster_size=int(rm["cluster_size"]),
                tags_used=arrays["report_tags_used"],
                tags_v1=arrays["report_tags_v1"],
                sram_fill=arrays["report_sram_fill"],
                cam_fill=arrays["report_cam_fill"],
                sram_bits=int(rm["sram_bits"]),
                cam_bits=int(rm["cam_bits"]),
                eq2_bits_per_neuron=float(rm["eq2_bits_per_neuron"]),
                measured_bits_per_neuron=float(rm["measured_bits_per_neuron"]),
                mean_hops=None if rm["mean_hops"] is None else float(rm["mean_hops"]),
                tile_of_cluster=arrays.get("report_tile_of_cluster"),
            )
        fz = meta["feasibility"]
        art = cls(
            tables=tables,
            geometry=Geometry(**meta["geometry"]),
            feasibility=FeasibilityReport(
                feasible=bool(fz["feasible"]),
                binding=str(fz["binding"]),
                utilization=dict(fz["utilization"]),
                detail=str(fz.get("detail", "")),
            ),
            report=report,
        )
        if art.fingerprint() != meta["fingerprint"]:
            raise ValueError(
                f"artifact at {path} is corrupt: content fingerprint "
                f"{art.fingerprint()[:12]}... does not match the recorded "
                f"{meta['fingerprint'][:12]}..."
            )
        return art


def artifact_from_tables(
    tables: RoutingTables | CompileResult,
    geometry: Geometry,
    *,
    spec: NetworkSpec | None = None,
    rates: np.ndarray | None = None,
    seed: int = 0,
    anneal_steps: int | None = None,
    optimize: bool = True,
    dt: float = 1e-3,
) -> CompiledArtifact:
    """Bind already-compiled tables to a geometry (placement-only retarget).

    The path for networks whose tables were post-processed after compilation
    (e.g. the poker CNN's spliced input taps, which a recompile would lose):
    budgets are validated against ``geometry``, a placement on its fabric is
    kept if the compiled one fits, else re-derived (traffic-optimized when
    ``optimize``), and the feasibility report is measured from the tables as
    they are. Raises :class:`InfeasibleGeometryError` when a hard budget
    (tags / CAM / SRAM / cores) overflows. ``spec`` additionally attaches a
    fresh :class:`CompileReport`.
    """
    report = None
    if isinstance(tables, CompileResult):
        tables, report = tables.tables, tables.report
    if tables.cluster_size != geometry.neurons_per_core:
        raise InfeasibleGeometryError(
            f"tables were compiled at cluster_size={tables.cluster_size} but "
            f"the geometry hosts {geometry.neurons_per_core} neurons/core — "
            "recompile with retarget() to re-cluster",
            FeasibilityReport(
                feasible=False,
                binding="cores",
                utilization={"cores": float("inf")},
                detail="cluster_size != neurons_per_core",
            ),
        )
    fz = _feasibility(tables, geometry, None, rates, dt)
    if not fz.feasible:
        raise InfeasibleGeometryError(
            f"network does not fit geometry ({fz.detail}); binding "
            f"constraint: {fz.binding}",
            fz,
        )
    fab = geometry.fabric()
    placement = tables.tile_of_cluster
    if placement is not None:
        try:
            placement = validate_placement(fab, tables.n_clusters, placement)
        except ValueError:
            placement = None  # compiled for another fabric: re-place
    if placement is None:
        if optimize:
            placement, _ = optimize_placement(
                traffic_matrix(tables, rates),
                fab,
                seed=seed,
                anneal_steps=anneal_steps,
            )
        else:
            placement = default_tile_of_cluster(tables.n_clusters, fab)
    tables = dataclasses.replace(tables, tile_of_cluster=placement)
    fz = _feasibility(tables, geometry, placement, rates, dt)
    if spec is not None:
        report = build_report(spec, tables, fabric=fab, rates=rates)
    return CompiledArtifact(
        tables=tables, geometry=geometry, feasibility=fz, report=report
    )


def retarget(
    spec: NetworkSpec,
    geometry: Geometry,
    *,
    allocator: str = "reuse",
    rates: np.ndarray | None = None,
    seed: int = 0,
    anneal_steps: int | None = None,
    optimize: bool = True,
    dt: float = 1e-3,
) -> CompiledArtifact:
    """Recompile ``spec`` to an arbitrary geometry (DESIGN.md §16).

    Re-clusters the network at the geometry's ``neurons_per_core`` (padding
    the neuron count up to a whole number of cores — pad neurons are
    unconnected and silent, so the dense-equivalent connectivity is
    preserved bit-exactly), re-allocates tags under the geometry's K /
    CAM / SRAM budgets, places the clusters on the geometry's mesh, and
    returns a :class:`CompiledArtifact` whose feasibility report names the
    binding constraint. An overflowing budget raises
    :class:`InfeasibleGeometryError` with the same report attached.
    """
    cs = geometry.neurons_per_core
    n_padded = -(-spec.n_neurons // cs) * cs
    if n_padded > geometry.capacity:
        raise InfeasibleGeometryError(
            f"{spec.n_neurons} neurons need {n_padded // cs} cores; the "
            f"geometry has {geometry.n_cores} (binding constraint: cores)",
            FeasibilityReport(
                feasible=False,
                binding="cores",
                utilization={"cores": (n_padded // cs) / geometry.n_cores},
                detail=f"{n_padded // cs} clusters > {geometry.n_cores} cores",
            ),
        )
    respec = NetworkSpec(
        n_neurons=n_padded,
        cluster_size=cs,
        k_tags=geometry.k_tags,
        max_cam_words=geometry.max_cam_words,
        max_sram_entries=geometry.max_sram_entries,
    )
    # re-register every group: neuron ids are geometry-invariant, but
    # connect_group buckets targets by DESTINATION CLUSTER at insertion
    # time, so the groups must re-bucket at the new cluster size
    for srcs, by_cluster, shared, copies in spec._groups:
        tgts = [t for cl in sorted(by_cluster) for t in by_cluster[cl]]
        respec.connect_group(srcs, tgts, shared_tag=shared, copies=copies)
    try:
        tables = compile_network(respec, allocator=allocator)
    except ValueError as e:
        msg = str(e)
        binding = "tags"
        if "max_cam_words" in msg:
            binding = "cam"
        elif "max_sram_entries" in msg:
            binding = "sram"
        raise InfeasibleGeometryError(
            f"network does not fit geometry: {msg}",
            FeasibilityReport(
                feasible=False,
                binding=binding,
                utilization={binding: float("inf")},
                detail=msg,
            ),
        ) from e
    return artifact_from_tables(
        tables,
        geometry,
        spec=respec,
        rates=rates,
        seed=seed,
        anneal_steps=anneal_steps,
        optimize=optimize,
        dt=dt,
    )
