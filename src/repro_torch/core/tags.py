"""Network compiler: connectivity -> two-stage routing tables (paper §II/§III).

Counterpart of ``repro.core.tags`` (the v1 "greedy" allocator, and the v2
"reuse" allocator through core/compiler.py). The compiler
emits the paper's distributed routing state as numpy int32 arrays:

  source (SRAM) table, one row per neuron  — stage-1 point-to-point entries
      src_tag[i, e]  : tag id broadcast into the destination cluster
      src_dest[i, e] : destination cluster id
  target (CAM) table, one row per neuron   — stage-2 subscriptions
      cam_tag[j, s]  : tag this neuron's synapse s is subscribed to
      cam_syn[j, s]  : synapse type in {0: fast-exc, 1: slow-exc,
                                        2: subtractive-inh, 3: shunting-inh}

An event (tag t -> cluster c) is broadcast to ALL neurons of cluster c and
accepted by every CAM word matching t. Under the v1 ("greedy") allocator
sources share a tag only where the caller asks for it (``shared_tag=True``);
otherwise every (source, cluster) pair gets a fresh tag, and exceeding K
tags in any cluster is a compile error. The v2 ("reuse") allocator of
core/compiler.py also merges units whose source sets are identical.

Tag numbers follow from group order, ``sorted`` cluster order and
``itertools.groupby`` runs exactly as in the reference, so the tables are
byte-equal to ``repro``'s for the same spec.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from itertools import groupby
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.routing import Fabric, validate_placement

__all__ = [
    "SynapseType",
    "NetworkSpec",
    "RoutingTables",
    "AllocUnit",
    "expand_units",
    "compile_network",
]


class SynapseType:
    FAST_EXC = 0
    SLOW_EXC = 1
    SUB_INH = 2
    SHUNT_INH = 3


@dataclasses.dataclass
class NetworkSpec:
    """Mutable description of an event-routed network, filled connection by connection.

    Neurons are integers 0..n-1, statically grouped into clusters of size
    ``cluster_size`` (cluster id = neuron // cluster_size, the "core").
    """

    n_neurons: int
    cluster_size: int
    k_tags: int  # K: tags per cluster (address space within a core)
    max_cam_words: int = 64  # CAM words per neuron (paper prototype: 64)
    max_sram_entries: int = 16  # stage-1 fan-out F/M per neuron

    def __post_init__(self) -> None:
        if self.n_neurons % self.cluster_size != 0:
            raise ValueError("n_neurons must be a multiple of cluster_size")
        # groups: (sources, {cluster: [(target, syn_type)]}, shared, copies)
        self._groups: list = []

    @property
    def n_clusters(self) -> int:
        return self.n_neurons // self.cluster_size

    def cluster_of(self, neuron: int) -> int:
        return neuron // self.cluster_size

    def connect(self, src: int, dst: int, syn_type: int = SynapseType.FAST_EXC,
                copies: int = 1) -> None:
        """Point connection: one source, one destination synapse."""
        self.connect_group([src], [(dst, syn_type)], shared_tag=False, copies=copies)

    def connect_one_to_many(
        self, src: int, dsts: Sequence[int], syn_type: int = SynapseType.FAST_EXC
    ) -> None:
        self.connect_group([src], [(d, syn_type) for d in dsts], shared_tag=False)

    def connect_group(
        self,
        sources: Iterable[int],
        targets: Iterable[tuple[int, int]],
        shared_tag: bool = True,
        copies: int = 1,
    ) -> None:
        """Connect every source to every (target, syn_type).

        ``shared_tag=True`` makes all sources of the group share one tag per
        destination cluster; with ``shared_tag=False`` each source gets its
        own tag per cluster. ``copies`` programs the same tag into several
        CAM words of each target (integer synaptic weights).
        """
        by_cluster: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for dst, syn in targets:
            if not (0 <= dst < self.n_neurons):
                raise ValueError(f"target {dst} out of range")
            by_cluster[self.cluster_of(dst)].append((dst, int(syn)))
        srcs = tuple(sorted(set(int(s) for s in sources)))
        for s in srcs:
            if not (0 <= s < self.n_neurons):
                raise ValueError(f"source {s} out of range")
        self._groups.append((srcs, dict(by_cluster), bool(shared_tag), int(copies)))


@dataclasses.dataclass(frozen=True)
class RoutingTables:
    """Compiled two-stage routing state (numpy int32; -1 = empty slot)."""

    src_tag: np.ndarray  # [N, E]
    src_dest: np.ndarray  # [N, E]
    cam_tag: np.ndarray  # [N, S]
    cam_syn: np.ndarray  # [N, S]  (valid only where cam_tag >= 0)
    cluster_size: int
    k_tags: int
    # linear tile id hosting each cluster on a fabric; None = no placement
    tile_of_cluster: np.ndarray | None = None

    @property
    def n_neurons(self) -> int:
        return self.src_tag.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.n_neurons // self.cluster_size

    # -- paper bookkeeping -------------------------------------------------
    def sram_bits(self) -> int:
        """Occupied source-memory bits: entries * (log2 K + log2 n_clusters)."""
        ent = int((self.src_tag >= 0).sum())
        word = int(np.ceil(np.log2(max(2, self.k_tags)))) + int(
            np.ceil(np.log2(max(2, self.n_clusters)))
        )
        return ent * word

    def cam_bits(self) -> int:
        """Occupied target-memory bits: CAM words * (log2 K + 2 syn-type bits)."""
        ent = int((self.cam_tag >= 0).sum())
        return ent * (int(np.ceil(np.log2(max(2, self.k_tags)))) + 2)

    def fingerprint(self) -> str:
        """Content hash of the compiled routing state.

        Covers the four tables (values and shapes), the cluster/tag geometry
        and the placement, hashed as ``repro``'s ``RoutingTables.fingerprint``
        does, so equal tables give equal fingerprints in both packages.
        """
        h = hashlib.sha256()
        h.update(f"C{self.cluster_size}K{self.k_tags}".encode())
        for a in (self.src_tag, self.src_dest, self.cam_tag, self.cam_syn):
            a = np.ascontiguousarray(np.asarray(a, dtype=np.int64))
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        if self.tile_of_cluster is not None:
            p = np.ascontiguousarray(np.asarray(self.tile_of_cluster, dtype=np.int64))
            h.update(b"P" + p.tobytes())
        return h.hexdigest()

    def dense_equivalent(self) -> np.ndarray:
        """Reference fan-out expansion: [n_connections, 3] rows (src, dst, syn).

        A (src -> tag@cluster) entry reaches EVERY neuron of that cluster
        whose CAM holds the tag. Used as the oracle in tests.
        """
        n, e = self.src_tag.shape
        rows: list[tuple[int, int, int]] = []
        subs: dict[tuple[int, int], list[tuple[int, int]]] = defaultdict(list)
        for j in range(n):
            cl = j // self.cluster_size
            for s in range(self.cam_tag.shape[1]):
                t = int(self.cam_tag[j, s])
                if t >= 0:
                    subs[(cl, t)].append((j, int(self.cam_syn[j, s])))
        for i in range(n):
            for k in range(e):
                t = int(self.src_tag[i, k])
                if t < 0:
                    continue
                cl = int(self.src_dest[i, k])
                for j, syn in subs[(cl, t)]:
                    rows.append((i, j, syn))
        return np.asarray(sorted(rows), dtype=np.int32).reshape(-1, 3)


@dataclasses.dataclass(frozen=True)
class AllocUnit:
    """One tag-allocation unit: a (connect-group, destination-cluster) pair.

    ``shared_tag=False`` groups expand into one unit per source,
    ``shared_tag=True`` groups into one unit per destination cluster. The
    greedy allocator spends one fresh tag per unit.
    """

    cluster: int  # destination cluster the tag lives in
    sources: tuple[int, ...]  # sorted, non-empty source neuron ids
    targets: tuple[tuple[int, int], ...]  # (dst neuron, syn type)
    copies: int  # CAM words per (target, tag) — integer weight
    group: int = 0  # originating connect-group index


def expand_units(spec: NetworkSpec) -> list[AllocUnit]:
    """Expand the spec's connect-groups into allocation units in tag order
    (group order, then cluster id, then source id). Units of one (group,
    cluster) are emitted consecutively; empty source sets allocate nothing."""
    units: list[AllocUnit] = []
    for g, (srcs, by_cluster, shared, copies) in enumerate(spec._groups):
        if not srcs:
            continue
        for cluster, tgts in sorted(by_cluster.items()):
            tgts_t = tuple((int(d), int(sy)) for d, sy in tgts)
            if shared:
                units.append(AllocUnit(cluster, srcs, tgts_t, copies, g))
            else:
                units.extend(AllocUnit(cluster, (s,), tgts_t, copies, g) for s in srcs)
    return units


def _allocate_unit_tags(spec: NetworkSpec, units: list[AllocUnit], allocator: str) -> list[int]:
    """Assign a tag to every unit, in unit order.

    ``"greedy"`` (v1) burns one fresh tag per unit. ``"reuse"`` (v2) colors
    the per-cluster conflict graph so same-source-set units share a tag
    (core/compiler.py).
    """
    if allocator == "reuse":
        from repro_torch.core.compiler import allocate_tags_reuse  # compiler imports tags

        return allocate_tags_reuse(spec, units)[0]
    if allocator != "greedy":
        raise ValueError(
            f"unknown allocator {allocator!r}; available: 'greedy' (v1, one "
            "tag per unit), 'reuse' (v2 conflict-graph tag sharing)"
        )
    next_tag = np.zeros(spec.n_clusters, dtype=np.int64)
    tags = []
    for u in units:
        t = int(next_tag[u.cluster])
        if t >= spec.k_tags:
            raise ValueError(
                f"tag overflow in cluster {u.cluster}: K={spec.k_tags} "
                f"exhausted (binding constraint: tags per cluster); "
                "increase alpha (more tags), re-cluster the network "
                "(Appendix A), or compile with allocator='reuse' to share "
                "tags between same-source connect-groups"
            )
        next_tag[u.cluster] += 1
        tags.append(t)
    return tags


def compile_network(
    spec: NetworkSpec,
    fabric: Fabric | None = None,
    tile_of_cluster: np.ndarray | Sequence[int] | None = None,
    allocator: str = "greedy",
) -> RoutingTables:
    """Tag allocation + table materialization (paper Appendix A).

    ``allocator`` selects the tag assignment: ``"greedy"`` (v1, a fresh tag
    per allocation unit) or ``"reuse"`` (v2, conflict-graph coloring that
    lets units with identical source sets share one tag; see
    core/compiler.py, whose ``compile_network_v2`` adds traffic-aware
    placement and a ``CompileReport`` on top of this function).

    With ``fabric`` (a :class:`~repro_torch.core.routing.Fabric`) set the
    tables additionally carry a cluster->tile placement
    (``tile_of_cluster``, validated against the fabric geometry; default:
    hierarchical linear placement) so the fabric-mode event engine can
    derive per-event mesh hops, delays, and link assignments.
    """
    placement = None
    if tile_of_cluster is not None and fabric is None:
        raise ValueError("tile_of_cluster requires a fabric to validate against")
    if fabric is not None:
        placement = validate_placement(fabric, spec.n_clusters, tile_of_cluster)
    n = spec.n_neurons
    units = expand_units(spec)
    unit_tags = _allocate_unit_tags(spec, units, allocator)

    src_entries: list[list[tuple[int, int]]] = [[] for _ in range(n)]  # (tag, cluster)
    cam_entries: list[list[tuple[int, int]]] = [[] for _ in range(n)]  # (tag, syn)
    # materialize per (group, cluster) run so CAM word order stays
    # target-outer / tag-inner
    for _, run_iter in groupby(
        zip(units, unit_tags), key=lambda ut: (ut[0].group, ut[0].cluster)
    ):
        run = list(run_iter)
        # stage-1 entries, deduplicated per (src, cluster, tag)
        for u, tag in run:
            for s in u.sources:
                entry = (tag, u.cluster)
                if entry not in src_entries[s]:
                    src_entries[s].append(entry)
                    if len(src_entries[s]) > spec.max_sram_entries:
                        raise ValueError(
                            f"source {s} (cluster {spec.cluster_of(s)}): "
                            f"stage-1 fan-out exceeds F/M="
                            f"{spec.max_sram_entries} SRAM entries while "
                            f"adding its entry for cluster {u.cluster} "
                            f"(binding constraint: max_sram_entries)"
                        )
        # stage-2 subscriptions: each target subscribes to every unit tag, sorted
        u0 = run[0][0]
        run_tags = sorted(tag for _, tag in run)
        for dst, syn in u0.targets:
            for tag in run_tags:
                for _ in range(u0.copies):
                    cam_entries[dst].append((tag, syn))
                if len(cam_entries[dst]) > spec.max_cam_words:
                    raise ValueError(
                        f"neuron {dst} (cluster {spec.cluster_of(dst)}): CAM "
                        f"capacity {spec.max_cam_words} exceeded while "
                        f"subscribing to tag {tag} (binding constraint: "
                        f"max_cam_words)"
                    )

    e, s_ = spec.max_sram_entries, spec.max_cam_words
    src_tag = np.full((n, e), -1, dtype=np.int32)
    src_dest = np.full((n, e), -1, dtype=np.int32)
    cam_tag = np.full((n, s_), -1, dtype=np.int32)
    cam_syn = np.zeros((n, s_), dtype=np.int32)
    for i, entries in enumerate(src_entries):
        for k, (t, c) in enumerate(entries):
            src_tag[i, k] = t
            src_dest[i, k] = c
    for j, entries in enumerate(cam_entries):
        for k, (t, syn) in enumerate(entries):
            cam_tag[j, k] = t
            cam_syn[j, k] = syn
    return RoutingTables(
        src_tag=src_tag,
        src_dest=src_dest,
        cam_tag=cam_tag,
        cam_syn=cam_syn,
        cluster_size=spec.cluster_size,
        k_tags=spec.k_tags,
        tile_of_cluster=placement,
    )
