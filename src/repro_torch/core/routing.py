"""Analytical model of the hierarchical-mesh routing fabric (paper §III, §V).

Counterpart of ``repro.core.routing`` (numpy only; the port carries its own
copy so it never imports ``repro``). The prototype's QDI circuits are
asynchronous; a tensor program is not. What is reproduced here is the
paper's *quantitative* fabric model — hop counts, latency, energy, and
bandwidth of the R1/R2/R3 hierarchy — as an explicit analytical model
parameterized by the measured chip constants (Tables II/III).

Geometry: a ``grid_x x grid_y`` 2D mesh of tiles (chips); each tile has
``cores_per_tile`` cores behind one R2 tree and one R3 mesh router; each core
has ``neurons_per_core`` neurons behind an R1 router.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ChipConstants",
    "Fabric",
    "FabricDeliveryModel",
    "build_delivery_model",
    "default_tile_of_cluster",
    "tile_hop_matrix",
    "validate_placement",
    "avg_distance_hierarchical",
    "avg_distance_mesh",
]


@dataclasses.dataclass(frozen=True)
class ChipConstants:
    """Measured prototype constants (Tables II and III)."""

    # Table II
    broadcast_time_s: float = 27e-9  # CAM broadcast+search+handshake per core
    latency_across_chip_s: float = 15.4e-9  # includes IO pads (measured)
    r3_latency_s: float = 2.5e-9  # internal R3 hop (0.18um)
    r3_throughput_eps: float = 400e6  # events/s per R3 router
    io_in_eps: float = 30e6
    io_out_eps: float = 21e6
    lut_read_bps: float = 750e6
    # Table III (energy per operation) keyed by core supply voltage
    energy_j: dict = dataclasses.field(
        default_factory=lambda: {
            1.8: {
                "spike": 883e-12,
                "encode": 883e-12,
                "broadcast": 6.84e-9,
                "route_core": 360e-12,
                "pulse_extend": 324e-12,
            },
            1.3: {
                "spike": 260e-12,
                "encode": 507e-12,
                "broadcast": 2.2e-9,
                "route_core": 78e-12,
                "pulse_extend": 26e-12,
            },
        }
    )
    # Table IV
    energy_per_hop_j: float = 17e-12  # @1.3V


@dataclasses.dataclass(frozen=True)
class Fabric:
    grid_x: int = 3
    grid_y: int = 3
    cores_per_tile: int = 4
    neurons_per_core: int = 256
    constants: ChipConstants = dataclasses.field(default_factory=ChipConstants)

    @property
    def n_tiles(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def n_cores(self) -> int:
        return self.n_tiles * self.cores_per_tile

    @property
    def n_neurons(self) -> int:
        return self.n_cores * self.neurons_per_core

    # -- addressing ------------------------------------------------------
    def tile_index(self, core: int) -> int:
        """Linear tile id of a core. Raises on out-of-range ids — wrapping
        silently (core 36 on a 3x3x4 fabric aliasing core 0) hides mis-sized
        placements."""
        if not 0 <= core < self.n_cores:
            raise ValueError(
                f"core {core} out of range for a "
                f"{self.grid_x}x{self.grid_y}x{self.cores_per_tile} fabric "
                f"({self.n_cores} cores)"
            )
        return core // self.cores_per_tile

    def tile_of_core(self, core: int) -> tuple[int, int]:
        t = self.tile_index(core)
        return t % self.grid_x, t // self.grid_x

    def tile_xy(self, tile: int) -> tuple[int, int]:
        """(x, y) mesh coordinates of a linear tile id."""
        if not 0 <= tile < self.n_tiles:
            raise ValueError(f"tile {tile} out of range ({self.n_tiles} tiles)")
        return tile % self.grid_x, tile // self.grid_x

    def hops(self, src_core: int, dst_core: int) -> dict:
        """Router traversals for one event src->dst (XY routing for R3)."""
        sx, sy = self.tile_of_core(src_core)
        dx, dy = self.tile_of_core(dst_core)
        same_tile = (sx, sy) == (dx, dy)
        same_core = same_tile and src_core == dst_core
        mesh_hops = abs(sx - dx) + abs(sy - dy)
        return {
            "r1": 1 if same_core else 2,  # src R1 (+ dst R1 when leaving the core)
            "r2": 0 if same_core else 2,  # up through src R2, down through dst R2
            "r3": mesh_hops,
            "broadcast": 1,  # destination-core CAM broadcast always happens
        }

    def latency_s(self, src_core: int, dst_core: int) -> float:
        """Event latency along the hierarchy (analytical, Table II constants)."""
        c, h = self.constants, self.hops(src_core, dst_core)
        lat = h["broadcast"] * c.broadcast_time_s
        lat += h["r3"] * c.latency_across_chip_s  # chip-to-chip traversal
        # R1/R2 traversals are folded into broadcast + across-chip measurements
        # on the prototype; model them at the internal R3 hop cost.
        lat += (h["r1"] + h["r2"] - 2) * c.r3_latency_s if h["r2"] else 0.0
        return lat

    def energy_j(self, src_core: int, dst_core: int, vdd: float = 1.3) -> float:
        """Energy for one spike delivered src_core -> dst_core (Table III)."""
        e = self.constants.energy_j[vdd]
        h = self.hops(src_core, dst_core)
        total = e["spike"] + e["encode"] + e["broadcast"] + e["pulse_extend"]
        if h["r2"]:
            total += e["route_core"]
        total += h["r3"] * self.constants.energy_per_hop_j
        return total

    # -- aggregate traffic -------------------------------------------------
    def traffic(self, rates_hz: np.ndarray, dst_cores: list[list[int]]) -> dict:
        """Router-level event load for per-core mean spike rates.

        rates_hz[c]: summed neuron spike rate of core c;
        dst_cores[c]: stage-1 destination cores of core c's neurons.
        Returns events/s at each hierarchy level + utilization bounds.
        """
        if len(rates_hz) != self.n_cores:
            raise ValueError(
                f"rates_hz has {len(rates_hz)} entries, fabric has {self.n_cores} cores"
            )
        if len(dst_cores) != self.n_cores:
            raise ValueError(
                f"dst_cores has {len(dst_cores)} entries, fabric has {self.n_cores} cores"
            )
        c = self.constants
        r1 = np.zeros(self.n_cores)
        r3_total = 0.0
        broadcasts = np.zeros(self.n_cores)
        for src, dsts in enumerate(dst_cores):
            for d in dsts:
                h = self.hops(src, d)
                r1[src] += rates_hz[src]
                broadcasts[d] += rates_hz[src]
                r3_total += rates_hz[src] * h["r3"]
        bcast_limit = 1.0 / c.broadcast_time_s
        return {
            "r1_events_per_s": r1,
            "broadcast_events_per_s": broadcasts,
            "r3_events_per_s": r3_total,
            "broadcast_utilization": broadcasts.max() / bcast_limit if len(broadcasts) else 0.0,
            "r3_utilization": r3_total / (c.r3_throughput_eps * self.n_tiles),
        }

    def max_fan_in(self, rate_hz: float) -> float:
        """Paper §V: fan-in supportable at a given mean rate.

        Worst case (no source sharing): a core receives neurons_per_core * F
        events/s; bounding by the 1/27ns ~ 37 Mevents/s broadcast bandwidth
        gives F = bw / (256 * rate) — reproduces the paper's 7200 @ 20 Hz and
        1400 @ 100 Hz (the paper rounds).
        """
        bandwidth = 1.0 / self.constants.broadcast_time_s
        return bandwidth / (self.neurons_per_core * rate_hz)


# ---------------------------------------------------------------------------
# Executable delivery model: per-cluster-pair constants for the event engine
# ---------------------------------------------------------------------------
def default_tile_of_cluster(n_clusters: int, fabric: Fabric) -> np.ndarray:
    """Hierarchical (linear) placement: cluster c -> tile c // cores_per_tile.

    Consecutive clusters fill each tile's cores before moving to the next
    tile — the paper's hierarchy assumption (local traffic resolves below
    the R3 mesh).
    """
    if n_clusters > fabric.n_cores:
        raise ValueError(
            f"{n_clusters} clusters do not fit on a fabric with {fabric.n_cores} cores"
        )
    return (np.arange(n_clusters, dtype=np.int32) // fabric.cores_per_tile).astype(
        np.int32
    )


def tile_hop_matrix(fabric: Fabric) -> np.ndarray:
    """[n_tiles, n_tiles] int32 XY-Manhattan R3 hops between linear tile ids.

    The single definition of mesh distance shared by
    :func:`build_delivery_model` (per-cluster-pair delay/latency tables) and
    the traffic-aware placement optimizer of compiler v2, so the optimizer's
    objective and the executable fabric can never disagree on what a hop
    is.
    """
    t = np.arange(fabric.n_tiles, dtype=np.int32)
    tx, ty = t % fabric.grid_x, t // fabric.grid_x
    return (
        np.abs(tx[:, None] - tx[None, :]) + np.abs(ty[:, None] - ty[None, :])
    ).astype(np.int32)


def validate_placement(
    fabric: Fabric, n_clusters: int, tile_of_cluster: np.ndarray | None
) -> np.ndarray:
    """Normalize + validate a cluster->tile placement; O(n_clusters).

    ``None`` yields the hierarchical linear default. Checks shape, tile-id
    range, and per-tile core capacity. Shared by :func:`build_delivery_model`
    and ``tags.compile_network`` (which must not pay the model's O(nc^2)
    matrix build just to validate).
    """
    if tile_of_cluster is None:
        return default_tile_of_cluster(n_clusters, fabric)
    tiles = np.asarray(tile_of_cluster, dtype=np.int32)
    if tiles.shape != (n_clusters,):
        raise ValueError(
            f"tile_of_cluster has shape {tiles.shape}, expected ({n_clusters},)"
        )
    if tiles.size and (tiles.min() < 0 or tiles.max() >= fabric.n_tiles):
        raise ValueError(
            f"tile ids must lie in [0, {fabric.n_tiles}); got "
            f"[{tiles.min()}, {tiles.max()}]"
        )
    counts = np.bincount(tiles, minlength=fabric.n_tiles)
    if counts.max(initial=0) > fabric.cores_per_tile:
        raise ValueError(
            f"placement puts {counts.max()} clusters on one tile; the fabric "
            f"has {fabric.cores_per_tile} cores per tile"
        )
    return tiles


@dataclasses.dataclass(frozen=True)
class FabricDeliveryModel:
    """Per-cluster-pair constants driving executable fabric delivery.

    The event engine's fabric mode (core/dispatch.py ``FabricBackend``,
    DESIGN.md §11) gathers these [n_clusters, n_clusters] tables per routed
    event instead of calling the scalar :class:`Fabric` methods: mesh hop
    counts, arrival delays in integer timesteps, and the Table II/III
    latency/energy figures for the per-step accumulators (link-FIFO bins are
    derived from ``tile_of_cluster`` at routing time). Host-side numpy; the
    dispatch backend uploads them once as tensors on its device.
    """

    tile_of_cluster: np.ndarray  # [nc] int32 linear tile id per cluster
    n_tiles: int
    mesh_hops: np.ndarray  # [nc, nc] int32 R3 (XY Manhattan) hops
    delay_steps: np.ndarray  # [nc, nc] int32 arrival delay, 0 = same step
    latency_s: np.ndarray  # [nc, nc] float32 per-event latency (Table II)
    energy_j: np.ndarray  # [nc, nc] float32 per-event energy (Table III/IV)
    link_capacity: int  # events per directed inter-tile link per step
    max_delay: int  # delay_steps.max()
    # fault injection (core/faults.py, DESIGN.md §15): None = healthy fabric.
    # pair_alive[a, b] False = cluster pair unreachable (dead tile/link on the
    # XY route — a dead link is a zero-capacity link); pair_drop_rate[a, b] is
    # the compound stochastic loss along the route.
    pair_alive: np.ndarray | None = None  # [nc, nc] bool
    pair_drop_rate: np.ndarray | None = None  # [nc, nc] float32
    faults: object | None = None  # the FaultSpec these matrices came from


def build_delivery_model(
    fabric: Fabric,
    n_clusters: int,
    dt: float,
    tile_of_cluster: np.ndarray | None = None,
    vdd: float = 1.3,
    link_capacity: int | None = None,
    faults=None,  # faults.FaultSpec | None
) -> FabricDeliveryModel:
    """Precompute the per-cluster-pair fabric constants for a placement.

    ``tile_of_cluster[c]`` is the linear tile id hosting engine cluster
    (core) ``c`` — default is the hierarchical linear placement. Distinct
    clusters on one tile are distinct cores (R2 hop, no mesh hops); only the
    diagonal is the same-core case. Cross-tile events arrive
    ``ceil(mesh_hops * latency_across_chip_s / dt)`` steps later — the
    broadcast/R1/R2 portion of the latency is far below any usable ``dt``
    and is folded into the engine's intrinsic one-step spike->drive delay.
    ``link_capacity`` defaults to ``r3_throughput_eps * dt`` events per
    directed tile pair per step (each pair modeled as a virtual channel;
    physical XY link sharing is not modeled).

    ``faults`` (a :class:`~repro_torch.core.faults.FaultSpec`) injects
    topology faults: cluster pairs whose XY route crosses a dead tile/link
    become unreachable (``pair_alive`` False — zero effective capacity),
    lossy links compound into ``pair_drop_rate``. The fault matrices ride on
    the returned model so every delivery path derives its liveness masks
    from one place.
    """
    if dt <= 0:
        raise ValueError(f"dt must be positive, got {dt}")
    tiles = validate_placement(fabric, n_clusters, tile_of_cluster)
    c = fabric.constants
    hops = tile_hop_matrix(fabric)[tiles[:, None], tiles[None, :]]
    same_core = np.eye(n_clusters, dtype=bool)
    # vectorized Fabric.latency_s / Fabric.energy_j (r1/r2 follow same_core)
    r1 = np.where(same_core, 1, 2)
    r2 = np.where(same_core, 0, 2)
    latency = c.broadcast_time_s + hops * c.latency_across_chip_s
    latency = latency + np.where(r2 > 0, (r1 + r2 - 2) * c.r3_latency_s, 0.0)
    e = c.energy_j[vdd]
    energy = e["spike"] + e["encode"] + e["broadcast"] + e["pulse_extend"]
    energy = energy + np.where(r2 > 0, e["route_core"], 0.0)
    energy = energy + hops * c.energy_per_hop_j
    # arrival delay in steps; the 1e-9 guards float-ceil off-by-one on exact
    # multiples of dt
    delay = np.ceil(hops * c.latency_across_chip_s / dt - 1e-9).astype(np.int32)
    delay = np.maximum(delay, 0)
    if link_capacity is None:
        link_capacity = max(1, int(c.r3_throughput_eps * dt))
    elif link_capacity <= 0:
        raise ValueError(f"link_capacity must be positive, got {link_capacity}")
    pair_alive = pair_drop_rate = None
    if faults is not None and faults.routes_faulted:
        from .faults import pair_fault_matrices

        pair_alive, pair_drop_rate = pair_fault_matrices(fabric, tiles, faults)
    return FabricDeliveryModel(
        tile_of_cluster=tiles,
        n_tiles=fabric.n_tiles,
        mesh_hops=hops,
        delay_steps=delay,
        latency_s=latency.astype(np.float32),
        energy_j=energy.astype(np.float32),
        link_capacity=int(link_capacity),
        max_delay=int(delay.max(initial=0)),
        pair_alive=pair_alive,
        pair_drop_rate=pair_drop_rate,
        faults=faults if pair_alive is not None else None,
    )


# ---------------------------------------------------------------------------
# Average-distance scaling (Table IV)
# ---------------------------------------------------------------------------
def avg_distance_mesh(n_nodes: int) -> float:
    """Flat 2D mesh: mean Manhattan distance ~ 2*sqrt(N)/3."""
    side = int(np.ceil(np.sqrt(n_nodes)))
    xs = np.arange(side)
    d1 = np.abs(xs[:, None] - xs[None, :]).mean()  # mean |x1-x2| over a side
    return 2.0 * d1


def avg_distance_hierarchical(n_nodes: int, cluster: int = 4) -> float:
    """Hierarchy concentrates local traffic: distance ~ sqrt(N)/3.

    Model: fraction of traffic resolved below the mesh (R1/R2) contributes ~0
    mesh hops; the rest traverses the (sqrt(N)/cluster-side) reduced mesh.
    With 4 cores/tile the reduced mesh has N/4 nodes -> mean distance
    2*sqrt(N/4)/3 = sqrt(N)/3, matching the paper's Table IV entry.
    """
    return avg_distance_mesh(max(1, n_nodes // cluster))
