"""Spiking-CNN compiler for the poker-DVS experiment (paper §V, Table V).

Counterpart of ``repro.core.cnn``. Maps the paper's three-layer
event-driven CNN onto the two-stage routed fabric:

  input 32x32 DVS events
   -> conv: 4 kernels 8x8, stride 2      -> 4 x 16 x 16 feature maps
   -> subsample 2x2 (pooling)            -> 4 x 8 x 8
   -> fully connected (64 strongest)     -> 4 populations x 64 output neurons

One cluster = one core of 256 neurons: clusters 0-3 hold the feature maps,
cluster 4 the pooling layer, cluster 5 the output populations. K = 1024
tags per core; input pixels are external sources whose pixel-id tags
``y*32 + x`` are spliced into the conv neurons' CAMs. Host-side numpy,
byte-equal to ``repro``'s tables for the same selection.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.compiler import CompileReport, build_report
from repro_torch.core.neuron import NeuronParams
from repro_torch.core.tags import NetworkSpec, RoutingTables, SynapseType, compile_network

__all__ = [
    "CnnConfig",
    "CompiledCnn",
    "compile_poker_cnn",
    "edge_kernels",
    "hebbian_readout_select",
    "poker_neuron_params",
]


def poker_neuron_params() -> NeuronParams:
    """The §V operating point: neuron/synapse biases tuned so the Table-V
    network classifies within the paper's <30 ms decision window."""
    return NeuronParams(
        refrac=1e-3, b_adapt=1e-3, input_gain=0.3, w_syn=(1.0, 3.0, 1.0, 1.0)
    )


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    input_hw: int = 32
    n_kernels: int = 4
    kernel: int = 8
    stride: int = 2
    conv_hw: int = 16  # stride-2 with padding 5 -> 16x16 output (paper Table V)
    pool: int = 2
    n_classes: int = 4
    pop_per_class: int = 64
    cluster_size: int = 256  # one DYNAPs core
    k_tags: int = 1024  # 10-bit CAM tag field
    max_cam_words: int = 64
    max_sram_entries: int = 16


@dataclasses.dataclass
class CompiledCnn:
    tables: RoutingTables
    cfg: CnnConfig
    # neuron index ranges [start, stop)
    conv: tuple[int, int]
    pool: tuple[int, int]
    out: tuple[int, int]
    conv_clusters: tuple[int, ...]
    # compiler-v2 occupancy report (compile_poker_cnn(with_report=True))
    report: CompileReport | None = None

    def input_activity(self, events_yx, on_invalid: str = "raise") -> np.ndarray:
        """DVS events -> external tag activity (numpy float32).

        ``events_yx`` is one stream ``[n_ev, 2]`` of (y, x) rows, giving
        ``[n_clusters, K]``, or a sequence of B streams, giving
        ``[B, n_clusters, K]``. ``on_invalid`` sets the policy for
        coordinates outside the sensor: ``"raise"`` (``ValueError``),
        ``"clip"`` (clamp into range) or ``"drop"`` (discard the event).
        """
        if on_invalid not in ("raise", "clip", "drop"):
            raise ValueError(
                f"on_invalid must be 'raise', 'clip' or 'drop', got {on_invalid!r}"
            )
        if isinstance(events_yx, (list, tuple)):
            return self.input_activity_batch(events_yx, on_invalid)
        c = self.cfg
        a = np.zeros((self.tables.n_clusters, c.k_tags), dtype=np.float32)
        events_yx = np.asarray(events_yx)
        if events_yx.size == 0:
            return a
        if events_yx.ndim != 2 or events_yx.shape[1] != 2:
            raise ValueError(
                f"events must be [n_ev, 2] (y, x) rows, got shape {events_yx.shape}"
            )
        ev = events_yx.astype(np.int64)
        ok = ((ev >= 0) & (ev < c.input_hw)).all(axis=1)
        if not ok.all():
            if on_invalid == "raise":
                bad = ev[~ok][0]
                raise ValueError(
                    f"DVS event (y={bad[0]}, x={bad[1]}) outside the "
                    f"{c.input_hw}x{c.input_hw} sensor; pass on_invalid='clip' "
                    "or 'drop' to accept malformed packets"
                )
            if on_invalid == "clip":
                ev = np.clip(ev, 0, c.input_hw - 1)
            else:  # drop
                ev = ev[ok]
                if len(ev) == 0:
                    return a
        tags = ev[:, 0] * c.input_hw + ev[:, 1]
        counts = np.bincount(tags, minlength=c.input_hw * c.input_hw).astype(np.float32)
        for cl in self.conv_clusters:
            a[cl, : c.input_hw * c.input_hw] += counts
        return a

    def input_activity_batch(self, event_streams, on_invalid: str = "raise") -> np.ndarray:
        """B DVS streams (each [n_ev_i, 2]) -> batched activity [B, n_clusters, K]."""
        return np.stack(
            [self.input_activity(np.asarray(ev), on_invalid) for ev in event_streams]
        )


def edge_kernels(k: int = 8) -> np.ndarray:
    """4 ternary oriented detectors [4,k,k] in {-1,0,+1} (§V: vertical,
    horizontal edges; upward, downward vertices)."""
    ks = np.zeros((4, k, k), dtype=np.float32)
    half = k // 2
    ks[0, :, half - 1 : half + 1] = 1.0  # vertical edge: center band +
    ks[0, :, : half - 2], ks[0, :, half + 2 :] = -1.0, -1.0
    ks[1] = ks[0].T  # horizontal edge
    for y in range(k):
        for x in range(k):
            d = y - abs(x - half)
            ks[2, y, x] = 1.0 if 0 <= d <= 1 else (-1.0 if d > 2 else 0.0)
    ks[3] = ks[2, ::-1, :]  # downward vertex
    return ks


def hebbian_readout_select(
    class_pool_rates: np.ndarray, pop_per_class: int = 64
) -> np.ndarray:
    """Offline-Hebbian readout selection (paper §V): per class, the
    ``pop_per_class`` pooling neurons most selective for that class.

    Stays numpy: ``np.argsort`` breaks ties as the reference does, and
    ``torch.argsort`` would not.
    """
    rates = np.asarray(class_pool_rates, dtype=np.float64)
    selectivity = rates - rates.mean(0, keepdims=True)
    return np.stack(
        [np.argsort(-selectivity[c])[:pop_per_class] for c in range(len(rates))]
    )


def compile_poker_cnn(
    cfg: CnnConfig = CnnConfig(),
    fc_select: np.ndarray | None = None,
    allocator: str = "greedy",
    with_report: bool = False,
) -> CompiledCnn:
    """Build + compile the Table-V network.

    ``fc_select``: [n_classes, <=64] pool-neuron indices feeding each class
    population (the offline-Hebbian selection). Default: class c reads its
    own feature map's 64 pool neurons. ``allocator`` is ``"greedy"`` (v1)
    or ``"reuse"`` (v2; byte-equal tables here, since no two allocation
    units share a source set). ``with_report=True`` attaches the compiler-v2
    :class:`~repro_torch.core.compiler.CompileReport` of the spliced tables.
    """
    c = cfg
    n_conv = c.n_kernels * c.conv_hw * c.conv_hw  # 1024
    pool_hw = c.conv_hw // c.pool
    n_pool = c.n_kernels * pool_hw * pool_hw  # 256
    n_out = c.n_classes * c.pop_per_class  # 256
    n_neurons = n_conv + n_pool + n_out  # 1536 = 6 cores

    spec = NetworkSpec(
        n_neurons=n_neurons,
        cluster_size=c.cluster_size,
        k_tags=c.k_tags,
        max_cam_words=c.max_cam_words,
        max_sram_entries=c.max_sram_entries,
    )

    conv0, pool0, out0 = 0, n_conv, n_conv + n_pool
    map_size = c.conv_hw * c.conv_hw  # 256 = one cluster per feature map
    conv_clusters = tuple((conv0 + f * map_size) // c.cluster_size for f in range(c.n_kernels))

    def conv_idx(f: int, y: int, x: int) -> int:
        return conv0 + (f * c.conv_hw + y) * c.conv_hw + x

    def pool_idx(f: int, y: int, x: int) -> int:
        return pool0 + (f * pool_hw + y) * pool_hw + x

    def out_idx(cls: int, i: int) -> int:
        return out0 + cls * c.pop_per_class + i

    # ---- conv -> pool (shared tag per 2x2 field) ---------------------------
    for f in range(c.n_kernels):
        for py in range(pool_hw):
            for px in range(pool_hw):
                srcs = [
                    conv_idx(f, py * c.pool + dy, px * c.pool + dx)
                    for dy in range(c.pool)
                    for dx in range(c.pool)
                ]
                spec.connect_group(
                    srcs, [(pool_idx(f, py, px), SynapseType.FAST_EXC)],
                    shared_tag=True, copies=8,  # integer weight via repeated CAM words
                )

    # ---- pool -> output (64 selected sources per class) --------------------
    if fc_select is None:
        fc_select = np.arange(n_pool, dtype=np.int64).reshape(c.n_kernels, -1)[
            : c.n_classes
        ]  # class c <- feature map c's pool units
    for cls in range(c.n_classes):
        tgts = [(out_idx(cls, i), SynapseType.SLOW_EXC) for i in range(c.pop_per_class)]
        for p in np.asarray(fc_select[cls]).ravel():
            spec.connect_group([pool0 + int(p)], tgts, shared_tag=True)

    tables = compile_network(spec, allocator=allocator)

    # ---- input -> conv: splice pixel-id tags into conv CAMs ---------------
    kernels = edge_kernels(c.kernel)
    pad = (c.conv_hw * c.stride + c.kernel - c.stride - c.input_hw) // 2  # = 5
    cam_tag = tables.cam_tag.copy()
    cam_syn = tables.cam_syn.copy()
    for f in range(c.n_kernels):
        for y in range(c.conv_hw):
            for x in range(c.conv_hw):
                neuron = conv_idx(f, y, x)
                entries = []
                for ky in range(c.kernel):
                    iy = y * c.stride - pad + ky
                    if not (0 <= iy < c.input_hw):
                        continue
                    for kx in range(c.kernel):
                        ix = x * c.stride - pad + kx
                        if not (0 <= ix < c.input_hw):
                            continue
                        w = float(kernels[f, ky, kx])
                        if w == 0.0:
                            continue
                        syn = SynapseType.FAST_EXC if w > 0 else SynapseType.SUB_INH
                        entries.append((iy * c.input_hw + ix, syn))
                row = cam_tag[neuron]
                free = np.flatnonzero(row < 0)
                if len(free) < len(entries):
                    raise ValueError(
                        f"CAM overflow at conv neuron {neuron}: "
                        f"{len(entries)} taps > {len(free)} free words"
                    )
                for slot, (tag, syn) in zip(free, entries):
                    cam_tag[neuron, slot] = tag
                    cam_syn[neuron, slot] = syn
    tables = dataclasses.replace(tables, cam_tag=cam_tag, cam_syn=cam_syn)

    report = build_report(spec, tables) if with_report else None
    return CompiledCnn(
        tables=tables,
        cfg=c,
        conv=(conv0, n_conv),
        pool=(pool0, pool0 + n_pool),
        out=(out0, out0 + n_out),
        conv_clusters=conv_clusters,
        report=report,
    )
