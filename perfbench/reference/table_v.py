"""The Table-V poker-DVS network and the 3x3 board, worked out from their
definitions (paper §V, Table V; R1/R2/R3 figures of Table II).

Nothing here reads the program's routing tables: the dense connectivity is
built from the CNN's own description (four oriented 8x8 edge kernels at
stride 2, 2x2 pooling with an integer weight of ``pool_copies``, one output
population of ``pop_per_class`` neurons per class reading its own feature
map's pooling units), and the board's arrival delays from the XY hops
between the chips that hold the source and destination cores.

Synapse types are indexed fast-excitatory, slow-excitatory, subtractive
inhibitory, shunting inhibitory (0-3), as in the paper's DPI block.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

FAST_EXC, SLOW_EXC, SUB_INH, SHUNT_INH = range(4)
N_SYN = 4


def edge_kernels(k: int) -> np.ndarray:
    """Four ternary detectors ``[4, k, k]``: a vertical edge (a band of +1
    two columns wide in the centre, -1 beyond a one-column gap), the same
    turned to horizontal, an upward vertex (a +1 chevron two rows thick,
    -1 below it past a one-row gap) and the vertex mirrored downward."""
    ks = np.zeros((4, k, k), dtype=np.float32)
    half = k // 2
    for x in range(k):
        if half - 1 <= x <= half:
            ks[0, :, x] = 1.0
        elif x < half - 2 or x >= half + 2:
            ks[0, :, x] = -1.0
    ks[1] = ks[0].T
    for y in range(k):
        for x in range(k):
            d = y - abs(x - half)
            ks[2, y, x] = 1.0 if 0 <= d <= 1 else (-1.0 if d > 2 else 0.0)
    ks[3] = ks[2, ::-1, :]
    return ks


@dataclasses.dataclass(frozen=True)
class Layout:
    """Neuron ranges ``[start, stop)`` of the three layers."""

    n: int
    conv: tuple[int, int]
    pool: tuple[int, int]
    out: tuple[int, int]


def layout(net: dict) -> Layout:
    n_conv = net["n_kernels"] * net["conv_hw"] ** 2
    pool_hw = net["conv_hw"] // net["pool"]
    n_pool = net["n_kernels"] * pool_hw**2
    n_out = net["n_classes"] * net["pop_per_class"]
    return Layout(n_conv + n_pool + n_out, (0, n_conv), (n_conv, n_conv + n_pool),
                  (n_conv + n_pool, n_conv + n_pool + n_out))


@dataclasses.dataclass
class Network:
    """Dense connectivity and per-source routing figures, on one device.

    ``w_int[d]`` is ``[N, N * 4]``: the synapse count from source ``s`` to
    (target ``n``, type ``t``) at column ``n * 4 + t``, for events that
    arrive ``d`` steps after the step that routes them. ``w_ext`` is ``[nc,
    K, cluster_size * 4]``: what an external event on (cluster, tag) drives
    in that cluster's neurons. Per source: ``entries`` SRAM entries, their
    summed mesh ``hops``, and ``link_entries [N, L]``, the entries that
    cross each directed chip-to-chip link.
    """

    layout: Layout
    cluster_size: int
    k_tags: int
    n_clusters: int
    w_int: list[torch.Tensor]
    w_ext: torch.Tensor
    entries: torch.Tensor
    hops: torch.Tensor
    link_entries: torch.Tensor
    link_capacity: int | None
    queue_capacity: int

    def to(self, device, dtype=torch.float32) -> "Network":
        def cast(t):
            return t.to(device=device, dtype=dtype)

        return dataclasses.replace(
            self, w_int=[cast(w) for w in self.w_int], w_ext=cast(self.w_ext),
            entries=cast(self.entries), hops=cast(self.hops),
            link_entries=cast(self.link_entries),
        )


def connections(net: dict) -> tuple[list[tuple[int, int, int, int]], list[tuple[int, int, int]]]:
    """The network's synapses from its definition.

    Returns ``(internal, external)``: internal rows ``(src, dst, syn,
    count)`` and external rows ``(pixel, dst, syn)``, one per kernel tap.
    """
    lay = layout(net)
    hw, ck, stride, k = net["conv_hw"], net["n_kernels"], net["stride"], net["kernel"]
    in_hw, pool = net["input_hw"], net["pool"]
    pool_hw = hw // pool
    # "same" placement of a stride-s convolution: the padding that maps the
    # conv_hw outputs across the input_hw sensor
    pad = (hw * stride + k - stride - in_hw) // 2
    kernels = edge_kernels(k)

    def conv_idx(f, y, x):
        return lay.conv[0] + (f * hw + y) * hw + x

    def pool_idx(f, y, x):
        return lay.pool[0] + (f * pool_hw + y) * pool_hw + x

    internal, external = [], []
    for f in range(ck):
        for y in range(hw):
            for x in range(hw):
                n = conv_idx(f, y, x)
                for ky in range(k):
                    iy = y * stride - pad + ky
                    for kx in range(k):
                        ix = x * stride - pad + kx
                        w = kernels[f, ky, kx]
                        if w != 0 and 0 <= iy < in_hw and 0 <= ix < in_hw:
                            external.append((iy * in_hw + ix, n, FAST_EXC if w > 0 else SUB_INH))
                internal.append((n, pool_idx(f, y // pool, x // pool), FAST_EXC,
                                 net["pool_copies"]))
    per_map = pool_hw * pool_hw
    for cls in range(net["n_classes"]):
        # class ``cls`` reads feature map ``cls``'s pooling units
        for j in range(per_map):
            src = lay.pool[0] + cls * per_map + j
            for i in range(net["pop_per_class"]):
                internal.append((src, lay.out[0] + cls * net["pop_per_class"] + i, SLOW_EXC, 1))
    return internal, external


def board_tiles(n_clusters: int, board: dict) -> np.ndarray:
    """Chip of each core: cores fill a chip before the next (hierarchical
    linear placement), chips numbered row by row on the grid."""
    if board["placement"] != "hierarchical_linear":
        raise ValueError(f"unknown placement {board['placement']!r}")
    return np.arange(n_clusters) // board["cores_per_tile"]


def chip_hops(a: int, b: int, board: dict) -> int:
    gx = board["grid_x"]
    return abs(a % gx - b % gx) + abs(a // gx - b // gx)


def build(config: dict) -> Network:
    """The reference network of a configuration, on the CPU in float32."""
    net = config["network"]
    lay = layout(net)
    cs, k_tags = net["cluster_size"], net["k_tags"]
    n, nc = lay.n, lay.n // cs
    internal, external = connections(net)
    board = config["delivery"].get("board")
    dt = config["neuron"]["dt"]
    if board is None:  # one chip: every event arrives at the next step
        delay = np.zeros((nc, nc), np.int64)
        hops = np.zeros((nc, nc), np.int64)
        tiles = np.zeros(nc, np.int64)
        link_capacity = None
    else:
        tiles = board_tiles(nc, board)
        hops = np.array([[chip_hops(tiles[a], tiles[b], board) for b in range(nc)]
                         for a in range(nc)])
        delay = np.array([[math.ceil(h * board["latency_across_chip_s"] / dt) for h in row]
                          for row in hops])
        link_capacity = board["link_capacity"]
    d1 = int(delay.max()) + 1
    w_int = np.zeros((d1, n, n, N_SYN), np.float32)
    dest_clusters: dict[int, set[int]] = {}
    for src, dst, syn, count in internal:
        a, b = src // cs, dst // cs
        w_int[delay[a, b], src, dst, syn] += count
        dest_clusters.setdefault(src, set()).add(b)
    w_ext = np.zeros((nc, k_tags, cs, N_SYN), np.float32)
    for pixel, dst, syn in external:
        w_ext[dst // cs, pixel, dst % cs, syn] += 1.0
    # one SRAM entry per (source, destination core): the cores a source
    # reaches, and the chip-to-chip link each entry crosses
    n_tiles = board["grid_x"] * board["grid_y"] if board else 1
    entries = np.zeros(n, np.float32)
    hop_sum = np.zeros(n, np.float32)
    link_entries = np.zeros((n, n_tiles * n_tiles), np.float32)
    for src, dests in dest_clusters.items():
        a = src // cs
        entries[src] = len(dests)
        for b in dests:
            hop_sum[src] += hops[a, b]
            if tiles[a] != tiles[b]:
                link_entries[src, tiles[a] * n_tiles + tiles[b]] += 1
    return Network(
        layout=lay, cluster_size=cs, k_tags=k_tags, n_clusters=nc,
        w_int=[torch.from_numpy(w.reshape(n, n * N_SYN)) for w in w_int],
        w_ext=torch.from_numpy(w_ext.reshape(nc, k_tags, cs * N_SYN)),
        entries=torch.from_numpy(entries), hops=torch.from_numpy(hop_sum),
        link_entries=torch.from_numpy(link_entries), link_capacity=link_capacity,
        queue_capacity=int(config["delivery"]["queue_capacity"]),
    )


def cam_words(net: dict) -> int:
    """The CAM words the network programs: one per input tap of a conv
    neuron, ``pool_copies`` of one shared tag per pooling neuron, and one
    per pooling unit an output neuron reads."""
    _, external = connections(net)
    lay = layout(net)
    per_map = (net["conv_hw"] // net["pool"]) ** 2
    n_pool = lay.pool[1] - lay.pool[0]
    n_out = lay.out[1] - lay.out[0]
    return len(external) + n_pool * net["pool_copies"] + n_out * per_map
