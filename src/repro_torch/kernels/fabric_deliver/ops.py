"""Time-wheel fabric delivery: static entry tables, the ring step, and the
wrapper of the ``fabric_deliver`` CUDA kernel (``csrc/fabric_deliver.cu``).

Counterpart of ``repro.kernels.fabric_deliver.ops``. The roll-based fabric
step re-derives every event's route per step; all of that is a function of
the routing tables, which never change at run time.
:func:`build_fabric_entries` hoists it to engine construction (and
:func:`build_fabric_entries_slabs` for several resident models): one host-side
pass enumerates the ``M`` occupied SRAM entries and precomputes, per entry,
the flat destination address, arrival delay, directed-link bin and the
Table II-IV per-event figures, statically sorted in **arbitration order**
``(link, src, entry)``. Per step, :func:`fabric_deliver_ring` then does:

  * queue admission  = one masked prefix count over the spike vector
    (the first ``capacity`` active sources, lowest id first);
  * link arbitration = one masked prefix count over the entry axis: the
    FIFO position of an active cross-tile entry is the number of active
    cross-tile entries before it in its link group, no sort at run time;
  * stats            = masked sums of the static per-entry columns;
  * ring update + CAM match = :func:`fabric_deliver`: the masked weights
    are scattered at their cursor-rotated ring targets, the cursor slot
    plus external input is popped as the arrival row, and the row is
    CAM-matched. CUDA tensors launch the kernel (or raise); CPU tensors, or
    ``kernel=False``, take the plain version
    (:func:`~repro_torch.kernels.fabric_deliver.ref.fabric_deliver_ref`).

The table also carries, for the kernel, each destination cluster's own
entries (:func:`entry_cluster_ranges`): the kernel's block of cluster ``c``
walks ``cluster_order[cluster_start[c]:cluster_start[c + 1]]`` and no other
entry.

``fabric_deliver.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.dispatch import DeliveryStats
from repro_torch.core.tracing import span
from repro_torch.core.two_stage import N_SYN_TYPES, _scatter_count
from repro_torch.kernels import _split
from repro_torch.kernels._build import check_status, device_scope, library, require
from repro_torch.kernels.fabric_deliver.ref import fabric_deliver_ref

__all__ = [
    "FabricEntries",
    "WorkSplit",
    "build_fabric_entries",
    "build_fabric_entries_slabs",
    "entry_cluster_ranges",
    "fabric_deliver",
    "fabric_deliver_ring",
    "kernel_info",
    "work_split",
]


@dataclasses.dataclass(frozen=True)
class FabricEntries:
    """Static per-SRAM-entry routing table, sorted in arbitration order.

    One row per *occupied* SRAM entry (``src_tag >= 0``), statically
    lexsorted by ``(link, src, entry)``: intra-tile entries (``link = -1``)
    first, then each directed link's group in the arbiter's scan order.
    ``link_start[m]`` is the index of row ``m``'s link-group start, so an
    active entry's FIFO position is a prefix-count difference. ``valid`` is
    ``False`` only on the single pad row of an entry-less table. ``alive``
    is ``False`` on an entry that fault injection severs statically (see
    :func:`build_fabric_entries`), and ``severed`` says whether any is: a
    healthy table's ring step runs no fault-mask operation.

    ``cluster_start [n_clusters + 1]`` and ``cluster_order [M]`` group the
    rows by destination cluster (:func:`entry_cluster_ranges`): the rows of
    cluster ``c`` are ``cluster_order[cluster_start[c]:cluster_start[c + 1]]``,
    in arbitration order.
    """

    src: torch.Tensor  # [M] int32 source neuron id
    dstk: torch.Tensor  # [M] int32 flat dst_cluster * K + tag
    delay: torch.Tensor  # [M] int32 arrival delay in steps
    cross: torch.Tensor  # [M] bool inter-tile (link-arbitrated)
    link_start: torch.Tensor  # [M] int32 index of this entry's link-group start
    # flat directed tile pair src_tile * n_tiles + dst_tile for per-link
    # stats; intra-tile entries carry the tile's self-link diagonal (not
    # the sort key, which keeps them first)
    link: torch.Tensor  # [M] int32
    hops: torch.Tensor  # [M] int32 mesh hops (Table IV)
    latency_s: torch.Tensor  # [M] float32 per-event latency (Table II)
    energy_j: torch.Tensor  # [M] float32 per-event energy (Table III/IV)
    valid: torch.Tensor  # [M] bool
    # fault injection (DESIGN.md §15): a False entry is statically severed
    # (dead tile/link or Bernoulli route erasure): its events always drop,
    # are counted in link_dropped, and never consume link-FIFO capacity
    alive: torch.Tensor  # [M] bool
    cluster_start: torch.Tensor  # [n_clusters + 1] int32 offsets into cluster_order
    cluster_order: torch.Tensor  # [M] int32 row ids grouped by destination cluster

    @functools.cached_property
    def severed(self) -> bool:
        """Whether some entry is severed (read from the device once per table)."""
        return not bool(self.alive.all())


_COLUMNS = tuple(f.name for f in dataclasses.fields(FabricEntries))


def entry_cluster_ranges(
    dstk: torch.Tensor, n_clusters: int, k_tags: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each destination cluster's own entries: ``(cluster_start [nc + 1],
    cluster_order [M])``, int32, on ``dstk``'s device.

    Entry ``m`` belongs to cluster ``dstk[m] // K``; ``cluster_order`` lists
    the entry ids cluster by cluster, each cluster's in ascending
    (arbitration) order, and cluster ``c``'s run is ``cluster_order[
    cluster_start[c]:cluster_start[c + 1]]``. An entry whose cluster lies
    outside ``[0, n_clusters)`` is in no run (it is listed after the last
    one): no cluster's activity row holds its address.
    """
    cl = torch.div(dstk.long(), k_tags, rounding_mode="floor")
    key = torch.where((cl >= 0) & (cl < n_clusters), cl, n_clusters)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_clusters + 1)[:n_clusters]
    start = torch.zeros(n_clusters + 1, dtype=torch.int64, device=dstk.device)
    start[1:] = torch.cumsum(counts, 0)
    return start.to(torch.int32), order.to(torch.int32)


def _to_device(cols: dict[str, np.ndarray], device, n_clusters: int, k_tags: int) -> FabricEntries:
    start, order = entry_cluster_ranges(torch.as_tensor(cols["dstk"]), n_clusters, k_tags)
    cols = {**cols, "cluster_start": start, "cluster_order": order}
    dev = resolve_device(device)
    return FabricEntries(**{k: torch.as_tensor(cols[k], device=dev) for k in _COLUMNS})


def build_fabric_entries(
    src_tag,  # [N, E] int32, -1 = empty (numpy or tensor)
    src_dest,  # [N, E] int32 destination cluster ids
    cluster_size: int,
    k_tags: int,
    model,  # routing.FabricDeliveryModel
    device: torch.device | str = "cuda",
    entry_alive=None,  # [N, E] bool fault mask (numpy or tensor; faults.entry_alive_mask)
) -> FabricEntries:
    """Host-side precompute of the static entry table (numpy, once per
    engine), uploaded to ``device``.

    ``entry_alive`` (from :func:`repro_torch.core.faults.entry_alive_mask`,
    or derived here from the model's fault matrices when omitted) statically
    severs faulted entries: they keep their table row, so the fault is
    observable as a per-step ``link_dropped`` count, but never deliver and
    never occupy link-FIFO capacity (a dead link has no FIFO). A severed
    entry reaches the kernel as weight 0.
    """
    src_tag = np.asarray(torch.as_tensor(src_tag).cpu())
    src_dest = np.asarray(torch.as_tensor(src_dest).cpu())
    n_clusters = np.asarray(model.tile_of_cluster).shape[0]
    if entry_alive is None and getattr(model, "pair_alive", None) is not None:
        from repro_torch.core.faults import entry_alive_mask

        entry_alive = entry_alive_mask(src_tag, src_dest, cluster_size, model)
    src_ids, e_ids = np.nonzero(src_tag >= 0)
    if src_ids.size == 0:  # entry-less table: one inert pad row
        return _to_device(_pad_entries(), device, n_clusters, k_tags)
    tag = src_tag[src_ids, e_ids].astype(np.int64)
    dst = np.clip(src_dest[src_ids, e_ids], 0, n_clusters - 1).astype(np.int64)
    alive = (None if entry_alive is None
             else np.asarray(torch.as_tensor(entry_alive).cpu())[src_ids, e_ids])
    return _to_device(
        _entries_from_raw(src_ids, e_ids, tag, dst, cluster_size, k_tags, model, alive),
        device, n_clusters, k_tags,
    )


def build_fabric_entries_slabs(
    per_model,  # sequence of (src_tag_m [N_m, E_m], src_dest_m [N_m, E_m])
    cluster_size: int,
    k_tags: int,  # the combined table's K (flat dstk addressing)
    model,  # routing.FabricDeliveryModel over the combined cluster count
    device: torch.device | str = "cuda",
) -> FabricEntries:
    """Entry table for several resident models, built slab by slab.

    Each model's raw entry rows are rebased by its slab's neuron and cluster
    offsets (slabs laid out back to back, in order), then one arbitration
    sort merges them: the models share the link FIFOs, so each link's group
    interleaves every model's entries in source order. Equal to
    :func:`build_fabric_entries` on the concatenated table
    (``tags.concat_tables``), ``cluster_start`` / ``cluster_order`` included:
    they are taken at the combined cluster count and K.

    A faulted ``model`` raises: the fault masks are drawn over the full
    table grid, so it must be built from the concatenated tables.
    """
    if getattr(model, "pair_alive", None) is not None:
        raise ValueError(
            "build_fabric_entries_slabs does not support fault injection — "
            "build from the concatenated tables (build_fabric_entries) so "
            "the route-erasure draw sees the full table grid"
        )
    srcs, ents, tags, dsts = [], [], [], []
    n0 = 0
    nc = np.asarray(model.tile_of_cluster).shape[0]
    for src_tag_m, src_dest_m in per_model:
        src_tag_m = np.asarray(torch.as_tensor(src_tag_m).cpu())
        src_dest_m = np.asarray(torch.as_tensor(src_dest_m).cpu())
        c0 = n0 // cluster_size
        s_m, e_m = np.nonzero(src_tag_m >= 0)
        srcs.append(s_m + n0)
        ents.append(e_m)
        tags.append(src_tag_m[s_m, e_m].astype(np.int64))
        dsts.append(np.clip(src_dest_m[s_m, e_m] + c0, 0, nc - 1).astype(np.int64))
        n0 += src_tag_m.shape[0]
    src_ids = np.concatenate(srcs) if srcs else np.zeros(0, np.int64)
    if src_ids.size == 0:
        return _to_device(_pad_entries(), device, nc, k_tags)
    return _to_device(
        _entries_from_raw(src_ids, np.concatenate(ents), np.concatenate(tags),
                          np.concatenate(dsts), cluster_size, k_tags, model),
        device, nc, k_tags,
    )


def _pad_entries() -> dict[str, np.ndarray]:
    """One inert pad row for an entry-less table."""
    ints = ("src", "dstk", "delay", "link_start", "link", "hops")
    return {
        **{k: np.zeros(1, np.int32) for k in ints},
        "cross": np.zeros(1, bool),
        "latency_s": np.zeros(1, np.float32),
        "energy_j": np.zeros(1, np.float32),
        "valid": np.zeros(1, bool),
        "alive": np.ones(1, bool),
    }


def _entries_from_raw(
    src_ids, e_ids, tag, dst, cluster_size, k_tags, model, alive=None
) -> dict[str, np.ndarray]:
    """Arbitration-order sort + static per-entry figures from raw entry rows.

    ``src_ids``/``e_ids`` arrive in row-major table order (src asc, entry
    asc), so the stable lexsort yields one canonical arbitration order.
    """
    tiles = np.asarray(model.tile_of_cluster)
    src_cl = src_ids // cluster_size
    s_tile = tiles[src_cl]
    d_tile = tiles[dst]
    cross = s_tile != d_tile
    link = np.where(cross, s_tile * model.n_tiles + d_tile, -1)
    stat_link = np.where(cross, s_tile * model.n_tiles + d_tile,
                         s_tile * model.n_tiles + s_tile)
    # arbitration order: link groups, each scanned (src asc, entry asc) —
    # identical to dispatch_slots' stable argsort of queue-major event order
    order = np.lexsort((e_ids, src_ids, link))
    src_s, dst_s, tag_s = src_ids[order], dst[order], tag[order]
    cl_s, link_s = src_cl[order], link[order]
    m = src_s.size
    is_start = np.ones(m, bool)
    is_start[1:] = link_s[1:] != link_s[:-1]
    link_start = np.maximum.accumulate(np.where(is_start, np.arange(m), 0))
    return {
        "src": src_s.astype(np.int32),
        "dstk": (dst_s * k_tags + tag_s).astype(np.int32),
        "delay": np.asarray(model.delay_steps)[cl_s, dst_s].astype(np.int32),
        "cross": cross[order],
        "link_start": link_start.astype(np.int32),
        "link": stat_link[order].astype(np.int32),
        "hops": np.asarray(model.mesh_hops)[cl_s, dst_s].astype(np.int32),
        "latency_s": np.asarray(model.latency_s)[cl_s, dst_s].astype(np.float32),
        "energy_j": np.asarray(model.energy_j)[cl_s, dst_s].astype(np.float32),
        "valid": np.ones(m, bool),
        "alive": np.ones(m, bool) if alive is None else np.asarray(alive, bool)[order],
    }


def _count_bins(mask: torch.Tensor, bins: torch.Tensor, size: int) -> torch.Tensor:
    """Per-bin counts of a ``[..., M]`` entry mask at static ``[M]`` bins."""
    return _scatter_count(mask[..., None], bins[:, None].expand(mask.shape + (1,)), size)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkSplit:
    """How one call is cut into blocks (see ``kernels/_split.py``):
    ``batch_tile`` batch elements per block, ``parts`` blocks per
    (cluster, tile), each with a k-slice of ``ceil(K / parts)`` cells of every
    ring slot and a part of the neurons."""

    batch_tile: int
    parts: int
    shared_bytes: int


def shared_bytes(batch_tile: int, k_tags: int, d1: int, parts: int) -> int:
    """Dynamic shared bytes of one block: the arrival rows (K + 1 floats
    each) and the block's k-slice of the D1 slots, per batch element."""
    return 4 * batch_tile * ((k_tags + 1) + d1 * math.ceil(k_tags / parts))


@functools.cache
def work_split(
    batch: int, cluster_size: int, k_tags: int, d1: int,
    limit: int = _split.SHARED_OPTIN_H100,
) -> WorkSplit:
    parts = _split.parts_for(cluster_size)
    tile = _split.fit_batch_tile(
        batch, lambda t: shared_bytes(t, k_tags, d1, parts), limit, "fabric_deliver"
    )
    return WorkSplit(tile, parts, shared_bytes(tile, k_tags, d1, parts))


@functools.cache
def _launcher():
    fn = library("fabric_deliver").fabric_deliver_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _shared_memory_limit(device_index: int) -> int:
    """Bytes of shared memory one block may opt in to on this card."""
    fn = library("fabric_deliver").fabric_deliver_max_shared_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    limit = fn(device_index)
    if limit <= 0:
        raise RuntimeError(f"fabric_deliver: cannot read the shared-memory limit ({limit})")
    return limit


def kernel_info(split: WorkSplit, k_tags: int, d1: int) -> dict[str, int]:
    """The compiled kernel for ``split`` at ``k_tags`` and ``d1`` ring slots
    on the current card, with the int4 CAM reads of the Table-V shape:
    registers and local (spill) bytes per thread, the dynamic shared bytes
    the library gives a block, and the blocks that fit on one SM."""
    lib = library("fabric_deliver")
    fn = lib.fabric_deliver_kernel_info
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    check_status(lib, fn(split.batch_tile, k_tags, d1, split.parts,
                         *(ctypes.byref(x) for x in out)), "fabric_deliver_kernel_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def fabric_deliver(
    dstk: torch.Tensor,  # [M] int32 flat dst_cluster * K + tag, batch-shared
    delay: torch.Tensor,  # [M] int32 arrival delay in steps
    w: torch.Tensor,  # [..., M] float32 masked weights (0 = not delivered)
    ring: torch.Tensor,  # [..., D1, nc, K] float32 carried ring
    cursor: torch.Tensor,  # 0-dim int32 write cursor in [0, D1)
    external_activity: torch.Tensor | None,  # [..., nc, K] float32 or None
    cam_tag: torch.Tensor,  # [N, S] int32
    cam_syn: torch.Tensor,  # [N, S] int32
    cluster_size: int,
    k_tags: int,
    syn_onehot: torch.Tensor | None = None,  # plain version only
    *,
    cluster_start: torch.Tensor | None = None,  # [nc + 1] int32, FabricEntries'
    cluster_order: torch.Tensor | None = None,  # [M] int32, FabricEntries'
) -> tuple[torch.Tensor, torch.Tensor]:  # (drive [..., N, 4], new ring)
    """Ring update + arrival pop + CAM match; the kernel on CUDA tensors.

    Returns a new ring tensor; the ring passed in is not written. The
    kernel walks each cluster's own entries through ``cluster_start`` /
    ``cluster_order``, the static ranges of :class:`FabricEntries`; a caller
    without them gets them from :func:`entry_cluster_ranges`, which costs a
    few device operations per call.
    """
    dev = w.device
    if dev.type == "cpu":
        return fabric_deliver_ref(
            dstk, delay, w, ring, cursor, external_activity, cam_tag, cam_syn,
            cluster_size, k_tags, syn_onehot,
        )
    if dev.type != "cuda":
        raise ValueError(f"fabric_deliver runs on CPU or CUDA tensors, got {dev}")
    n, s = cam_tag.shape
    n_clusters = n // cluster_size
    if n != n_clusters * cluster_size:
        raise ValueError(f"cam_tag has {n} rows, not a multiple of clusters of {cluster_size}")
    batch_shape = w.shape[:-1]
    b, m = math.prod(batch_shape), w.shape[-1]
    d1 = ring.shape[-3]
    if not 0 < b < 65536:
        raise ValueError(f"fabric_deliver takes a batch of 1..65535 rows, got {b}")
    require(dstk, "dstk", torch.int32, dev, (m,))
    require(delay, "delay", torch.int32, dev, (m,))
    require(w, "w", torch.float32, dev)
    require(ring, "ring", torch.float32, dev, (*batch_shape, d1, n_clusters, k_tags))
    require(cursor, "cursor", torch.int32, dev, ())
    require(cam_tag, "cam_tag", torch.int32, dev, (n, s))
    require(cam_syn, "cam_syn", torch.int32, dev, (n, s))
    if cluster_start is None or cluster_order is None:
        cluster_start, cluster_order = entry_cluster_ranges(dstk, n_clusters, k_tags)
    require(cluster_start, "cluster_start", torch.int32, dev, (n_clusters + 1,))
    require(cluster_order, "cluster_order", torch.int32, dev, (m,))
    ext_ptr = None
    if external_activity is not None:
        external_activity = external_activity.expand(
            *batch_shape, n_clusters, k_tags
        ).contiguous()
        require(external_activity, "external_activity", torch.float32, dev)
        ext_ptr = external_activity.data_ptr()
    _split.check_int32("fabric_deliver", w=b * m, ring=b * d1 * n_clusters * k_tags,
                       drive=b * n * N_SYN_TYPES, cam_tag=n * s)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    split = work_split(b, cluster_size, k_tags, d1, _shared_memory_limit(index))
    drive = torch.empty((*batch_shape, n, N_SYN_TYPES), dtype=torch.float32, device=dev)
    new_ring = torch.empty_like(ring)
    with device_scope(dev):
        status = _launcher()(
            dstk.data_ptr(), delay.data_ptr(), w.data_ptr(), ring.data_ptr(),
            cursor.data_ptr(), ext_ptr, cam_tag.data_ptr(), cam_syn.data_ptr(),
            cluster_start.data_ptr(), cluster_order.data_ptr(), drive.data_ptr(),
            new_ring.data_ptr(), b, n_clusters, cluster_size, k_tags, s, d1, m,
            split.batch_tile, split.parts, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("fabric_deliver"), status, "fabric_deliver")
    fabric_deliver.launches += 1
    return drive, new_ring


fabric_deliver.launches = 0


# ---------------------------------------------------------------------------
# the ring step
# ---------------------------------------------------------------------------
def fabric_deliver_ring(
    spikes: torch.Tensor,  # [..., N]
    entries: FabricEntries,
    cam_tag: torch.Tensor,  # [N, S]
    cam_syn: torch.Tensor,  # [N, S]
    cluster_size: int,
    k_tags: int,
    ring: torch.Tensor,  # [..., max_delay + 1, n_clusters, K]
    cursor: torch.Tensor,  # 0-dim int32
    *,
    max_delay: int,
    link_capacity: int | None,
    queue_capacity: int | None = None,
    external_activity: torch.Tensor | None = None,
    syn_onehot: torch.Tensor | None = None,
    per_link_stats: bool = False,
    n_tiles: int | None = None,  # required when per_link_stats
    kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, DeliveryStats]:
    """One time-wheel fabric step: ``(drive, ring, cursor, DeliveryStats)``.

    Bit-identical arrival steps, drop counts and integer stats to the roll
    path (``compact_events`` + ``stage1_route_events_fabric`` +
    ``advance_inflight``); float latency/energy sums agree to
    reduction-order tolerance. ``per_link_stats`` widens ``link_dropped`` to
    ``[..., n_tiles**2]`` and ``delivered`` to ``[..., n_clusters**2]``.
    ``kernel=False`` runs the plain version of the ring update on any
    device; by default CUDA tensors launch the ``fabric_deliver`` kernel.
    """
    n = spikes.shape[-1]
    n_clusters = n // cluster_size
    d1 = max_delay + 1
    batch_shape = spikes.shape[:-1]

    with span("repro_torch.deliver.queue"):
        # queue admission: compact_events truncation in mask form, the first
        # ``capacity`` active sources (ascending id = arbiter scan order) win
        active = spikes != 0
        cap = n if queue_capacity is None else min(int(queue_capacity), n)
        if cap >= n:
            in_q = active
            dropped = torch.zeros(batch_shape, dtype=torch.int32, device=spikes.device)
        else:
            pos = torch.cumsum(active, dim=-1, dtype=torch.int32)
            in_q = active & (pos <= cap)
            dropped = (pos[..., -1] - cap).clamp(min=0)

        act_e = torch.index_select(in_q, -1, entries.src) & entries.valid  # [..., M]
        # fault-severed entries always drop, counted with the link drops (a dead
        # link is a zero-capacity link), and never contend for a live link's
        # FIFO slots
        fault_mask = None
        if entries.severed:
            act_all, act_e = act_e, act_e & entries.alive
            fault_mask = act_all & ~entries.alive

        # per-directed-link FIFO arbitration without a sort: entries are in the
        # arbiter's scan order, so an active cross-tile entry's FIFO position is
        # the count of active cross-tile entries since its link start
        if link_capacity is None:
            kept = act_e
            drop_mask = torch.zeros_like(act_e) if fault_mask is None else fault_mask
        else:
            cnt = (act_e & entries.cross).to(torch.int32)
            excl = torch.cumsum(cnt, dim=-1, dtype=torch.int32) - cnt
            pos_in_link = excl - torch.index_select(excl, -1, entries.link_start)
            keep_cross = pos_in_link < link_capacity
            kept = act_e & (~entries.cross | keep_cross)
            drop_mask = act_e & entries.cross & ~keep_cross
            if fault_mask is not None:
                # disjoint masks (alive vs severed), so the union's per-bin
                # counts sum to exactly the scalar fault + overflow totals
                drop_mask = drop_mask | fault_mask

    if per_link_stats:
        if n_tiles is None:
            raise ValueError("per_link_stats=True requires n_tiles")
        link_dropped = _count_bins(drop_mask, entries.link, n_tiles * n_tiles)
        pair = (
            torch.div(entries.src, cluster_size, rounding_mode="floor") * n_clusters
            + torch.div(entries.dstk, k_tags, rounding_mode="floor")
        )
        delivered = _count_bins(kept, pair, n_clusters * n_clusters)
    else:
        link_dropped = drop_mask.sum(-1, dtype=torch.int32)
        delivered = kept.sum(-1, dtype=torch.int32)

    zero_i = torch.zeros((), dtype=torch.int32, device=spikes.device)
    zero_f = torch.zeros((), dtype=torch.float32, device=spikes.device)
    stats = DeliveryStats(
        dropped=dropped,
        link_dropped=link_dropped,
        delivered=delivered,
        hops=torch.where(kept, entries.hops, zero_i).sum(-1, dtype=torch.int32),
        latency_s=torch.where(kept, entries.latency_s, zero_f).sum(-1, dtype=torch.float32),
        energy_j=torch.where(kept, entries.energy_j, zero_f).sum(-1, dtype=torch.float32),
    )

    # dropped and silent entries carry weight exactly 0 (adding 0.0 is the
    # no-op), so every entry keeps its static ring target
    w = torch.index_select(spikes, -1, entries.src) * kept.to(spikes.dtype)
    args = (entries.dstk, entries.delay, w, ring, cursor, external_activity, cam_tag,
            cam_syn, cluster_size, k_tags, syn_onehot)
    if kernel:
        drive, ring = fabric_deliver(*args, cluster_start=entries.cluster_start,
                                     cluster_order=entries.cluster_order)
    else:
        drive, ring = fabric_deliver_ref(*args)
    return drive, ring, (cursor + 1) % d1, stats
