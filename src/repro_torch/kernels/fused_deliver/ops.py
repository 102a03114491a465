"""Wrapper of the fused-delivery CUDA kernel (``csrc/fused_deliver.cu``).

:func:`fused_deliver` consumes an :class:`~repro_torch.core.two_stage.EventQueue`
and the SRAM tables as they are: the gather of the queued events' SRAM rows
happens inside the kernel, so a call puts one kernel and no other operation
on the device. CPU tensors go to the plain version
(:func:`~repro_torch.kernels.fused_deliver.ref.fused_deliver_ref`); CUDA
tensors launch the kernel or raise. ``fused_deliver.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.two_stage import N_SYN_TYPES, EventQueue
from repro_torch.kernels import _split
from repro_torch.kernels._build import check_status, device_scope, library, require
from repro_torch.kernels.fused_deliver.ref import fused_deliver_ref

__all__ = ["WorkSplit", "fused_deliver", "fused_deliver_ref", "kernel_info", "work_split"]

MAX_SLOTS_PER_WARP = 256  # a chunk of 8 x 256 live slots: 16 KB of shared memory


@dataclasses.dataclass(frozen=True)
class WorkSplit:
    """How one call is cut into blocks (see ``kernels/_split.py``).

    ``batch_tile`` batch elements per block; ``parts`` blocks (one
    thread-block cluster) per (cluster, tile), each taking a contiguous share
    of the tile's ``batch_tile * Q`` queue slots and a part of the neurons;
    each warp compacts ``slots_per_warp`` slots per chunk of the share.
    """

    batch_tile: int
    parts: int
    slots_per_warp: int
    shared_bytes: int


def shared_bytes(batch_tile: int, k_tags: int, slots_per_warp: int) -> int:
    """Dynamic shared bytes of one block: the activity rows (K + 1 floats
    each) and the chunk's live-slot list (a source id and a weight each)."""
    return 4 * (batch_tile * (k_tags + 1) + 2 * _split.WARPS * slots_per_warp)


@functools.cache
def work_split(
    batch: int, q_slots: int, cluster_size: int, k_tags: int,
    limit: int = _split.SHARED_OPTIN_H100,
) -> WorkSplit:
    parts = _split.parts_for(cluster_size)

    def slots_per_warp(tile: int) -> int:
        share = math.ceil(tile * q_slots / parts)
        per_warp = math.ceil(share / _split.WARPS / 32) * 32
        return min(MAX_SLOTS_PER_WARP, max(32, per_warp))

    tile = _split.fit_batch_tile(
        batch, lambda t: shared_bytes(t, k_tags, slots_per_warp(t)), limit, "fused_deliver"
    )
    spw = slots_per_warp(tile)
    return WorkSplit(tile, parts, spw, shared_bytes(tile, k_tags, spw))


@functools.cache
def _launcher():
    fn = library("fused_deliver").fused_deliver_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _shared_memory_limit(device_index: int) -> int:
    """Bytes of shared memory one block may opt in to on this card."""
    fn = library("fused_deliver").fused_deliver_max_shared_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    limit = fn(device_index)
    if limit <= 0:
        raise RuntimeError(f"fused_deliver: cannot read the shared-memory limit ({limit})")
    return limit


def kernel_info(split: WorkSplit, k_tags: int) -> dict[str, int]:
    """The compiled kernel for ``split`` at ``k_tags`` on the current card,
    with the int4 reads of the SRAM and CAM rows of the Table-V shape:
    registers and local (spill) bytes per thread, the dynamic shared bytes
    the library gives a block, and the blocks that fit on one SM."""
    lib = library("fused_deliver")
    fn = lib.fused_deliver_kernel_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    check_status(lib, fn(split.batch_tile, k_tags, split.slots_per_warp,
                         *(ctypes.byref(x) for x in out)), "fused_deliver_kernel_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def fused_deliver(
    queue: EventQueue,
    src_tag: torch.Tensor,  # [N, E] int32
    src_dest: torch.Tensor,  # [N, E] int32
    cam_tag: torch.Tensor,  # [N, S] int32
    cam_syn: torch.Tensor,  # [N, S] int32
    cluster_size: int,
    k_tags: int,
    external_activity: torch.Tensor | None = None,  # [..., n_clusters, K] float32
    syn_onehot: torch.Tensor | None = None,  # plain version only
) -> torch.Tensor:  # [..., N, 4] float32
    dev = queue.src.device
    if dev.type == "cpu":
        return fused_deliver_ref(
            queue, src_tag, src_dest, cam_tag, cam_syn, cluster_size, k_tags,
            external_activity=external_activity, syn_onehot=syn_onehot,
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_deliver runs on CPU or CUDA tensors, got {dev}")
    n, s = cam_tag.shape
    n_clusters = n // cluster_size
    if n != n_clusters * cluster_size or src_tag.shape[0] != n:
        raise ValueError(
            f"tables of {src_tag.shape[0]} / {n} neurons do not tile clusters of "
            f"{cluster_size}"
        )
    batch_shape = queue.src.shape[:-1]
    b, q = math.prod(batch_shape), queue.src.shape[-1]
    e = src_tag.shape[1]
    if not 0 < b < 65536:
        raise ValueError(f"fused_deliver takes a batch of 1..65535 rows, got {b}")
    require(queue.src, "queue.src", torch.int32, dev)
    require(queue.weight, "queue.weight", torch.float32, dev, tuple(queue.src.shape))
    require(src_tag, "src_tag", torch.int32, dev, (n, e))
    require(src_dest, "src_dest", torch.int32, dev, (n, e))
    require(cam_tag, "cam_tag", torch.int32, dev, (n, s))
    require(cam_syn, "cam_syn", torch.int32, dev, (n, s))
    ext_ptr = None
    if external_activity is not None:
        require(external_activity, "external_activity", torch.float32, dev,
                (*batch_shape, n_clusters, k_tags))
        ext_ptr = external_activity.data_ptr()
    _split.check_int32("fused_deliver", queue=b * q, drive=b * n * N_SYN_TYPES,
                       external_activity=b * n_clusters * k_tags, src_tag=n * e, cam_tag=n * s,
                       event_keys=8 * n)  # a live slot's key is src * 8 + its row in the tile
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    split = work_split(b, q, cluster_size, k_tags, _shared_memory_limit(index))
    out = torch.empty((*batch_shape, n, N_SYN_TYPES), dtype=torch.float32, device=dev)
    with device_scope(dev):
        status = _launcher()(
            queue.src.data_ptr(), queue.weight.data_ptr(), src_tag.data_ptr(),
            src_dest.data_ptr(), ext_ptr, cam_tag.data_ptr(), cam_syn.data_ptr(),
            out.data_ptr(), b, q, n_clusters, cluster_size, k_tags, s, e,
            split.batch_tile, split.parts, split.slots_per_warp,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("fused_deliver"), status, "fused_deliver")
    fused_deliver.launches += 1
    return out


fused_deliver.launches = 0
