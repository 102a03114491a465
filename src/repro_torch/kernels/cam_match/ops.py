"""Wrapper of the stage-2 CAM-match CUDA kernel (``csrc/cam_match.cu``).

``cam_match`` takes ``activity [..., n_clusters, K]`` and returns
``drive [..., N, 4]``. CPU tensors go to the plain version
(:func:`~repro_torch.kernels.cam_match.ref.cam_match_ref`); CUDA tensors
launch the kernel or raise. ``cam_match.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.two_stage import N_SYN_TYPES
from repro_torch.kernels import _split
from repro_torch.kernels._build import check_status, device_scope, library, require
from repro_torch.kernels.cam_match.ref import cam_match_ref


@dataclasses.dataclass(frozen=True)
class WorkSplit:
    """How one call is cut into blocks (see ``kernels/_split.py``):
    ``batch_tile`` batch elements per block, ``parts`` blocks per
    (cluster, tile), each with a part of the cluster's neurons."""

    batch_tile: int
    parts: int
    shared_bytes: int


def shared_bytes(batch_tile: int, k_tags: int) -> int:
    """Dynamic shared bytes of one block: the tile's activity rows, K + 1
    floats each (cell K holds the zero that empty words read)."""
    return 4 * batch_tile * (k_tags + 1)


@functools.cache
def work_split(
    batch: int, cluster_size: int, k_tags: int, limit: int = _split.SHARED_OPTIN_H100
) -> WorkSplit:
    parts = _split.parts_for(cluster_size, _split.CAM_MATCH_NEURONS_PER_BLOCK)
    tile = _split.fit_batch_tile(batch, lambda t: shared_bytes(t, k_tags), limit, "cam_match",
                                 _split.CAM_MATCH_BATCH_TILE)
    return WorkSplit(tile, parts, shared_bytes(tile, k_tags))


@functools.cache
def _launcher():
    fn = library("cam_match").cam_match_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _shared_memory_limit(device_index: int) -> int:
    """Bytes of shared memory one block may opt in to on this card."""
    fn = library("cam_match").cam_match_max_shared_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    limit = fn(device_index)
    if limit <= 0:
        raise RuntimeError(f"cam_match: cannot read the shared-memory limit ({limit})")
    return limit


def kernel_info(split: WorkSplit, k_tags: int) -> dict[str, int]:
    """The compiled kernel for ``split`` at ``k_tags`` on the current card,
    with the int4 CAM reads of the Table-V shape: registers and local
    (spill) bytes per thread, the dynamic shared bytes the library gives a
    block, and the blocks that fit on one SM."""
    lib = library("cam_match")
    fn = lib.cam_match_kernel_info
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    check_status(lib, fn(split.batch_tile, k_tags, *(ctypes.byref(x) for x in out)),
                 "cam_match_kernel_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def cam_match(
    activity: torch.Tensor,  # [..., n_clusters, K] float32
    cam_tag: torch.Tensor,  # [N, S] int32, -1 empty
    cam_syn: torch.Tensor,  # [N, S] int32
    cluster_size: int,
) -> torch.Tensor:  # [..., N, 4] float32
    dev = activity.device
    if dev.type == "cpu":
        return cam_match_ref(activity, cam_tag, cam_syn, cluster_size)
    if dev.type != "cuda":
        raise ValueError(f"cam_match runs on CPU or CUDA tensors, got {dev}")
    n, s = cam_tag.shape
    n_clusters, k = activity.shape[-2:]
    batch_shape = activity.shape[:-2]
    b = math.prod(batch_shape)
    if n != n_clusters * cluster_size:
        raise ValueError(
            f"cam_tag has {n} rows, activity has {n_clusters} clusters of {cluster_size}"
        )
    if not 0 < b < 65536:
        raise ValueError(f"cam_match takes a batch of 1..65535 rows, got {b}")
    require(activity, "activity", torch.float32, dev)
    require(cam_tag, "cam_tag", torch.int32, dev, (n, s))
    require(cam_syn, "cam_syn", torch.int32, dev, (n, s))
    _split.check_int32("cam_match", activity=b * n_clusters * k, cam_tag=n * s,
                       drive=b * n * N_SYN_TYPES)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    split = work_split(b, cluster_size, k, _shared_memory_limit(index))
    out = torch.empty((*batch_shape, n, N_SYN_TYPES), dtype=torch.float32, device=dev)
    with device_scope(dev):
        status = _launcher()(
            activity.data_ptr(), cam_tag.data_ptr(), cam_syn.data_ptr(), out.data_ptr(),
            b, n_clusters, cluster_size, k, s, split.batch_tile, split.parts,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("cam_match"), status, "cam_match")
    cam_match.launches += 1
    return out


cam_match.launches = 0
