"""Wrapper of the stage-2 CAM-match CUDA kernel (``csrc/cam_match.cu``).

``cam_match`` takes ``activity [..., n_clusters, K]`` and returns
``drive [..., N, 4]``. CPU tensors go to the plain version
(:func:`~repro_torch.kernels.cam_match.ref.cam_match_ref`); CUDA tensors
launch the kernel or raise. ``cam_match.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.two_stage import N_SYN_TYPES
from repro_torch.kernels._build import check_status, library, require
from repro_torch.kernels.cam_match.ref import cam_match_ref


@functools.cache
def _launcher():
    fn = library("cam_match").cam_match_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cam_match(
    activity: torch.Tensor,  # [..., n_clusters, K] float32
    cam_tag: torch.Tensor,  # [N, S] int32, -1 empty
    cam_syn: torch.Tensor,  # [N, S] int32
    cluster_size: int,
) -> torch.Tensor:  # [..., N, 4] float32
    if activity.device.type == "cpu":
        return cam_match_ref(activity, cam_tag, cam_syn, cluster_size)
    if activity.device.type != "cuda":
        raise ValueError(f"cam_match runs on CPU or CUDA tensors, got {activity.device}")
    dev = activity.device
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
    out = torch.empty((*batch_shape, n, N_SYN_TYPES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _launcher()(
            activity.data_ptr(), cam_tag.data_ptr(), cam_syn.data_ptr(), out.data_ptr(),
            b, n_clusters, cluster_size, k, s,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("cam_match"), status, "cam_match")
    cam_match.launches += 1
    return out


cam_match.launches = 0
