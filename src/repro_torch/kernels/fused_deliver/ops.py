"""Wrapper of the fused-delivery CUDA kernel (``csrc/fused_deliver.cu``).

:func:`fused_deliver` consumes an :class:`~repro_torch.core.two_stage.EventQueue`:
the SRAM gather of the queued events happens here, in PyTorch, and the
kernel receives flat ``dest * K + tag`` entries with their weights. CPU
tensors go to the plain version
(:func:`~repro_torch.kernels.fused_deliver.ref.fused_deliver_ref`); CUDA
tensors launch the kernel or raise. ``fused_deliver.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.core.two_stage import N_SYN_TYPES, EventQueue, gather_event_entries
from repro_torch.kernels._build import check_status, library, require
from repro_torch.kernels.fused_deliver.ref import fused_deliver_ref


@functools.cache
def _launcher():
    fn = library("fused_deliver").fused_deliver_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _event_entries_flat(
    queue: EventQueue, src_tag: torch.Tensor, src_dest: torch.Tensor, k_tags: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Queue -> kernel inputs: flat ``dest*K + tag`` [..., Q*E] (-1 empty) + weights."""
    ev_tag, ev_dest = gather_event_entries(queue, src_tag, src_dest)
    valid = ev_tag >= 0
    ev_flat = torch.where(valid, ev_dest * k_tags + ev_tag, -1)
    ev_w = queue.weight[..., None] * valid.to(queue.weight.dtype)
    batch_shape = queue.src.shape[:-1]
    return ev_flat.reshape(*batch_shape, -1), ev_w.reshape(*batch_shape, -1)


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
    b = math.prod(batch_shape)
    if not 0 < b < 65536:
        raise ValueError(f"fused_deliver takes a batch of 1..65535 rows, got {b}")
    ev_flat, ev_w = _event_entries_flat(queue, src_tag, src_dest, k_tags)
    qe = ev_flat.shape[-1]
    require(ev_flat, "ev_flat", torch.int32, dev)
    require(ev_w, "ev_w", torch.float32, dev, tuple(ev_flat.shape))
    require(cam_tag, "cam_tag", torch.int32, dev, (n, s))
    require(cam_syn, "cam_syn", torch.int32, dev, (n, s))
    ext_ptr = None
    if external_activity is not None:
        require(external_activity, "external_activity", torch.float32, dev,
                (*batch_shape, n_clusters, k_tags))
        ext_ptr = external_activity.data_ptr()
    out = torch.empty((*batch_shape, n, N_SYN_TYPES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _launcher()(
            ev_flat.data_ptr(), ev_w.data_ptr(), ext_ptr, cam_tag.data_ptr(),
            cam_syn.data_ptr(), out.data_ptr(), b, n_clusters, cluster_size, k_tags,
            s, qe, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("fused_deliver"), status, "fused_deliver")
    fused_deliver.launches += 1
    return out


fused_deliver.launches = 0
