"""Wrapper of the RWKV-6 chunk CUDA kernel (``csrc/rwkv6_chunk.cu``).

``rwkv6_chunk(r, k, v, log_w, u, s0)`` takes the signature of
``repro.kernels.rwkv6.ops.rwkv6_chunk``: r/k/v/log_w ``[B, T, H, P]``,
u ``[H, P]``, s0 ``[B, H, P, P]``, all float32, and returns
``(y [B, T, H, P], s1 [B, H, P, P])``. CPU tensors go to the plain version
(:func:`~repro_torch.kernels.rwkv6.ref.rwkv6_chunk_ref`); CUDA tensors launch
the kernel or raise; meta tensors (the dry run) give empty outputs of the
right shapes. Under a ``launch.costs.CostCounter`` a call counts as
:func:`chunk_cost` reckons it, whichever of the three runs. The kernel has no backward: with gradients on, CUDA
inputs that require them raise ``RuntimeError`` rather than come back cut
from the graph. The four ``[B, T, H, P]`` inputs are read in place: each
needs its ``[T, H, P]`` part packed, and may have any batch stride (a chunk
sliced out of a longer sequence). ``rwkv6_chunk.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import cost_hook
from repro_torch.kernels._build import check_status, library, require
from repro_torch.kernels.rwkv6.ref import rwkv6_chunk_ref

__all__ = [
    "MAX_CHUNK", "MAX_HEAD_DIM", "chunk_cost", "kernel_info", "rwkv6_chunk", "rwkv6_chunk_ref",
    "shared_bytes",
]

MAX_CHUNK = 64  # T: the kernel's a-matrix and its tiles are sized for at most 64
MAX_HEAD_DIM = 64  # P


def chunk_cost(b: int, t: int, h: int, p: int) -> tuple[dict, int]:
    """The work of one chunk call, reckoned from its shapes, as
    ``launch.costs.CostCounter`` counts it whichever version runs: its
    float32 products as dense matmuls per (batch, head), the a-matrix
    ``r (decay) k^T`` and ``a v`` over the whole ``T x T`` (the kernel skips
    the upper triangle) and ``r' s0`` and ``k'^T v``, ``4 T P (T + P)``
    FLOPs; and its bytes, each input read once and each output written
    once (four ``[B, T, H, P]`` inputs, ``u``, ``s0``, ``y`` and ``s1``)."""
    flops = 4 * b * h * t * p * (t + p)
    n_bytes = 4 * (5 * b * t * h * p + h * p + 2 * b * h * p * p)
    return {torch.float32: flops}, n_bytes


@functools.cache
def _launcher():
    fn = library("rwkv6_chunk").rwkv6_chunk_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def shared_bytes(t: int, p: int) -> int:
    """Bytes of shared memory one block of the kernel takes at chunk length
    ``t`` and head size ``p`` (the library's own count)."""
    fn = library("rwkv6_chunk").rwkv6_chunk_shared_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return int(fn(t, p))


def kernel_info() -> dict[str, int]:
    """The compiled kernel on the current card: registers and local (spill)
    bytes per thread, shared bytes per block, and the blocks that fit on one
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = library("rwkv6_chunk").rwkv6_chunk_kernel_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check_status(library("rwkv6_chunk"), fn(ctypes.byref(regs), ctypes.byref(local),
                                            ctypes.byref(blocks)), "rwkv6_chunk_kernel_info")
    return {"registers": regs.value, "local_bytes": local.value,
            "shared_bytes": shared_bytes(MAX_CHUNK, MAX_HEAD_DIM), "blocks_per_sm": blocks.value}


@functools.cache
def _shared_memory_limit(device_index: int) -> int:
    """Bytes of shared memory one block may opt in to on this card."""
    fn = library("rwkv6_chunk").rwkv6_chunk_max_shared_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    limit = fn(device_index)
    if limit <= 0:
        raise RuntimeError(f"rwkv6_chunk: cannot read the shared-memory limit ({limit})")
    return limit


def _require_tile(x: torch.Tensor, name: str, device, shape: tuple[int, ...]) -> None:
    """A ``[B, T, H, P]`` float32 input whose ``[T, H, P]`` part is packed."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {x.dtype}, the kernel takes torch.float32")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    _, t, h, p = shape
    for size, stride, packed in zip(x.shape[1:], x.stride()[1:], (h * p, p, 1)):
        if size > 1 and stride != packed:
            raise ValueError(
                f"{name} has strides {x.stride()}; the kernel reads [T, H, P] packed "
                f"(strides {(h * p, p, 1)} after the batch stride)"
            )


def rwkv6_chunk(
    r: torch.Tensor,  # [B, T, H, P] float32
    k: torch.Tensor,  # [B, T, H, P]
    v: torch.Tensor,  # [B, T, H, P]
    log_w: torch.Tensor,  # [B, T, H, P], < 0
    u: torch.Tensor,  # [H, P]
    s0: torch.Tensor,  # [B, H, P, P]
) -> tuple[torch.Tensor, torch.Tensor]:  # (y [B, T, H, P], s1 [B, H, P, P])
    with cost_hook.reckoned("rwkv6_chunk", *chunk_cost(*r.shape)):
        return _rwkv6_chunk(r, k, v, log_w, u, s0)


def _rwkv6_chunk(r, k, v, log_w, u, s0):
    dev = r.device
    if dev.type == "cpu":
        return rwkv6_chunk_ref(r, k, v, log_w, u, s0)
    if dev.type == "meta":  # shapes only, for the dry run
        return torch.empty_like(r), torch.empty_like(s0)
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_chunk runs on CPU, CUDA or meta tensors, got {dev}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, log_w, u, s0)):
        raise RuntimeError(
            "rwkv6_chunk has no backward (repro's Pallas kernel has none either): its outputs "
            "would carry no gradient; build the model with rwkv_kernel=False to train"
        )
    b, t, h, p = r.shape
    if not (0 < t <= MAX_CHUNK and 0 < p <= MAX_HEAD_DIM):
        raise ValueError(
            f"rwkv6_chunk takes a chunk of 1..{MAX_CHUNK} tokens and heads of "
            f"1..{MAX_HEAD_DIM}, got T = {t}, P = {p}; the kernel has no fallback"
        )
    if not 0 < b < 65536:
        raise ValueError(f"rwkv6_chunk takes a batch of 1..65535, got {b}")
    for name, x in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        _require_tile(x, name, dev, (b, t, h, p))
    require(u, "u", torch.float32, dev, (h, p))
    require(s0, "s0", torch.float32, dev, (b, h, p, p))
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    need, limit = shared_bytes(t, p), _shared_memory_limit(index)
    if need > limit:
        raise ValueError(
            f"rwkv6_chunk: tiles of T = {t}, P = {p} take {need} bytes of shared "
            f"memory, over the {limit} a block can hold on this card"
        )
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=dev)
    s1 = torch.empty((b, h, p, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _launcher()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s1.data_ptr(),
            r.stride(0), k.stride(0), v.stride(0), log_w.stride(0),
            b, t, h, p, torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("rwkv6_chunk"), status, "rwkv6_chunk")
    rwkv6_chunk.launches += 1
    return y, s1


rwkv6_chunk.launches = 0
