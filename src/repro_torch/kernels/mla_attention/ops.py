"""Wrapper of the causal MLA prefill attention CUDA kernel (``csrc/mla_attention.cu``).

``mla_attention(q, k, v, positions, scale)`` computes what
``models/attention.py`` ``attention_core(q, k, v, positions, positions,
causal=True, window=None, scale=scale)`` computes for a prefill of
Multi-head Latent Attention: q, k ``[B, S, H, 192]`` and v ``[B, S, H, 128]``
in bf16, a key valid for a query when ``0 <= k_pos <= q_pos``, a row with no
valid key 0, the output ``[B, S, H, 128]`` in bf16. Scores, softmax and the
last division are float32; the probabilities are rounded to bf16 for the
product with v, as ``attend_dense`` rounds them (the kernel's header gives
its design). It has no CPU version of its own: ``models/mla.py`` sends
what the kernel does not take to ``attention_core``, the plain version.
Given anything else than contiguous bf16 CUDA tensors of those shapes and
int64 positions ``[B, S]`` (any strides), none requiring grad, it raises.
``mla_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import check_status, device_scope, library, require

__all__ = ["QK_DIM", "V_DIM", "kernel_info", "mla_attention"]

QK_DIM = 192  # qk_nope_dim + qk_rope_dim of DeepSeek-V2 and V3
V_DIM = 128
BLOCK_ROWS = 128  # query rows a block, keys a tile
MAX_GRID = 65535  # batch elements, and heads, a launch takes


@functools.cache
def _launcher():
    fn = library("mla_attention").mla_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_info() -> dict[str, int]:
    """The compiled kernel on the current card: registers and local (spill)
    bytes per thread, shared bytes per block, and the blocks that fit on one
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = library("mla_attention")
    fn = lib.mla_attention_kernel_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(4)]
    check_status(lib, fn(*(ctypes.byref(x) for x in out)), "mla_attention_kernel_info")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def mla_attention(
    q: torch.Tensor,  # [B, S, H, 192] bf16
    k: torch.Tensor,  # [B, S, H, 192] bf16
    v: torch.Tensor,  # [B, S, H, 128] bf16
    positions: torch.Tensor,  # [B, S] int64, of queries and keys alike
    scale: float,
) -> torch.Tensor:  # [B, S, H, 128] bf16
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"mla_attention runs on CUDA tensors, got {dev}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, {QK_DIM}], got shape {tuple(q.shape)}")
    b, s, h, _ = q.shape
    require(q, "q", torch.bfloat16, dev, (b, s, h, QK_DIM))
    require(k, "k", torch.bfloat16, dev, (b, s, h, QK_DIM))
    require(v, "v", torch.bfloat16, dev, (b, s, h, V_DIM))
    if (positions.device != dev or positions.dtype != torch.int64
            or tuple(positions.shape) != (b, s)):
        raise ValueError(f"positions must be int64 [{b}, {s}] on {dev}, got "
                         f"{positions.dtype} {tuple(positions.shape)} on {positions.device}")
    if not scale > 0:
        raise ValueError(f"mla_attention takes a positive scale, got {scale}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("mla_attention has no backward: its output would carry no gradient")
    if not (0 < b <= MAX_GRID and 0 < h <= MAX_GRID and 0 < s < 2**31 - BLOCK_ROWS):
        raise ValueError(f"mla_attention takes 1..{MAX_GRID} batch elements and heads and "
                         f"under 2**31 positions, got B = {b}, S = {s}, H = {h}")
    out = torch.empty((b, s, h, V_DIM), dtype=torch.bfloat16, device=dev)
    with device_scope(dev):
        status = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
            positions.stride(0), positions.stride(1), out.data_ptr(), b, s, h,
            float(scale) * math.log2(math.e), torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("mla_attention"), status, "mla_attention")
    mla_attention.launches += 1
    return out


mla_attention.launches = 0
