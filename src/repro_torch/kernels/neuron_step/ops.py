"""Wrapper of the AdExp/DPI neuron-step CUDA kernel (``csrc/neuron_step.cu``).

:func:`neuron_step` advances the leaves of a
:class:`~repro_torch.core.neuron.NeuronState` by one step in one kernel:
one read of the state and the drive, one write of the new state and the
spikes. ``core/neuron.py`` ``neuron_step`` calls it for every state on the
card and keeps its eager code (``neuron_step_eager``) as the plain version,
for the CPU; the kernel equals that eager code on the card bit for bit.
``neuron_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.two_stage import N_SYN_TYPES
from repro_torch.kernels._build import check_status, device_scope, library

__all__ = ["CONSTANTS", "constants", "kernel_info", "neuron_step"]

# The kernel's numbers, in the order of csrc/neuron_step.cu's Constants.
CONSTANTS = ("dt", "v_thresh", "inv_delta_t", "delta_t", "v_rest", "shunt_gain", "input_gain",
             "inv_tau_m", "a_adapt", "inv_tau_w", "v_reset", "v_peak", "b_adapt", "refrac")


@functools.cache
def constants(params) -> ctypes.Array:
    """The numbers of ``params`` (a ``NeuronParams``) as the eager step's
    operations on the card take them: each rounded to float32, and each
    divisor as its reciprocal, taken in float64 and rounded to float32,
    since PyTorch's CUDA division of a tensor by a number multiplies by that
    (``float32(1 / 0.002)`` is 500, ``float32(1) / float32(0.002)`` one ulp
    less). Built once per parameter set; the same library serves every set."""
    f32 = np.float32
    values = {name: f32(getattr(params, name)) for name in CONSTANTS if not name.startswith("inv_")}
    for name in ("delta_t", "tau_m", "tau_w"):
        values[f"inv_{name}"] = f32(1.0 / getattr(params, name))
    return (ctypes.c_float * len(CONSTANTS))(*(float(values[k]) for k in CONSTANTS))


@functools.cache
def _launcher():
    fn = library("neuron_step").neuron_step_launch
    fn.argtypes = [ctypes.c_void_p] * 13 + [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_info() -> dict[str, int]:
    """The compiled kernel on the current card: registers and local (spill)
    bytes per thread, and the blocks that fit on one SM."""
    lib = library("neuron_step")
    fn = lib.neuron_step_kernel_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int() for _ in range(3)]
    check_status(lib, fn(*(ctypes.byref(x) for x in out)), "neuron_step_kernel_info")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), (x.value for x in out)))


def neuron_step(
    v: torch.Tensor,  # [..., N] float32
    w: torch.Tensor,  # [..., N]
    refrac: torch.Tensor,  # [..., N]
    i_syn: torch.Tensor,  # [..., N, 4]
    drive: torch.Tensor,  # [..., N, 4]
    i_ext: torch.Tensor | None,  # [..., N] or None
    decay: torch.Tensor,  # [4] exp(-dt / tau_syn): core/neuron.py's cached float32 tensor
    weight: torch.Tensor,  # [4] w_syn, likewise
    params,  # NeuronParams
) -> tuple[torch.Tensor, ...]:  # v, w, refrac, i_syn, spikes: new tensors
    """One step of every neuron. Takes float32 tensors on one CUDA device,
    ``w``, ``refrac`` and ``i_ext`` (or None) of ``v``'s shape ``[..., N]``,
    ``i_syn`` and ``drive`` of ``[..., N, 4]``, none requiring grad (the
    kernel has no backward), and raises ``ValueError`` for anything else. A
    strided tensor is copied dense first."""
    lead = v.shape
    leaves = (v, w, refrac, i_syn, drive) if i_ext is None else (v, w, refrac, i_syn, drive, i_ext)
    if not (v.is_cuda and v.dim() > 0
            and all(t.dtype == torch.float32 and t.device == v.device and not t.requires_grad
                    for t in leaves)
            and w.shape == lead and refrac.shape == lead
            and (i_ext is None or i_ext.shape == lead)
            and i_syn.shape == (*lead, N_SYN_TYPES) and drive.shape == i_syn.shape):
        raise ValueError(
            "neuron_step kernel takes float32 CUDA tensors v, w, refrac [..., N] and i_syn, "
            f"drive [..., N, 4], none requiring grad; got v {tuple(v.shape)} {v.dtype} on "
            f"{v.device}, i_syn {tuple(i_syn.shape)} {i_syn.dtype}, drive {tuple(drive.shape)} "
            f"{drive.dtype} on {drive.device}")
    dev = v.device
    # a strided slice (a mesh cell's share of the neurons) is copied dense:
    # one pass each, where the eager step makes some forty
    v, w, refrac, i_syn, drive = (t.contiguous() for t in (v, w, refrac, i_syn, drive))
    i_ext = None if i_ext is None else i_ext.contiguous()
    outs = [torch.empty_like(v) for _ in range(3)]
    i_syn_out, spikes = torch.empty_like(i_syn), torch.empty_like(v)
    consts = constants(params)
    with device_scope(dev):
        status = _launcher()(
            v.data_ptr(), w.data_ptr(), refrac.data_ptr(), i_syn.data_ptr(), drive.data_ptr(),
            None if i_ext is None else i_ext.data_ptr(), decay.data_ptr(), weight.data_ptr(),
            *(t.data_ptr() for t in outs), i_syn_out.data_ptr(), spikes.data_ptr(), v.numel(),
            consts, len(consts), torch.cuda.current_stream(dev).cuda_stream,
        )
    check_status(library("neuron_step"), status, "neuron_step")
    neuron_step.launches += 1
    return (*outs, i_syn_out, spikes)


neuron_step.launches = 0
