"""AdExp-I&F neuron + 4-type DPI synapse dynamics (paper §IV), PyTorch.

Counterpart of ``repro.core.neuron``: four DPI log-domain filters (fast-exc,
slow-exc, subtractive-inh, shunting-inh) feeding one Adaptive-Exponential
Integrate & Fire neuron, advanced by exponential-Euler steps. Purely
elementwise over the leading batch dims.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.two_stage import N_SYN_TYPES
from repro_torch.kernels.neuron_step import ops as neuron_kernel

__all__ = ["NeuronParams", "NeuronState", "init_state", "neuron_step", "neuron_step_eager"]


@dataclasses.dataclass(frozen=True)
class NeuronParams:
    dt: float = 1e-3  # simulation step [s]
    # AdExp membrane
    tau_m: float = 20e-3
    v_rest: float = -70e-3
    v_thresh: float = -50e-3  # exponential take-off V_T
    delta_t: float = 2e-3  # sharpness
    v_peak: float = 0.0  # spike detection
    v_reset: float = -65e-3
    refrac: float = 2e-3  # refractory period [s]
    # adaptation (negative-feedback block)
    tau_w: float = 100e-3
    a_adapt: float = 2.0  # subthreshold coupling [1/s scale]
    b_adapt: float = 8e-3  # spike-triggered increment [V equivalent]
    # DPI synapses: time constants + weights per type
    tau_syn: tuple[float, float, float, float] = (5e-3, 100e-3, 10e-3, 20e-3)
    w_syn: tuple[float, float, float, float] = (1.0, 0.3, 1.0, 1.0)
    shunt_gain: float = 5.0  # shunting inhibition multiplies leak conductance
    input_gain: float = 0.12  # synaptic current -> membrane drive [V/s per unit]


@dataclasses.dataclass
class NeuronState:
    v: torch.Tensor  # [..., N] membrane potential
    w: torch.Tensor  # [..., N] adaptation variable
    refrac: torch.Tensor  # [..., N] remaining refractory time
    i_syn: torch.Tensor  # [..., N, 4] DPI filter states


def init_state(
    n: int,
    params: NeuronParams,
    dtype: torch.dtype = torch.float32,
    batch: int | tuple[int, ...] | None = None,
    device: torch.device | str = "cuda",
) -> NeuronState:
    """Fresh state for ``n`` neurons on ``device`` (the card unless the caller
    asks for the CPU); ``batch`` prepends leading batch dims."""
    lead = () if batch is None else (batch,) if isinstance(batch, int) else tuple(batch)
    kw = {"dtype": dtype, "device": resolve_device(device)}
    return NeuronState(
        v=torch.full((*lead, n), params.v_rest, **kw),
        w=torch.zeros((*lead, n), **kw),
        refrac=torch.zeros((*lead, n), **kw),
        i_syn=torch.zeros((*lead, n, N_SYN_TYPES), **kw),
    )


@functools.lru_cache(maxsize=None)
def _synapse_constants(params: NeuronParams, dtype: torch.dtype, device: torch.device):
    """Per-synapse-type DPI decay ``exp(-dt / tau_syn)`` and weight
    ``w_syn`` on ``device``, built once per (params, dtype, device): a tensor
    made from host numbers is a copy the host waits on, which a step must
    not make. Its ``[4]`` shape is checked here, once, for every step that
    reads the two."""
    if len(params.tau_syn) != N_SYN_TYPES or len(params.w_syn) != N_SYN_TYPES:
        raise ValueError(f"tau_syn and w_syn need {N_SYN_TYPES} numbers each, one per synapse "
                         f"type; got {params.tau_syn} and {params.w_syn}")
    taus = torch.tensor(params.tau_syn, dtype=dtype, device=device)
    ws = torch.tensor(params.w_syn, dtype=dtype, device=device)
    return torch.exp(-params.dt / taus), ws


def neuron_step(
    state: NeuronState,
    drive: torch.Tensor,  # [..., N, 4] matched-event weight per synapse type
    params: NeuronParams,
    i_ext: torch.Tensor | None = None,  # [..., N] external (DC) input current
) -> tuple[NeuronState, torch.Tensor]:
    """One exponential-Euler step; returns ``(new_state, spikes [..., N])``.

    Builds new tensors and leaves ``state`` untouched. A state on the card
    takes one CUDA kernel (``kernels/neuron_step``), equal to
    :func:`neuron_step_eager` bit for bit: float32 only, and a ``ValueError``
    for anything else. ``drive`` and ``i_ext`` may broadcast to the state's
    shapes. Elsewhere the step is :func:`neuron_step_eager`.
    """
    if not state.v.is_cuda:
        return neuron_step_eager(state, drive, params, i_ext)
    if drive.shape != state.i_syn.shape:
        drive = drive.expand_as(state.i_syn)
    if i_ext is not None and i_ext.shape != state.v.shape:
        i_ext = i_ext.expand_as(state.v)
    decay, ws = _synapse_constants(params, state.i_syn.dtype, state.i_syn.device)
    *leaves, spikes = neuron_kernel.neuron_step(
        state.v, state.w, state.refrac, state.i_syn, drive, i_ext, decay, ws, params)
    return NeuronState(*leaves), spikes


def neuron_step_eager(
    state: NeuronState,
    drive: torch.Tensor,
    params: NeuronParams,
    i_ext: torch.Tensor | None = None,
) -> tuple[NeuronState, torch.Tensor]:
    """:func:`neuron_step` in elementwise PyTorch operations, on any device
    and dtype: the plain version of the CUDA kernel."""
    p = params
    dt = p.dt
    decay, ws = _synapse_constants(p, state.i_syn.dtype, state.i_syn.device)

    # DPI filters: exponential decay + weighted pulse injection (PE -> DPI).
    i_syn = state.i_syn * decay + drive * ws

    i_fast, i_slow, i_sub, i_shunt = (i_syn[..., k] for k in range(N_SYN_TYPES))
    exc = i_fast + i_slow
    leak_gain = 1.0 + p.shunt_gain * i_shunt  # shunting = divisive inhibition
    i_in = p.input_gain * (exc - i_sub)
    if i_ext is not None:
        i_in = i_in + i_ext

    # AdExp membrane (clip the exponential for numerical safety).
    v = state.v
    exp_term = p.delta_t * torch.exp(torch.clamp((v - p.v_thresh) / p.delta_t, -20.0, 20.0))
    dv = (-(v - p.v_rest) * leak_gain + exp_term - state.w) / p.tau_m + i_in
    v_new = v + dt * dv
    # adaptation
    dw = (p.a_adapt * (v - p.v_rest) - state.w) / p.tau_w
    w_new = state.w + dt * dw

    in_refrac = state.refrac > 0.0
    v_new = torch.where(in_refrac, p.v_reset, v_new)
    spikes = (v_new >= p.v_peak) & ~in_refrac

    v_out = torch.where(spikes, p.v_reset, v_new)
    w_out = torch.where(spikes, w_new + p.b_adapt, w_new)
    refrac_out = torch.where(spikes, p.refrac, torch.clamp(state.refrac - dt, min=0.0))

    new_state = NeuronState(v=v_out, w=w_out, refrac=refrac_out, i_syn=i_syn)
    return new_state, spikes.to(v_new.dtype)
