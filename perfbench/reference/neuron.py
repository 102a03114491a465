"""The AdExp integrate-and-fire neuron with four DPI synapse filters
(paper §IV), one exponential-Euler step, in plain PyTorch.

Each DPI filter decays by ``exp(-dt / tau)`` and takes the step's matched
events times its weight. Fast and slow excitation add, subtractive
inhibition subtracts, and shunting inhibition scales the leak. The membrane
follows the AdExp equation with an exponential take-off clipped at 20
slope factors, and a spike (``v >= v_peak`` outside the refractory period)
resets ``v``, bumps the adaptation ``w`` and starts the refractory clock.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class State:
    v: torch.Tensor  # [..., N]
    w: torch.Tensor  # [..., N]
    refrac: torch.Tensor  # [..., N]
    i_syn: torch.Tensor  # [..., N, 4]


def rest(p: dict, shape: tuple[int, ...], dtype, device) -> State:
    kw = {"dtype": dtype, "device": device}
    return State(v=torch.full(shape, p["v_rest"], **kw), w=torch.zeros(shape, **kw),
                 refrac=torch.zeros(shape, **kw), i_syn=torch.zeros((*shape, 4), **kw))


def synapse_constants(p: dict, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    taus = torch.tensor(p["tau_syn"], dtype=dtype, device=device)
    return torch.exp(-p["dt"] / taus), torch.tensor(p["w_syn"], dtype=dtype, device=device)


def step(s: State, drive: torch.Tensor, p: dict, decay: torch.Tensor, ws: torch.Tensor):
    """``(new state, spikes)`` after one step of ``drive [..., N, 4]``."""
    dt = p["dt"]
    i_syn = s.i_syn * decay + drive * ws
    fast, slow, sub, shunt = i_syn.unbind(-1)
    exc = fast + slow
    leak_gain = 1.0 + p["shunt_gain"] * shunt
    i_in = p["input_gain"] * (exc - sub)
    v = s.v
    take_off = p["delta_t"] * torch.exp(
        torch.clamp((v - p["v_thresh"]) / p["delta_t"], -20.0, 20.0))
    dv = (-(v - p["v_rest"]) * leak_gain + take_off - s.w) / p["tau_m"] + i_in
    v_new = v + dt * dv
    dw = (p["a_adapt"] * (v - p["v_rest"]) - s.w) / p["tau_w"]
    w_new = s.w + dt * dw
    refractory = s.refrac > 0.0
    v_new = torch.where(refractory, p["v_reset"], v_new)
    spikes = (v_new >= p["v_peak"]) & ~refractory
    return State(
        v=torch.where(spikes, p["v_reset"], v_new),
        w=torch.where(spikes, w_new + p["b_adapt"], w_new),
        refrac=torch.where(spikes, p["refrac"], torch.clamp(s.refrac - dt, min=0.0)),
        i_syn=i_syn,
    ), spikes.to(v.dtype)
