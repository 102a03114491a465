"""Mixture-of-Experts with the DYNAPs two-stage tag dispatch (DESIGN.md §3).

The port of ``repro.models.moe``. The paper's routing scheme applied to
experts: a token with a routing decision is a spiking neuron, the expert id
it emits is its tag, and each expert's fixed-capacity buffer is an AER queue
with FIFO overflow: ``core.two_stage.dispatch_slots`` assigns the slots, the
first ``cap`` assignments of an expert in token order are kept and the rest
dropped.

  * :func:`moe_reference`: every expert computed densely for every token
    (the oracle, small sizes only);
  * :func:`moe_local`: the two-stage dispatch on one device.

Routers: softmax top-k (deepseek-moe-16b) and sigmoid + bias aux-free
(deepseek-v3). The router and its bias are float32 whatever the parameter
dtype. Ties in the top-k go to the lower expert id, as ``jax.lax.top_k``
breaks them.

:func:`aux_loss` is ``repro``'s switch-style balancing loss (``Model.loss``
computes its own load term inline, as ``repro``'s does).
``repro``'s expert-parallel ``moe_sharded`` / ``moe_block_sharded`` are not
ported yet (ROADMAP queue 1, 'LM remainder').
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.two_stage import dispatch_slots
from repro_torch.models.layers import matmul, normal_param, sigmoid, silu

__all__ = [
    "MoE", "aux_loss", "expert_capacity", "experts_ffn", "moe_local", "moe_reference", "route",
]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """The parameters of ``repro.models.moe.init_moe``, under its names."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        s_in, s_out = d**-0.5, f**-0.5
        self.router = normal_param((d, e), torch.float32, s_in, gen, device)
        self.router_bias = nn.Parameter(torch.zeros(e, dtype=torch.float32, device=device))
        self.wi_gate = normal_param((e, d, f), dtype, s_in, gen, device)
        self.wi_up = normal_param((e, d, f), dtype, s_in, gen, device)
        self.wo = normal_param((e, f, d), dtype, s_out, gen, device)


# ---------------------------------------------------------------------------
# routing decisions (which tag does each token emit?)
# ---------------------------------------------------------------------------
def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves ties open)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(params: MoE, x: torch.Tensor, cfg):
    """x: [T, D] -> (top_idx [T, k] int64, top_w [T, k] float32, load [E] float32).

    Aux-free: experts chosen by sigmoid(score) + bias, weights the unbiased
    sigmoid scores renormalised over the chosen experts."""
    scores = matmul(x.float(), params.router)
    if cfg.router_aux_free:
        affinity = sigmoid(scores)
        _, top_idx = _top_k(affinity + params.router_bias[None, :], cfg.top_k)
        top_w = torch.gather(affinity, 1, top_idx)
    else:
        probs = torch.softmax(scores, dim=-1)
        top_w, top_idx = _top_k(probs, cfg.top_k)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return top_idx, top_w, _counts(top_idx, cfg.n_experts)


def _counts(top_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert, float32 [E]."""
    flat = top_idx.reshape(-1)
    # index_add_ of ones, not bincount: bincount waits for the device to size its output
    return torch.zeros(n_experts, dtype=torch.float32, device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))


def aux_loss(params: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing loss: ``E * sum(frac * importance)``, with
    ``frac`` the share of the softmax top-k assignments each expert gets and
    ``importance`` its mean router probability. x: [T, D]."""
    probs = torch.softmax(matmul(x.float(), params.router), dim=-1)
    _, top_idx = _top_k(probs, cfg.top_k)
    frac = _counts(top_idx, cfg.n_experts) / (x.shape[0] * cfg.top_k)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))


# ---------------------------------------------------------------------------
# expert compute
# ---------------------------------------------------------------------------
def experts_ffn(params: MoE, buf: torch.Tensor) -> torch.Tensor:
    """buf: [E, cap, D] -> the same shape through each expert's gated FFN
    (``einsum("ecd,edf->ecf")`` as batched products)."""
    gate = matmul(buf, params.wi_gate)
    up = matmul(buf, params.wi_up)
    return matmul(silu(gate) * up, params.wo)


# ---------------------------------------------------------------------------
# two-stage dispatch on one device
# ---------------------------------------------------------------------------
def expert_capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``max(8, int(t * k / E * capacity_factor))``."""
    return max(8, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def moe_local(params: MoE, x: torch.Tensor, cfg, capacity: int | None = None):
    """Two-stage dispatch on one device. x: [T, D] -> ([T, D], {"load": [E]}).

    Every expert runs its whole buffer of ``cap`` slots, empty slots
    included, as ``repro`` does. A dropped assignment adds nothing to its
    token; the token's ``k`` weighted expert outputs are summed in ``x``'s
    dtype in order of their rank."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity or expert_capacity(cfg, t)
    top_idx, top_w, load = route(params, x, cfg)

    flat_e = top_idx.reshape(-1)  # [T*k]: the emitted tag stream
    slot, keep = dispatch_slots(flat_e, e, cap)
    token_of = torch.arange(t, device=x.device).repeat_interleave(k)
    # dropped assignments go to a sentinel row past the buffers (repro's
    # scatter to e * cap with mode="drop"); kept slots are distinct
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, torch.where(keep, slot, e * cap).long(), x[token_of])
    out_buf = experts_ffn(params, buf[:-1].reshape(e, cap, d)).reshape(e * cap, d)
    gathered = out_buf[slot.clamp_min(0).long()] * keep[:, None].to(x.dtype)
    terms = (gathered * top_w.reshape(-1)[:, None].to(x.dtype)).reshape(t, k, d)
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y, {"load": load}


def moe_reference(params: MoE, x: torch.Tensor, cfg):
    """Oracle: every expert computed densely for every token (small sizes only)."""
    t, d = x.shape
    top_idx, top_w, load = route(params, x, cfg)
    combine = torch.zeros((t, cfg.n_experts), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, top_idx, top_w)
    all_out = experts_ffn(params, x[None].expand(cfg.n_experts, t, d))
    y = torch.einsum("te,etd->td", combine, all_out.float()).to(x.dtype)
    return y, {"load": load}
