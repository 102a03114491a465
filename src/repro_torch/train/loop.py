"""Train step: loss, gradients, clipping, AdamW and the MoE router-bias update.

The port of ``repro.train.loop``. ``make_train_step(model, opt_cfg,
microbatches)`` returns ``train_step(state, batch) -> (state, metrics)``:

* the gradients of ``Model.loss`` with respect to every parameter of
  ``state["params"]`` (the model's forward runs on those tensors; a
  parameter applied at several depths, as zamba2's shared block is, sums
  its gradient over them, as ``jax.grad`` does; a parameter the loss does
  not reach gets zeros);
* microbatches: the batch is split on dim 0, gradients and loss are
  accumulated in float32 from zero, the aux entries summed, and gradients
  and loss divided by ``microbatches`` at the end;
* AdamW (``train.optimizer``), with weight decay on the leaves ``repro``
  decays (rank >= 2 in its own tree, periods stacked: ``convert.repro_ndim``);
* deepseek-v3's aux-free load balancing: after AdamW and outside the
  gradient, every period's ``router_bias`` moves by ``u * sign(mean - load)``
  of that period's expert loads (``aux["moe_load_periods"]`` row ``p`` for
  the layer of period ``p``).

A train state is ``{"params": {name: tensor}, "opt": {"m", "v", "step"}}``.
The step returns new tensors and leaves its inputs as they are.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.convert import repro_ndim, repro_path
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state

__all__ = [
    "TrainState", "bound_parameters", "decay_mask", "init_train_state", "loss_and_grads",
    "make_train_step",
]

TrainState = dict  # {"params": {name: tensor}, "opt": {"m", "v", "step"}}


def init_train_state(model, opt_cfg: OptConfig) -> TrainState:
    """The model's current parameters (shared, not copied; a step never
    writes them) and zero moments. ``repro`` draws its parameters here from
    a key; the port's model was drawn from its seed at build time."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def decay_mask(model) -> dict[str, bool]:
    """Which parameters take weight decay: those of rank >= 2 in ``repro``'s
    tree, where a scanned period's leaves have one more axis than the
    port's per-layer tensors."""
    return {n: repro_ndim(model.cfg, n, p.dim()) >= 2 for n, p in model.named_parameters()}


@contextlib.contextmanager
def bound_parameters(model, params: dict[str, torch.Tensor]):
    """Run ``model`` on ``params`` (by name) in place of its own parameters,
    for the forward and the backward both (a checkpointed period recomputes
    its forward inside the backward)."""
    saved = []
    try:
        for name, t in params.items():
            owner, _, attr = name.rpartition(".")
            module = model.get_submodule(owner)
            saved.append((module, attr, module._parameters[attr]))
            module._parameters[attr] = t
        yield model
    finally:
        for module, attr, p in reversed(saved):
            module._parameters[attr] = p


def _grads(model, params: dict[str, torch.Tensor], batch: dict):
    """(loss, aux, grads) of one batch; grads in each parameter's dtype."""
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    with torch.enable_grad(), bound_parameters(model, leaves):
        loss, aux = model.loss(batch)
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), got)}
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def loss_and_grads(model, params: dict[str, torch.Tensor], batch: dict, microbatches: int = 1):
    """(loss, aux, grads) of ``Model.loss`` at ``params``. With
    ``microbatches > 1`` the batch is split on dim 0; gradients (float32) and
    loss are accumulated from zero and divided by ``microbatches``, the aux
    entries summed."""
    if microbatches == 1:
        return _grads(model, params, batch)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    micro = {k: v.reshape(microbatches, v.shape[0] // microbatches, *v.shape[1:])
             for k, v in batch.items()}
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    l_acc = torch.zeros((), device=model.device)
    aux_acc: dict = {}
    for i in range(microbatches):
        loss, aux, grads = _grads(model, params, {k: v[i] for k, v in micro.items()})
        for n, g in grads.items():
            g_acc[n].add_(g)
        l_acc = l_acc + loss
        aux_acc = {k: aux_acc.get(k, 0.0) + v for k, v in aux.items()}
    return (l_acc / microbatches, aux_acc,
            {n: g / microbatches for n, g in g_acc.items()})


def _update_router_bias(cfg, params: dict[str, torch.Tensor], aux: dict,
                        u: float = 1e-3) -> dict[str, torch.Tensor]:
    """deepseek-v3 bias-based load balancing: ``b_e += u * sign(mean - load_e)``
    per period, from ``aux["moe_load_periods"]`` [n_periods, E], on each
    scanned period's ``router_bias`` (``repro`` updates only those: the
    leaves with a leading period axis)."""
    if "moe_load_periods" not in aux:
        return params
    load = aux["moe_load_periods"]
    delta = u * torch.sign(load.mean(-1, keepdim=True) - load)
    out = dict(params)
    for name, p in params.items():
        path, period = repro_path(cfg, name)
        if path[-1] == "router_bias" and period is not None:
            out[name] = p + delta[period].to(p.dtype)
    return out


def make_train_step(model, opt_cfg: OptConfig, microbatches: int = 1):
    """``train_step(state, batch) -> (new state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` as 0-dim tensors on the device."""
    decay = decay_mask(model)

    def train_step(state: TrainState, batch: dict):
        params = state["params"]
        loss, aux, grads = loss_and_grads(model, params, batch, microbatches)
        new_params, new_opt, metrics = adamw_update(grads, state["opt"], params, opt_cfg, decay)
        del grads
        new_params = _update_router_bias(model.cfg, new_params, aux)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
