"""AdamW with float32, bfloat16 or blockwise-int8 moments, on dicts of tensors.

The port of ``repro.train.optimizer``, as plain functions:

* moment dtype: float32 (default), bfloat16, or blockwise int8 (``"q8"``):
  m and v stored as int8 codes with one float32 scale per block of 256
  elements of the last axis (the 8-bit-Adam trick), leading axes kept;
* global-norm clipping, linear warmup then cosine decay, and decoupled
  weight decay on the leaves ``repro`` decays: rank >= 2 in ``repro``'s own
  tree, where each scanned period's leaves carry a leading ``[n_periods]``
  axis (``decay`` says so leaf by leaf; see ``convert.repro_ndim``).

Parameters, gradients and moments are dicts keyed by parameter name; a q8
moment is a dict ``{"q": int8 [..., blocks, 256], "scale": float32 [...,
blocks, 1]}``. Every scalar (step, learning rate, norm, bias corrections)
stays a 0-dim tensor on the parameters' device, so an update never waits
for the device. Rounding follows ``jnp.round`` (half to even), as
``torch.round`` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = [
    "OptConfig", "Q_BLOCK", "adamw_update", "global_norm", "init_opt_state", "schedule",
]

Q_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # "float32" | "bfloat16" | "q8"


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (float32): linear warmup to ``lr``, then
    cosine decay to ``lr * min_lr_ratio`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# blockwise int8 moment codec
# ---------------------------------------------------------------------------
def _q8_block(shape) -> int:
    last = shape[-1] if len(shape) else 1
    return min(Q_BLOCK, last) if last else 1


def _q8_encode(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Blockwise int8 over the LAST axis only: the leading axes are kept, so a
    moment's blocks line up with its parameter's rows."""
    x = x.to(torch.float32)
    block = _q8_block(x.shape)
    last = x.shape[-1] if x.dim() else 1
    pad = (-last) % block
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, block)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _q8_decode(enc: dict[str, torch.Tensor], shape, dtype=torch.float32) -> torch.Tensor:
    x = enc["q"].to(torch.float32) * enc["scale"]
    x = x.reshape(*x.shape[:-2], -1)  # merge (blocks, block)
    last = shape[-1] if len(shape) else 1
    return x[..., :last].reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# state init / update
# ---------------------------------------------------------------------------
def _zeros_like_state(p: torch.Tensor, cfg: OptConfig):
    if cfg.state_dtype == "q8":
        block = _q8_block(p.shape)
        last = p.shape[-1] if p.dim() else 1
        nblocks = max(1, (last + block - 1) // block)
        lead = tuple(p.shape[:-1])
        return {
            "q": torch.zeros((*lead, nblocks, block), dtype=torch.int8, device=p.device),
            "scale": torch.zeros((*lead, nblocks, 1), dtype=torch.float32, device=p.device),
        }
    dtype = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def init_opt_state(params: dict[str, torch.Tensor], cfg: OptConfig) -> dict:
    """Zero moments for every parameter and an int32 step of 0."""
    device = next(iter(params.values())).device
    return {
        "m": {n: _zeros_like_state(p, cfg) for n, p in params.items()},
        "v": {n: _zeros_like_state(p, cfg) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(torch.stack([x.to(torch.float32).square().sum() for x in leaves]).sum())


def adamw_update(grads: dict[str, torch.Tensor], opt_state: dict,
                 params: dict[str, torch.Tensor], cfg: OptConfig,
                 decay: dict[str, bool] | None = None) -> tuple[dict, dict, dict]:
    """One AdamW step: ``(new_params, new_opt_state, {"grad_norm", "lr"})``.

    The gradients are clipped to a global norm of ``clip_norm``; ``decay``
    names the leaves that take weight decay (default: ``p.dim() >= 2``, as
    ``repro`` judges its own leaves). New tensors are returned; the inputs
    are left as they are."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    step_f = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1**step_f
    bc2 = 1.0 - cfg.b2**step_f
    is_q8 = cfg.state_dtype == "q8"

    new_p, new_m, new_v = {}, {}, {}
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m_f = _q8_decode(m, p.shape) if is_q8 else m.to(torch.float32)
        v_f = _q8_decode(v, p.shape) if is_q8 else v.to(torch.float32)
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        if (decay[name] if decay is not None else p.dim() >= 2):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p[name] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_m[name] = _q8_encode(m_f) if is_q8 else m_f.to(m.dtype)
        new_v[name] = _q8_encode(v_f) if is_q8 else v_f.to(v.dtype)
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}
