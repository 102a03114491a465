"""RWKV6 "Finch" — data-dependent decay linear attention (arXiv:2404.05892).

The port of ``repro.models.rwkv``. Per head (vectors r, k in R^P, v in R^P,
decay w_t in (0,1)^P, bonus u):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T                 S: [P, P]
    y_t = (r_t)^T (S_{t-1} + diag(u) k_t v_t^T)

Token-shift mixing is data-dependent through a low-rank "ddlerp":
mix_x = x + (x_prev - x) * (mu + lora(x + (x_prev - x) * mu0)).

Prefill runs the chunked form, one ``rwkv6_chunk`` per chunk of
``cfg.ssm_chunk`` tokens: on CUDA tensors the hand-written kernel
(``kernels/rwkv6``) when ``use_kernel``, else its plain version. A single
token (decode) and ``sequential=True`` run :func:`rwkv6_sequential_core`, the
oracle. The dtypes follow ``repro``'s promotion step by step: the mixing in
float32, the projections in the parameter dtype, the WKV cores in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import cost_hook
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6.ref import rwkv6_chunk_ref
from repro_torch.models.layers import RMSNorm, matmul, normal_param, rmsnorm, silu

__all__ = [
    "RWKV6", "init_state", "rwkv6_chunked_core", "rwkv6_layer", "rwkv6_sequential_core",
    "rwkv6_spec",
]


def rwkv6_spec(cfg) -> dict:
    return {
        "mu": (None, "embed"),
        "mu0": ("embed",),
        "mix_a": ("embed", None),
        "mix_b": (None, None, "embed"),
        "wr": ("embed", "heads_flat"),
        "wk": ("embed", "heads_flat"),
        "wv": ("embed", "heads_flat"),
        "wg": ("embed", "heads_flat"),
        "wo": ("heads_flat", "embed"),
        "w_base": ("heads_flat",),
        "w_a": ("embed", None),
        "w_b": (None, "heads_flat"),
        "u_bonus": ("heads", None),
        "ln_out": {"scale": ("embed",)},
    }


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class RWKV6(nn.Module):
    """The parameters of ``repro.models.rwkv.init_rwkv6``, under its names."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        h = cfg.n_heads
        p = d // h
        s = d**-0.5
        f32 = torch.float32
        self.cfg = cfg
        # token-shift data-dependent mixing (5 channels: r, k, v, w, g)
        self.mu = normal_param((5, d), f32, 0.1, gen, device)
        self.mu0 = normal_param((d,), f32, 0.1, gen, device)
        self.mix_a = normal_param((d, 5 * cfg.rwkv_lora_mix), dtype, s, gen, device)
        self.mix_b = normal_param((5, cfg.rwkv_lora_mix, d), dtype, cfg.rwkv_lora_mix**-0.5,
                                  gen, device)
        # projections
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, normal_param((d, d), dtype, s, gen, device))
        # data-dependent decay lora
        self.w_base = nn.Parameter(torch.full((d,), -6.0, dtype=f32, device=device))
        self.w_a = normal_param((d, cfg.rwkv_lora_w), dtype, s, gen, device)
        self.w_b = normal_param((cfg.rwkv_lora_w, d), dtype, cfg.rwkv_lora_w**-0.5, gen, device)
        self.u_bonus = normal_param((h, p), f32, 0.1, gen, device)
        self.ln_out = RMSNorm(d, cfg.norm_eps, device)

    def forward(self, x, state=None, sequential: bool = False, use_kernel: bool = False):
        return rwkv6_layer(self, x, self.cfg, state, sequential, use_kernel)


def init_state(batch: int, cfg, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    return {
        "x_prev": torch.zeros((batch, d), dtype=dtype, device=device),  # token-shift memory
        "wkv": torch.zeros((batch, h, p, p), dtype=dtype, device=device),  # per-head state
    }


# ---------------------------------------------------------------------------
# projections with data-dependent token shift
# ---------------------------------------------------------------------------
def _ddlerp(params: RWKV6, x, x_shift):
    """Finch data-dependent mixing -> (r_in, k_in, v_in, w_in, g_in)."""
    dx = x_shift - x  # [B,S,D]
    base = x + dx * params.mu0
    # float32 base times the parameter-dtype mix_a: a float32 product
    lora = torch.tanh(matmul(base, params.mix_a))
    lora = lora.reshape(*lora.shape[:2], 5, -1)
    mixes = params.mu + torch.einsum(
        "bscr,crd->bscd", lora.to(params.mix_b.dtype), params.mix_b
    ).float()
    out = x[:, :, None, :] + dx[:, :, None, :] * mixes  # [B,S,5,D]
    return out.unbind(2)


def _project(params: RWKV6, x, x_shift, cfg):
    h = cfg.n_heads
    p = cfg.d_model // h
    xr, xk, xv, xw, xg = _ddlerp(params, x.float(), x_shift.float())
    cd = params.wr.dtype
    r = matmul(xr.to(cd), params.wr)
    k = matmul(xk.to(cd), params.wk)
    v = matmul(xv.to(cd), params.wv)
    g = silu(matmul(xg.to(cd), params.wg))
    # decay: w in (0,1): exp(-exp(base + lora))
    wl = matmul(torch.tanh(xw.to(cd)), params.w_a)
    logw = params.w_base + matmul(wl, params.w_b).float()
    log_decay = -torch.exp(torch.clamp(logw, -20.0, 1.0))  # log w_t  (< 0)
    shp = (*x.shape[:2], h, p)
    return (
        r.reshape(shp).float(),
        k.reshape(shp).float(),
        v.reshape(shp).float(),
        log_decay.reshape(shp),
        g,
    )


# ---------------------------------------------------------------------------
# cores
# ---------------------------------------------------------------------------
def rwkv6_sequential_core(r, k, v, log_w, u, s0=None):
    """r/k/v/log_w: [B,S,H,P]; u: [H,P]. Returns (y [B,S,H,P], s_f [B,H,P,P])."""
    b, s, h, p = r.shape
    state = torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device) if s0 is None else s0
    ys = []
    for t in range(s):
        # k v^T as a product over one term, as repro's einsum takes it (same values)
        kv = torch.matmul(k[:, t, :, :, None], v[:, t, :, None, :])  # [B,H,P,P]
        ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t], state + u[None, :, :, None] * kv))
        state = state * torch.exp(log_w[:, t])[..., None] + kv
    return torch.stack(ys, 1), state


def rwkv6_chunked_core(r, k, v, log_w, u, chunk: int, s0=None, use_kernel: bool = False):
    """The sequence in chunks of ``chunk`` tokens, the last one padded with
    r = k = v = 0 and log_w = 0 (no decay, no input), one chunk step each:
    ``kernels.rwkv6.ops.rwkv6_chunk`` when ``use_kernel``, else the plain
    version. A chunk is passed as a slice of the padded sequence, in place."""
    b, s, h, p = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, log_w))
    nc = (s + pad) // chunk
    rc, kc, vc, wc = (t.reshape(b, nc, chunk, h, p) for t in (r, k, v, log_w))
    state = torch.zeros((b, h, p, p), dtype=torch.float32, device=r.device) if s0 is None else s0
    ys = []
    for c in range(nc):
        args = (rc[:, c], kc[:, c], vc[:, c], wc[:, c], u, state)
        if use_kernel:
            y, state = rwkv_ops.rwkv6_chunk(*args)
        else:  # counted as the kernel's call is (``rwkv_ops.chunk_cost``)
            with cost_hook.reckoned("rwkv6_chunk", *rwkv_ops.chunk_cost(b, chunk, h, p)):
                y, state = rwkv6_chunk_ref(*args)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(b, s + pad, h, p)[:, :s]
    return y, state


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def rwkv6_layer(params: RWKV6, x, cfg, state: dict | None = None, sequential: bool = False,
                use_kernel: bool = False):
    """Time-mix block. x: [B,S,D] -> (y, new_state)."""
    b, s, d = x.shape
    if state is not None:
        prev = state["x_prev"][:, None]  # [B,1,D]
    else:
        prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    x_shift = torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)

    r, k, v, log_w, g = _project(params, x, x_shift, cfg)
    u = params.u_bonus
    s0 = state["wkv"] if state is not None else None
    if sequential or s == 1:
        y, s_f = rwkv6_sequential_core(r, k, v, log_w, u, s0)
    else:
        y, s_f = rwkv6_chunked_core(r, k, v, log_w, u, cfg.ssm_chunk, s0, use_kernel)

    # back in the residual dtype, normed over the full d_model, gated in it
    y = y.reshape(b, s, d).to(x.dtype)
    y = rmsnorm(params.ln_out.scale, y, cfg.norm_eps) * g.to(x.dtype)
    out = matmul(y, params.wo)
    new_state = None
    if state is not None:
        new_state = {"x_prev": x[:, -1].to(state["x_prev"].dtype), "wkv": s_f}
    return out, new_state
