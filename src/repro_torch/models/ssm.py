"""Mamba2 (SSD) block: the chunked prefill path and the recurrent decode path.

The port of ``repro.models.ssm``. State-space recurrence per head (``A`` a
scalar per head, the Mamba-2 simplification):

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t        h: [P, N]
    y_t = C_t . h_t + D * x_t

Prefill runs the chunked (SSD) algorithm: within a chunk through the causal
decay matrix ``L[t, i] = exp(cum[t] - cum[i])`` (at most 1 where it is
used), across chunks through the carried state. ``repro`` scans over the
chunks and over time; the port runs the same steps as Python loops. A single
token (decode) and ``sequential=True`` run :func:`mamba2_sequential_core`,
the oracle. The projections run in the parameter dtype, the cores in
float32, the state is float32.

``repro``'s ``mamba2_spec`` (sharding hints) means nothing on one card, so
the port has none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RMSNorm, matmul, normal_param, rmsnorm, silu

__all__ = [
    "Mamba2", "init_mamba2_state", "mamba2_chunked_core", "mamba2_layer",
    "mamba2_sequential_core", "mamba2_spec",
]


def mamba2_spec(cfg) -> dict:
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": (None, "inner"),
        "conv_b": ("inner",),
        "a_log": ("ssm_heads",),
        "d_skip": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": {"scale": ("inner",)},
        "out_proj": ("inner", "embed"),
    }


class Mamba2(nn.Module):
    """The parameters of ``repro.models.ssm.init_mamba2``, under its names
    (one group: ``B`` and ``C`` are shared by every head)."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        conv_ch = di + 2 * n
        f32 = torch.float32
        self.cfg = cfg
        self.in_proj = normal_param((d, 2 * di + 2 * n + h), dtype, d**-0.5, gen, device)
        self.conv_w = normal_param((cfg.ssm_conv, conv_ch), dtype, 0.2, gen, device)
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dtype, device=device))
        self.a_log = nn.Parameter(torch.zeros(h, dtype=f32, device=device))  # A = -exp(a_log)
        self.d_skip = nn.Parameter(torch.ones(h, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(h, dtype=f32, device=device))
        self.norm = RMSNorm(di, cfg.norm_eps, device)
        self.out_proj = normal_param((di, d), dtype, di**-0.5, gen, device)

    def forward(self, u, state=None, sequential: bool = False):
        return mamba2_layer(self, u, self.cfg, state, sequential)


def init_mamba2_state(batch: int, cfg, device, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """``conv`` [B, K-1, C]: the last K-1 inputs of the causal conv;
    ``ssm`` [B, H, P, N]: the recurrent state."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h, di // h, n), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------
def _split_proj(params: Mamba2, u, cfg):
    """(z [B, S, di], xbc [B, S, di + 2N], dt [B, S, H])."""
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = matmul(u, params.in_proj)
    return zxbcdt[..., :di], zxbcdt[..., di : 2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n :]


def _causal_conv(xbc, conv_w, conv_b, prev: torch.Tensor | None):
    """Depthwise causal conv along the sequence; ``prev`` is the [B, K-1, C]
    history (decode). Returns (silu(conv + bias), the new history). The taps
    are summed in ``repro``'s order from Python's ``sum``'s 0, so a bfloat16
    block rounds as ``repro``'s does."""
    k = conv_w.shape[0]
    if prev is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = prev.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [B, S+K-1, C]
    s = xbc.shape[1]
    out = sum(xp[:, i : i + s] * conv_w[i][None, None] for i in range(k))
    out = silu(out + conv_b[None, None])
    return out, xp[:, xp.shape[1] - (k - 1) :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _heads(x, b_mat, c_mat, dt, params: Mamba2, cfg):
    """Heads in float32: (xh [B, S, H, P], B, C [B, S, N], dt [B, S, H], a [H])."""
    di, h = cfg.d_inner, cfg.n_ssm_heads
    bsz, s = x.shape[:2]
    xh = x.reshape(bsz, s, h, di // h).float()
    dt = _softplus(dt.float() + params.dt_bias[None, None])
    a = -torch.exp(params.a_log)
    return xh, b_mat.float(), c_mat.float(), dt, a


# ---------------------------------------------------------------------------
# sequential oracle
# ---------------------------------------------------------------------------
def mamba2_sequential_core(xh, b_mat, c_mat, dt, a, d_skip, h0=None):
    """xh: [B, S, H, P]; b/c: [B, S, N]; dt: [B, S, H]. Returns (y [B, S, H, P],
    the final state [B, H, P, N])."""
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    h_state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device) if h0 is None else h0
    ys = []
    for t in range(s):
        x_t, b_t, c_t, dt_t = xh[:, t], b_mat[:, t], c_mat[:, t], dt[:, t]
        decay = torch.exp(dt_t * a[None, :])  # [B, H]
        upd = _outer((x_t * dt_t[..., None]).reshape(bsz, h * p), b_t).reshape(bsz, h, p, n)
        h_state = h_state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h_state, c_t))
    y = torch.stack(ys, 1) + xh * d_skip[None, None, :, None]
    return y, h_state


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[..., :, None] * b[..., None, :]`` as a product over one term (the
    same values): the pairwise step ``repro``'s ``jnp.einsum`` takes as a
    ``dot_general``, so that the two packages count the same FLOPs."""
    return torch.matmul(a[..., :, None], b[..., None, :])


# ---------------------------------------------------------------------------
# chunked (SSD) core
# ---------------------------------------------------------------------------
def mamba2_chunked_core(xh, b_mat, c_mat, dt, a, d_skip, chunk: int, h0=None):
    """The chunked form of :func:`mamba2_sequential_core`. The tail is
    zero-padded to a whole chunk: ``dt = 0`` there, so the state passes
    through the padding unchanged."""
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    pad = (-s) % chunk
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        b_mat, c_mat = F.pad(b_mat, (0, 0, 0, pad)), F.pad(c_mat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    else:
        xh_p = xh
    nc = (s + pad) // chunk
    xc = xh_p.reshape(bsz, nc, chunk, h, p)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)
    dtc = dt.reshape(bsz, nc, chunk, h)

    h_prev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device) if h0 is None else h0
    t_idx = torch.arange(chunk, device=xh.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    ys = []
    for j in range(nc):
        x, b, c, dtt = xc[:, j], bc[:, j], cc[:, j], dtc[:, j]  # [B,T,H,P], [B,T,N] x2, [B,T,H]
        la = dtt * a[None, None]  # log decay per step, <= 0
        cum = torch.cumsum(la, dim=1)  # [B, T, H] inclusive
        # intra-chunk: L[t, i] = exp(cum[t] - cum[i]) for i <= t (<= 1, safe)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # [B, T, T, H]
        l_mat = torch.where(causal[None, :, :, None], torch.exp(diff), 0.0)
        cb = torch.einsum("btn,bin->bti", c, b)  # [B, T, T]
        w = cb[:, :, :, None] * l_mat  # [B, T, T, H]
        xdt = x * dtt[..., None]
        y = torch.einsum("btih,bihp->bthp", w, xdt)
        # inter-chunk: the carried-in state read by C with decay exp(cum[t])
        y = y + torch.einsum("btnh,bhpn->bthp", _outer(c, torch.exp(cum)), h_prev)
        # state update: h = exp(cum[-1]) h + sum_i exp(cum[-1] - cum[i]) dt_i B_i x_i
        tail = torch.exp(cum[:, -1:, :] - cum)  # [B, T, H]
        upd = torch.einsum("bihp,bihn->bhpn", xdt, _outer(tail, b))
        h_prev = h_prev * torch.exp(cum[:, -1])[:, :, None, None] + upd
        ys.append(y)
    y = torch.stack(ys, 1).reshape(bsz, s + pad, h, p)[:, :s]
    y = y + xh * d_skip[None, None, :, None]
    return y, h_prev


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------
def mamba2_layer(params: Mamba2, u, cfg, state: dict | None = None, sequential: bool = False):
    """u: [B, S, D] -> (y [B, S, D], the new state or None). A state enables
    decode; one token, or ``sequential``, runs the sequential core."""
    di, n = cfg.d_inner, cfg.ssm_state
    z, xbc, dt = _split_proj(params, u, cfg)
    prev = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, params.conv_w, params.conv_b, prev)
    x, b_mat, c_mat = xbc[..., :di], xbc[..., di : di + n], xbc[..., di + n :]
    xh, b_mat, c_mat, dt, a = _heads(x, b_mat, c_mat, dt, params, cfg)

    h0 = state["ssm"] if state is not None else None
    if sequential or u.shape[1] == 1:
        y, h_f = mamba2_sequential_core(xh, b_mat, c_mat, dt, a, params.d_skip, h0)
    else:
        y, h_f = mamba2_chunked_core(xh, b_mat, c_mat, dt, a, params.d_skip, cfg.ssm_chunk, h0)

    y = y.reshape(u.shape[0], u.shape[1], di).to(u.dtype)
    y = rmsnorm(params.norm.scale, y * silu(z), cfg.norm_eps)
    out = matmul(y, params.out_proj)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv.to(state["conv"].dtype), "ssm": h_f}
    return out, new_state
