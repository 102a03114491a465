"""Plain PyTorch version of one RWKV-6 chunk step (chunked WKV linear attention).

The port's copy of ``repro.models.rwkv.rwkv6_chunk_ref`` / ``_chunk_finish``.
With ``cum[t] = sum_{j<=t} log_w[j]`` (inclusive) and ``cum_prev = cum - log_w``:

    y[t]  = sum_{i<t} (sum_p r[t,p] k[i,p] exp(cum_prev[t,p] - cum[i,p])) v[i]
            + (sum_p r[t,p] u[p] k[t,p]) v[t]
            + (r[t] * exp(cum_prev[t])) @ s0
    s1    = s0 * exp(cum[T-1])[:, None] + (k * exp(cum[T-1] - cum))^T @ v

per (batch, head). The pairwise decay is kept as a difference of exponents:
every exponent is <= 0, where the factored form ``exp(cum_prev) * exp(-cum)``
overflows float32 once ``cum`` passes about -88.
"""

from __future__ import annotations

import torch


def rwkv6_chunk_ref(
    r: torch.Tensor,  # [B, T, H, P] float32
    k: torch.Tensor,  # [B, T, H, P]
    v: torch.Tensor,  # [B, T, H, P]
    log_w: torch.Tensor,  # [B, T, H, P], < 0
    u: torch.Tensor,  # [H, P]
    s0: torch.Tensor,  # [B, H, P, P]
) -> tuple[torch.Tensor, torch.Tensor]:  # (y [B, T, H, P], s1 [B, H, P, P])
    t = r.shape[1]
    cum = torch.cumsum(log_w, dim=1)
    cum_prev = cum - log_w
    # pairwise decay exp(cum_prev[t] - cum[i]) for i < t  -> [B, T, T, H, P]
    diff = cum_prev[:, :, None] - cum[:, None, :, :]
    idx = torch.arange(t, device=r.device)
    strict = idx[:, None] > idx[None, :]
    decay = torch.where(strict[None, :, :, None, None], torch.exp(diff), 0.0)
    return _chunk_finish(r, k, v, u, s0, cum, cum_prev, decay)


def _chunk_finish(r, k, v, u, s0, cum, cum_prev, decay):
    # intra (i < t): per-head attention-like matrix [B, T, T, H]
    a_mat = torch.einsum("bthp,btihp,bihp->btih", r, decay, k)
    y = torch.einsum("btih,bihq->bthq", a_mat, v)
    # diagonal bonus term (i == t)
    diag = torch.einsum("bthp,hp,bthp->bth", r, u, k)
    y = y + diag[..., None] * v
    # carry-in state, read with decay exp(cum_prev[t])
    y = y + torch.einsum("bthp,bthp,bhpq->bthq", r, torch.exp(cum_prev), s0)
    # state update: S' = diag(exp(cum[T-1])) S + sum_i exp(cum[T-1]-cum[i]) k_i v_i^T
    tail = torch.exp(cum[:, -1:] - cum)
    s_new = s0 * torch.exp(cum[:, -1])[..., None] + torch.einsum(
        "bihp,bihp,bihq->bhpq", tail, k, v
    )
    return y, s_new
