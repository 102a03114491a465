"""Attention: MHA/GQA/MQA with sliding windows, softcap, RoPE and KV caches.

The port of ``repro.models.attention``. Three execution paths share one
masked softmax:

* :func:`attend_dense` materialises the ``[B, KV, G, Sq, Sk]`` scores;
* :func:`attend_chunked` runs the online softmax block by block (q blocks by
  kv blocks), float32 accumulation as in the dense path;
* decode: one query token against the ring-buffer cache.

Sliding-window layers hold ``min(window, max_len)`` cache slots and write
position ``p`` at slot ``p % len`` (a ring); a per-slot absolute position
(-1 when unwritten) drives the mask, so prefill, decode and eviction follow
one rule:

    valid(k_pos, q_pos) = 0 <= k_pos <= q_pos and q_pos - k_pos < window

A row with no valid key outputs zero. Masked scores hold ``NEG_INF = -2e38``
(finite, as in ``repro``), scores and RoPE are float32, the probabilities
are cast to ``v``'s dtype before the product with ``v``, and the output
projection returns ``x``'s dtype.

GQA groups the query heads as ``reshape(b, s, kv, g, d)``: head
``h = kv_idx * g + g_idx`` reads kv head ``kv_idx``.

KV caches are written in place: :func:`attention_layer` returns the cache
dict it was given, its ``k``, ``v`` and ``pos`` updated.

``repro``'s sharding hints (``active_axis_size``, ``constrain``) pin layouts
on a TPU mesh and mean nothing on one card, so the port has none.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (
    RMSNorm, apply_rope, matmul, normal_param, rmsnorm, rmsnorm_spec,
)

__all__ = [
    "NEG_INF", "Attention", "attend_chunked", "attend_dense", "attention_core",
    "attention_layer", "attention_spec", "init_kv_cache",
]

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def attention_spec(cfg) -> dict:
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_spec()
        p["k_norm"] = rmsnorm_spec()
    return p


class Attention(nn.Module):
    """The parameters of ``repro.models.attention.init_attention``, under its names."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        s = d**-0.5
        self.wq = normal_param((d, h, hd), dtype, s, gen, device)
        self.wk = normal_param((d, kv, hd), dtype, s, gen, device)
        self.wv = normal_param((d, kv, hd), dtype, s, gen, device)
        self.wo = normal_param((h, hd, d), dtype, (h * hd) ** -0.5, gen, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, device)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` in ``dtype`` (repro's
    ``preferred_element_type=x.dtype``)."""
    h, k, d = wo.shape
    return matmul(out.reshape(*out.shape[:2], h * k), wo.reshape(h * k, d)).to(dtype)


# ---------------------------------------------------------------------------
# masked softmax core
# ---------------------------------------------------------------------------
def _mask(q_pos, k_pos, window, causal):
    """q_pos: [..., Sq], k_pos: [..., Sk] -> bool [..., Sq, Sk]."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = kp >= 0  # invalid (unwritten) cache slots carry pos = -1
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (qp - kp < window)
    return m


def _scores(qg, k, scale, softcap):
    """qg: [B, Sq, KV, G, D], k: [B, Sk, KV, D] -> float32 [B, KV, G, Sq, Sk]."""
    s = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float())
    s = s * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def attend_dense(q, k, v, q_pos, k_pos, *, causal=True, window=None, scale, softcap=None):
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    dv = v.shape[-1]
    qg = q.reshape(b, sq, kv, g, d)
    s = _scores(qg, k, scale, softcap)  # [B, KV, G, Sq, Sk]
    m = _mask(q_pos, k_pos, window, causal)[:, None, None]  # [B, 1, 1, Sq, Sk]
    s = torch.where(m, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key (a padded cache) -> zero output
    p = torch.where(m.any(-1, keepdim=True), p, 0.0)
    out = torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, dv)


def attend_chunked(q, k, v, q_pos, k_pos, *, causal=True, window=None, scale, softcap=None,
                   block_q: int = 1024, block_k: int = 1024):
    """Online-softmax attention, blocked over q and kv: ``repro``'s
    ``lax.map`` over q blocks and ``lax.scan`` over kv blocks as two Python
    loops. Padded queries take position 0 and padded keys position -1."""
    b, sq, h, d = q.shape
    kv_h = k.shape[2]
    g = h // kv_h
    dv = v.shape[-1]
    sk = k.shape[1]
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    pad_q = (-sq) % bq
    pad_k = (-sk) % bk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=0)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad_k), value=-1)
    nq, nk = (sq + pad_q) // bq, (sk + pad_k) // bk

    qg = q.reshape(b, nq, bq, kv_h, g, d)
    qpos_b = q_pos.reshape(b, nq, bq)
    kb = k.reshape(b, nk, bk, kv_h, d)
    vb = v.reshape(b, nk, bk, kv_h, dv)
    kpos_b = k_pos.reshape(b, nk, bk)

    outs = []
    for i in range(nq):
        qblk, qp = qg[:, i], qpos_b[:, i]  # [B, bq, KV, G, D], [B, bq]
        m_run = torch.full((b, kv_h, g, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, kv_h, g, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kv_h, g, bq, dv), dtype=torch.float32, device=q.device)
        for j in range(nk):
            s = _scores(qblk, kb[:, j], scale, softcap)  # [B, KV, G, bq, bk]
            msk = _mask(qp, kpos_b[:, j], window, causal)[:, None, None]
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            # guard: all-masked rows keep m = NEG_INF; never exp(NEG_INF - NEG_INF)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(msk, p, 0.0)
            corr = torch.where(torch.isfinite(m_run), torch.exp(m_run - m_safe), 0.0)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bngqk,bknd->bngqd", p, vb[:, j].float())
            m_run = m_new
        out = acc / torch.clamp_min(l_run[..., None], 1e-37)
        outs.append(out.permute(0, 3, 1, 2, 4))  # [B, bq, KV, G, D]
    out = torch.stack(outs, 1).reshape(b, nq * bq, h, dv)
    return out[:, :sq].to(q.dtype)


def attention_core(q, k, v, q_pos, k_pos, *, causal=True, window=None, scale, softcap=None,
                   chunk_threshold: int = 4096):
    """Dense or chunked, on the total score size (as ``repro`` dispatches)."""
    if q.shape[1] * k.shape[1] > chunk_threshold * chunk_threshold // 4 and q.shape[1] > 1:
        return attend_chunked(q, k, v, q_pos, k_pos, causal=causal, window=window, scale=scale,
                              softcap=softcap)
    return attend_dense(q, k, v, q_pos, k_pos, causal=causal, window=window, scale=scale,
                        softcap=softcap)


# ---------------------------------------------------------------------------
# full layer: projections + rope + cache handling
# ---------------------------------------------------------------------------
def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int, window: int | None,
                  dtype, device) -> dict[str, torch.Tensor]:
    length = max_len if window is None else min(window, max_len)
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int32, device=device),
    }


def attention_layer(params: Attention, x, positions, cfg, *, window: int | None,
                    cache: dict | None = None, cross_kv: tuple | None = None):
    """Self- (or cross-) attention layer. x: [B, S, E], positions: [B, S].
    Returns (output [B, S, E], the cache, updated in place, or None).
    ``cross_kv`` is the encoder's projected (K, V): no RoPE on either side,
    keys at positions ``arange``, not causal."""
    h, kv_h, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = cfg.attn_scale if cfg.attn_scale is not None else hd**-0.5

    q = project_heads(x, params.wq)
    if cfg.qk_norm:
        q = rmsnorm(params.q_norm.scale, q, cfg.norm_eps)
    if cross_kv is not None:
        k, v = cross_kv
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=k.device).expand(k.shape[:2])
        out = attention_core(q, k, v, positions, k_pos, causal=False, window=None, scale=scale,
                             softcap=cfg.attn_softcap)
        return _out_proj(out, params.wo, x.dtype), cache

    k = project_heads(x, params.wk)
    v = project_heads(x, params.wv)
    if cfg.qk_norm:
        k = rmsnorm(params.k_norm.scale, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = attention_core(q, k, v, positions, positions, causal=True, window=window,
                             scale=scale, softcap=cfg.attn_softcap)
        return _out_proj(out, params.wo, x.dtype), None

    # only the last `length` tokens can live in the ring, so write the tail
    # (its slots are then distinct within one write)
    length = cache["k"].shape[1]
    tail = max(0, x.shape[1] - length)
    k_t, v_t, pos_t = k[:, tail:], v[:, tail:], positions[:, tail:]
    slots = (pos_t % length).long()
    b_idx = torch.arange(x.shape[0], device=x.device)[:, None]
    cache["k"][b_idx, slots] = k_t.to(cache["k"].dtype)
    cache["v"][b_idx, slots] = v_t.to(cache["v"].dtype)
    cache["pos"][b_idx, slots] = pos_t.to(cache["pos"].dtype)
    if x.shape[1] > 1:
        # prefill: the ring may be shorter than S, so attend over the fresh K/V
        out = attention_core(q, k, v, positions, positions, causal=True, window=window,
                             scale=scale, softcap=cfg.attn_softcap)
    else:
        # decode: attend over the ring just written
        out = attention_core(q, cache["k"], cache["v"], positions, cache["pos"], causal=True,
                             window=window, scale=scale, softcap=cfg.attn_softcap)
    return _out_proj(out, params.wo, x.dtype), cache
