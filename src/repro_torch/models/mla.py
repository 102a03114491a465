"""Multi-head Latent Attention (DeepSeek-V2/V3): prefill and absorbed decode.

The port of ``repro.models.mla``. Two numerically equivalent paths:

* prefill (or no cache): decompress the latent ``c_kv`` into per-head K/V
  and run the shared :func:`attention_core` (causal, no window), or on the
  card, for bf16 tensors at the full head sizes (192 for q and k, 128 for
  v) that need no gradient, the hand-written kernel
  ``kernels/mla_attention`` that computes the same (:func:`takes_kernel`);
* decode ("absorbed"): the cache stores only ``c_kv [B, L, kv_lora]`` and
  ``k_rope [B, L, rope]``, and the up-projections are absorbed into the
  query and output sides:

      q_eff[b,h,c]    = sum_d q_nope[b,h,d] * w_uk[c,h,d]
      score           = (q_eff . c_kv + q_rope . k_rope) * scale   (float32)
      ctx[b,h,c]      = sum_l softmax(score)[l] * c_kv[l,c]
      out_head[b,h,d] = sum_c ctx[b,h,c] * w_uv[c,h,d]

The cache is a ring as the port's KV caches are: position ``p`` goes to
slot ``p % L``, written in place (:func:`mla_layer` returns the dict it was
given), with a per-slot absolute position (-1 when unwritten) for the mask.
With a cache, a prefill attends within the current chunk only
(``positions`` against ``positions``), as ``repro``'s does.

With YaRN (``configs.base.YaRN``, a ``PortModelConfig`` option; DeepSeek-V2)
both paths rotate at YaRN's frequencies and multiply the softmax scale by
``yarn_mscale(factor, mscale_all_dim) ** 2``. The layer runs inside the
profiler span ``repro_torch.mla`` (``core/tracing.py``).

``repro``'s sharding hints (``mla_spec``, ``constrain``) pin layouts on a
TPU mesh and mean nothing on one card, so the port has none.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import option
from repro_torch.core.tracing import span
from repro_torch.kernels.mla_attention import ops as mla_ops
from repro_torch.models.attention import NEG_INF, _out_proj, attention_core, project_heads
from repro_torch.models.layers import (
    RMSNorm, apply_rope, matmul, normal_param, rmsnorm_spec, yarn_mscale,
)

__all__ = ["MLA", "init_mla_cache", "mla_layer", "mla_spec", "takes_kernel"]


def mla_spec(cfg) -> dict:
    p = {
        "w_dkv": ("embed", "kv_lora"),
        "kv_norm": rmsnorm_spec(),
        "w_kr": ("embed", "head_dim"),
        "w_uk": ("kv_lora", "heads", "head_dim"),
        "w_uv": ("kv_lora", "heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = ("embed", "q_lora")
        p["q_norm"] = rmsnorm_spec()
        p["w_uq"] = ("q_lora", "heads", "head_dim")
    else:
        p["w_uq"] = ("embed", "heads", "head_dim")
    return p


class MLA(nn.Module):
    """The parameters of ``repro.models.mla.init_mla``, under its names:
    ``w_dq`` and ``q_norm`` only when ``q_lora_rank > 0``."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        s = d**-0.5
        if r_q:
            self.w_dq = normal_param((d, r_q), dtype, s, gen, device)
            self.q_norm = RMSNorm(r_q, cfg.norm_eps, device)
            self.w_uq = normal_param((r_q, h, dn + dr), dtype, r_q**-0.5, gen, device)
        else:
            self.w_uq = normal_param((d, h, dn + dr), dtype, s, gen, device)
        self.w_dkv = normal_param((d, r_kv), dtype, s, gen, device)
        self.kv_norm = RMSNorm(r_kv, cfg.norm_eps, device)
        self.w_kr = normal_param((d, dr), dtype, s, gen, device)
        self.w_uk = normal_param((r_kv, h, dn), dtype, r_kv**-0.5, gen, device)
        self.w_uv = normal_param((r_kv, h, dv), dtype, r_kv**-0.5, gen, device)
        self.wo = normal_param((h, dv, d), dtype, (h * dv) ** -0.5, gen, device)


def init_mla_cache(batch: int, max_len: int, cfg, dtype, device) -> dict[str, torch.Tensor]:
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def _einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the promoted dtype of its operands, as ``jnp.einsum``
    computes a product of float32 and bfloat16."""
    dtype = operands[0].dtype
    for op in operands[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    return torch.einsum(eq, *(op.to(dtype) for op in operands))


def _project_q(params: MLA, x, cfg):
    if cfg.q_lora_rank:
        cq = params.q_norm(matmul(x, params.w_dq))
        q = project_heads(cq, params.w_uq)
    else:
        q = project_heads(x, params.w_uq)
    return q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim :]


def takes_kernel(q, k, v, positions) -> bool:
    """Whether the prefill's attention over ``q``, ``k`` [B, S, H, dq] and
    ``v`` [B, S, H, dv] runs the CUDA kernel: bf16 CUDA tensors at its head
    sizes (192 and 128, every full-width MLA configuration) that need no
    gradient, at int64 positions. Everything else (the CPU, float32 on the
    card, the smoke sizes, training) keeps :func:`attention_core`."""
    return (q.is_cuda and all(t.dtype == torch.bfloat16 for t in (q, k, v))
            and q.shape[-1] == mla_ops.QK_DIM and v.shape[-1] == mla_ops.V_DIM
            and positions.dtype == torch.int64
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))))


def mla_layer(params: MLA, x, positions, cfg, cache: dict | None = None):
    """x: [B, S, E], positions: [B, S]. Returns (output [B, S, E] in ``x``'s
    dtype, the cache updated in place, or None)."""
    with span("repro_torch.mla"):
        return _mla_layer(params, x, positions, cfg, cache)


def _mla_layer(params: MLA, x, positions, cfg, cache: dict | None):
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    yarn = option(cfg, "yarn")
    if yarn is not None and yarn.mscale_all_dim:
        mscale = yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        scale = scale * mscale * mscale
    q_nope, q_rope = _project_q(params, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, yarn)

    c_kv = params.kv_norm(matmul(x, params.w_dkv))
    k_rope = apply_rope(matmul(x, params.w_kr)[:, :, None, :], positions, cfg.rope_theta,
                        yarn)[:, :, 0]

    if cache is not None:
        # only the last L tokens can live in the ring, so write the tail (its
        # slots are then distinct within one write)
        length = cache["c_kv"].shape[1]
        tail = max(0, x.shape[1] - length)
        pos_t = positions[:, tail:]
        slots = (pos_t % length).long()
        b_idx = torch.arange(x.shape[0], device=x.device)[:, None]
        cache["c_kv"][b_idx, slots] = c_kv[:, tail:].to(cache["c_kv"].dtype)
        cache["k_rope"][b_idx, slots] = k_rope[:, tail:].to(cache["k_rope"].dtype)
        cache["pos"][b_idx, slots] = pos_t.to(cache["pos"].dtype)

    if x.shape[1] > 1 or cache is None:
        # prefill: decompress and use the shared attention core
        k_nope = project_heads(c_kv, params.w_uk)
        v = project_heads(c_kv, params.w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], cfg.qk_rope_dim)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        if takes_kernel(q, k, v, positions):
            out = mla_ops.mla_attention(q, k, v, positions, scale)
        else:
            out = attention_core(q, k, v, positions, positions, causal=True, window=None,
                                 scale=scale, softcap=None)
    else:
        # absorbed decode against the latent cache
        q_eff = _einsum("bshd,rhd->bshr", q_nope, params.w_uk)
        ck, kr, kpos = cache["c_kv"], cache["k_rope"], cache["pos"]
        s_lat = torch.einsum("bshr,blr->bhsl", q_eff.float(), ck.float())
        s_rope = torch.einsum("bshr,blr->bhsl", q_rope.float(), kr.float())
        scores = (s_lat + s_rope) * scale
        mask = (kpos[:, None, None, :] >= 0) & (kpos[:, None, None, :] <= positions[:, None, :, None])
        scores = torch.where(mask, scores, NEG_INF)
        p_attn = torch.softmax(scores, dim=-1)
        ctx = _einsum("bhsl,blr->bshr", p_attn.to(ck.dtype), ck)
        out = _einsum("bshr,rhd->bshd", ctx, params.w_uv)
    return _out_proj(out, params.wo, x.dtype), cache
