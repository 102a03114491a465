"""Loading DeepSeek-V2 weights published in the Hugging Face layout.

:func:`deepseek_v2_tensors` lists a DeepSeek-V2 config's tensors under the
names and in the shapes of the published checkpoint
(``model.layers.{i}.self_attn.q_proj.weight`` ``[out, in]``, and so on).
:func:`load_deepseek_v2` fills a ``Model`` built from the matching port
config from a function that returns each published tensor by name, as a
checkpoint reader would: one tensor at a time, nothing held twice.

What the load changes from the published layout:

* linear weights ``[out, in]`` become the port's ``[in, ...]``
  (``w_uq [D, H, nope + rope]``, ``wo [H, v, D]``, ``wi_gate [D, F]``, the
  experts stacked ``[E, D, F]``), the router ``[D, E]`` in float32;
* ``kv_a_proj_with_mqa`` splits into ``w_dkv`` (its first ``kv_lora`` rows)
  and ``w_kr``; ``kv_b_proj`` into ``w_uk`` and ``w_uv`` ``[kv_lora, H, .]``;
* the rope columns of ``q_proj`` and the rope rows of
  ``kv_a_proj_with_mqa`` are interleaved pairs in the published layout
  (DeepSeek-V2's ``apply_rotary_pos_emb`` de-interleaves them before it
  rotates split halves); the load takes the even ones then the odd ones,
  so the port's split-half rope computes the same numbers;
* an RMSNorm weight ``w`` loads as the port's scale ``w - 1`` (the port
  normalises by ``1 + scale``), in float32.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["deepseek_v2_tensors", "load_deepseek_v2", "rope_deinterleave"]


def rope_deinterleave(n: int) -> list[int]:
    """The published rope index of each of the port's ``n`` rope positions:
    even ones first, then odd ones."""
    return [*range(0, n, 2), *range(1, n, 2)]


def _layer_kinds(cfg: ModelConfig) -> list[str]:
    specs = (*cfg.prefix_layers, *cfg.period * cfg.n_periods, *cfg.remainder)
    if any(s.kind != "mla" or s.shared for s in specs) or cfg.q_lora_rank:
        raise ValueError(f"{cfg.name}: the DeepSeek-V2 layout has MLA blocks without query "
                         "compression only")
    return [s.ffn for s in specs]


def deepseek_v2_tensors(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every published tensor's name and shape, in checkpoint order."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    out = {"model.embed_tokens.weight": (cfg.vocab, d)}
    for i, ffn in enumerate(_layer_kinds(cfg)):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = (d,)
        out[p + "self_attn.q_proj.weight"] = (h * (dn + dr), d)
        out[p + "self_attn.kv_a_proj_with_mqa.weight"] = (r + dr, d)
        out[p + "self_attn.kv_a_layernorm.weight"] = (r,)
        out[p + "self_attn.kv_b_proj.weight"] = (h * (dn + dv), r)
        out[p + "self_attn.o_proj.weight"] = (d, h * dv)
        out[p + "post_attention_layernorm.weight"] = (d,)
        mlps = []
        if ffn == "dense":
            mlps.append((p + "mlp.", cfg.d_ff))
        elif ffn == "moe":
            out[p + "mlp.gate.weight"] = (cfg.n_experts, d)
            mlps += [(f"{p}mlp.experts.{j}.", cfg.moe_d_ff) for j in range(cfg.n_experts)]
            if cfg.n_shared_experts:
                mlps.append((p + "mlp.shared_experts.", cfg.n_shared_experts * cfg.moe_d_ff))
        for q, f in mlps:
            out[q + "gate_proj.weight"] = (f, d)
            out[q + "up_proj.weight"] = (f, d)
            out[q + "down_proj.weight"] = (d, f)
    out["model.norm.weight"] = (d,)
    out["lm_head.weight"] = (cfg.vocab, d)
    return out


@torch.no_grad()
def load_deepseek_v2(model, tensor) -> None:
    """Copy every published tensor, ``tensor(name, shape)`` (a ``[out, in]``
    weight or a norm's ``[n]``, any dtype and device), into ``model``'s
    parameters in the port's layout. Each tensor is asked for once. The
    softmax router has no bias: ``router_bias`` is zeroed. Raises
    ``ValueError`` if a parameter is left unwritten."""
    cfg = model.cfg
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    rope = torch.tensor(rope_deinterleave(dr), device=model.device)
    q_cols = torch.cat([torch.arange(dn, device=model.device), dn + rope])
    params = dict(model.named_parameters())

    written = set()

    def put(name: str, value: torch.Tensor, row: int | None = None) -> None:
        """Into parameter ``name``, or into its ``row`` (an expert's slab)."""
        (params[name] if row is None else params[name][row]).copy_(value)
        written.add(name)

    for hf, shape in deepseek_v2_tensors(cfg).items():
        w = tensor(hf, shape).to(model.device)
        parts = hf.split(".")
        if hf == "model.embed_tokens.weight":
            put("embedding.table", w)
        elif hf == "lm_head.weight":
            put("unembed.table", w)
        elif hf == "model.norm.weight":
            put("final_norm.scale", w.float() - 1)
        else:
            i, rest = parts[2], ".".join(parts[3:])
            _load_layer(put, f"stack.{i}.", rest, w, cfg, q_cols, rope, (h, dn, dr, dv, r))
    for name, p in params.items():
        if name.endswith("ffn.router_bias"):
            p.zero_()
        elif name not in written:
            raise ValueError(f"{cfg.name}: no published tensor loads {name}")


def _load_layer(put, p: str, rest: str, w: torch.Tensor, cfg, q_cols, rope, dims) -> None:
    h, dn, dr, dv, r = dims
    d = cfg.d_model
    if rest == "input_layernorm.weight":
        put(p + "pre_norm.scale", w.float() - 1)
    elif rest == "post_attention_layernorm.weight":
        put(p + "ffn_norm.scale", w.float() - 1)
    elif rest == "self_attn.q_proj.weight":
        put(p + "inner.w_uq", w.reshape(h, dn + dr, d)[:, q_cols].permute(2, 0, 1))
    elif rest == "self_attn.kv_a_proj_with_mqa.weight":
        put(p + "inner.w_dkv", w[:r].T)
        put(p + "inner.w_kr", w[r:][rope].T)
    elif rest == "self_attn.kv_a_layernorm.weight":
        put(p + "inner.kv_norm.scale", w.float() - 1)
    elif rest == "self_attn.kv_b_proj.weight":
        kv = w.reshape(h, dn + dv, r)
        put(p + "inner.w_uk", kv[:, :dn].permute(2, 0, 1))
        put(p + "inner.w_uv", kv[:, dn:].permute(2, 0, 1))
    elif rest == "self_attn.o_proj.weight":
        put(p + "inner.wo", w.T.reshape(h, dv, d))
    elif rest == "mlp.gate.weight":
        put(p + "ffn.router", w.T.float())
    else:  # an MLP's projection: the dense FFN, an expert or the shared experts
        parts = rest.split(".")
        proj = {"gate_proj": "wi_gate", "up_proj": "wi_up", "down_proj": "wo"}[parts[-2]]
        if parts[1] == "experts":
            put(f"{p}ffn.{proj}", w.T, row=int(parts[2]))
        else:
            put(f"{p}{'ffn_shared' if parts[1] == 'shared_experts' else 'ffn'}.{proj}", w.T)
