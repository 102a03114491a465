"""Bytes and operations of one prefill batch of a DeepSeek-V2 model, whatever
implements it: the least work behind ``prefill_mfu``.

Operations: two per multiply-add of every linear layer a token passes
through (the latent attention's projections, the dense FFN, the router, the
top-k routed and the shared experts), causal attention over the prompt
(each query against the keys up to its own position: ``nope + rope`` for
the scores, ``v`` for the values, per head), and the unembedding of the
last position. Bytes: every weight read once, the tokens read, the latent
cache written, the logits written. Embedding rows are gathered, not
multiplied."""

from __future__ import annotations

BYTES = 2  # bfloat16


def active_params(shape: dict) -> dict[str, float]:
    """Multiply-adds a token passes through, by part (the embedding and the
    unembedding left out)."""
    d, h = shape["d_model"], shape["n_heads"]
    dn, dr = shape["qk_nope_dim"], shape["qk_rope_dim"]
    dv, r = shape["v_head_dim"], shape["kv_lora"]
    mla = d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv) + h * dv * d
    expert = 3 * d * shape["moe_d_ff"]
    moe = d * shape["n_experts"] + (shape["top_k"] + shape["n_shared"]) * expert
    return {"attention": shape["layers"] * mla,
            "dense_ffn": shape["dense_layers"] * 3 * d * shape["d_ff"],
            "moe": shape["moe_layers"] * moe}


def total_params(shape: dict) -> float:
    d = shape["d_model"]
    p = active_params(shape)
    expert = 3 * d * shape["moe_d_ff"]
    routed_idle = shape["moe_layers"] * (shape["n_experts"] - shape["top_k"]) * expert
    return sum(p.values()) + routed_idle + 2 * shape["vocab"] * d


def terms(shape: dict) -> dict[str, dict[str, float]]:
    """``shape``: the model's sizes (``d_model``, ``n_heads``, ``qk_nope_dim``,
    ``qk_rope_dim``, ``v_head_dim``, ``kv_lora``, ``d_ff``, ``moe_d_ff``,
    ``n_experts``, ``top_k``, ``n_shared``, ``layers``, ``dense_layers``,
    ``moe_layers``, ``vocab``) and the batch's (``batch`` prompts of
    ``prompt_len`` tokens)."""
    b, s = shape["batch"], shape["prompt_len"]
    tokens = b * s
    pairs = b * s * (s + 1) / 2  # (query, key) pairs under the causal mask
    h = shape["n_heads"]
    qk, v = shape["qk_nope_dim"] + shape["qk_rope_dim"], shape["v_head_dim"]
    ops = {name: 2 * n * tokens for name, n in active_params(shape).items()}
    ops["attention_scores"] = 2 * shape["layers"] * h * pairs * (qk + v)
    ops["unembed"] = 2 * b * shape["d_model"] * shape["vocab"]
    cache = shape["layers"] * tokens * (shape["kv_lora"] + shape["qk_rope_dim"]) * BYTES
    return {
        "bytes": {"weights": total_params(shape) * BYTES, "tokens": 8 * tokens,
                  "latent_cache": cache, "logits": 4 * b * shape["vocab"]},
        "ops": ops,
    }
