"""Bytes and operations of the latent attention's causal attention in one
prefill batch of a DeepSeek-V2 model, whatever implements it: the least work
behind ``mla_attention_roofline``.

Operations: two per multiply-add of the scores (``nope + rope`` a pair) and
of the values (``v`` a pair), over the (query, key) pairs the causal mask
keeps, per head and layer: the ``attention_scores`` term of
``counts_prefill.py``. Bytes: the decompressed q, k and v read once and the
output written once a layer, in bfloat16."""

from __future__ import annotations

from perfbench.reference.counts_prefill import BYTES


def terms(shape: dict) -> dict[str, dict[str, float]]:
    """``shape``: the model's ``n_heads``, ``qk_nope_dim``, ``qk_rope_dim``,
    ``v_head_dim`` and ``layers``, and the batch's (``batch`` prompts of
    ``prompt_len`` tokens)."""
    b, s, layers = shape["batch"], shape["prompt_len"], shape["layers"]
    pairs = b * s * (s + 1) / 2  # (query, key) pairs under the causal mask
    heads = layers * shape["n_heads"]  # heads of every layer
    qk, v = shape["qk_nope_dim"] + shape["qk_rope_dim"], shape["v_head_dim"]
    rows = heads * b * s  # a token's row of one head in one layer
    return {
        "bytes": {"q": rows * qk * BYTES, "k": rows * qk * BYTES, "v": rows * v * BYTES,
                  "out": rows * v * BYTES},
        "ops": {"scores": 2 * heads * pairs * qk, "values": 2 * heads * pairs * v},
    }
