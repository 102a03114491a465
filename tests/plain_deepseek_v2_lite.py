"""DeepSeek-V2-Lite's forward pass in plain PyTorch, and its seeded weights.

Written from the published model (arXiv:2405.04434; the Hugging Face
``config.json`` and ``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite),
in the published checkpoint's layout and names: ``cfg`` is the
configuration's dict under the published keys (``hidden_size``,
``kv_lora_rank``, ``rope_scaling``, ...). Nothing here comes from the
program under test.

Weights: :func:`make` draws each tensor from (seed, its name) alone, in
bfloat16 as the published checkpoint holds it: a linear weight ``[out, in]``
normal with std ``in ** -0.5``, the embedding normal with std 1, an RMSNorm
weight ``1 + 0.1 * normal``. The program loads the same tensors by name; the
reference makes them again, layer by layer, and computes in ``dtype``.

:func:`forward` per layer: RMSNorm; multi-head latent attention with no
query compression (``q_proj``; ``kv_a_proj_with_mqa`` into the latent and
the shared rope key; RMSNorm on the latent; ``kv_b_proj`` into the heads'
nope keys and values; rope on the interleaved rope pairs, de-interleaved
as the published code does, at YaRN's frequencies; causal softmax at
``(nope + rope) ** -0.5 * mscale ** 2``, float32 or wider); residual;
RMSNorm; the dense SwiGLU FFN on the first ``first_k_dense_replace`` layers,
else the MoE: softmax router, greedy top-k, the raw probabilities as
weights (``norm_topk_prob`` false) times ``routed_scaling_factor``, every
assignment through its expert (no capacity), plus the shared experts;
residual. Then the final RMSNorm and ``lm_head``.

It holds one layer's weights at a time and attends one block of queries at
a time against the keys up to the block's end, so it fits on the card
alone. No cache, no capacity, no kernels. TF32 is off while it runs.
``round_to`` (a float8 dtype) rounds both inputs of every matrix product
to that type, each scaled by its largest magnitude: the lower-precision
control.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

EPS = 1e-6  # rms_norm_eps


# ---------------------------------------------------------------------------
# the weights
# ---------------------------------------------------------------------------
def tensor_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every published tensor of ``cfg``'s model, by name."""
    d, h, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    out = {"model.embed_tokens.weight": (cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = (d,)
        out[p + "self_attn.q_proj.weight"] = (h * (dn + dr), d)
        out[p + "self_attn.kv_a_proj_with_mqa.weight"] = (r + dr, d)
        out[p + "self_attn.kv_a_layernorm.weight"] = (r,)
        out[p + "self_attn.kv_b_proj.weight"] = (h * (dn + dv), r)
        out[p + "self_attn.o_proj.weight"] = (d, h * dv)
        out[p + "post_attention_layernorm.weight"] = (d,)
        if i < cfg["first_k_dense_replace"]:
            mlps = [(p + "mlp.", cfg["intermediate_size"])]
        else:
            out[p + "mlp.gate.weight"] = (cfg["n_routed_experts"], d)
            f = cfg["moe_intermediate_size"]
            mlps = [(f"{p}mlp.experts.{j}.", f) for j in range(cfg["n_routed_experts"])]
            mlps.append((p + "mlp.shared_experts.", cfg["n_shared_experts"] * f))
        for q, f in mlps:
            out[q + "gate_proj.weight"] = (f, d)
            out[q + "up_proj.weight"] = (f, d)
            out[q + "down_proj.weight"] = (d, f)
    out["model.norm.weight"] = (d,)
    out["lm_head.weight"] = (cfg["vocab_size"], d)
    return out


def make(seed: int, name: str, shape, device) -> torch.Tensor:
    """Tensor ``name`` of the model of ``seed``, bfloat16 on ``device``: the
    same numbers for the same (seed, name) on one kind of device."""
    state = np.random.SeedSequence([int(seed) % 2**64, *name.encode()]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    if len(shape) == 1:  # an RMSNorm weight
        x = 1.0 + 0.1 * x
    elif name != "model.embed_tokens.weight":
        x = x * shape[1] ** -0.5
    return x.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class _Math:
    """Matrix products in ``dtype``, inputs rounded to ``round_to`` first."""

    def __init__(self, dtype, round_to):
        self.dtype, self.round_to = dtype, round_to

    def _round(self, x):
        if self.round_to is None:
            return x
        top = torch.finfo(self.round_to).max
        if top > 1e5:  # a type with float32's range needs no scale
            return x.to(self.round_to).to(self.dtype)
        s = x.abs().amax().clamp_min(1e-30) / top
        return (x / s).to(self.round_to).to(self.dtype) * s

    def mm(self, a, b):
        return torch.matmul(self._round(a), self._round(b))

    def linear(self, x, w):
        return self.mm(x, w.T)


def _rmsnorm(x, w):
    return w * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS))


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _yarn_inv_freq(cfg: dict, dtype, device):
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg["rope_scaling"]
    powers = base ** (torch.arange(0, dim, 2, dtype=dtype, device=device) / dim)
    extra, inter = 1.0 / powers, 1.0 / (rs["factor"] * powers)

    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    lo = max(math.floor(corr(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=dtype, device=device) - lo)
            / (hi - lo if hi > lo else 0.001)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def _rope(x, cos, sin):
    """x [..., S, dr] in the published interleaved layout: de-interleaved,
    then rotated by halves."""
    *lead, s, dr = x.shape
    x = x.reshape(*lead, s, dr // 2, 2).transpose(-1, -2).reshape(*lead, s, dr)
    x1, x2 = x[..., : dr // 2], x[..., dr // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _attention(m: _Math, cfg, x, w, cos, sin, block):
    b, s, d = x.shape
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = m.linear(x, w("self_attn.q_proj.weight")).view(b, s, h, dn + dr).transpose(1, 2)
    ckv = m.linear(x, w("self_attn.kv_a_proj_with_mqa.weight"))
    c = _rmsnorm(ckv[..., :r], w("self_attn.kv_a_layernorm.weight"))
    kv = m.linear(c, w("self_attn.kv_b_proj.weight")).view(b, s, h, dn + dv).transpose(1, 2)
    q_pe = _rope(q[..., dn:], cos, sin)
    k_pe = _rope(ckv[..., r:][:, None], cos, sin)  # [B, 1, S, dr]
    q = torch.cat([q[..., :dn], q_pe], -1)
    k = torch.cat([kv[..., :dn], k_pe.expand(b, h, s, dr)], -1)
    v = kv[..., dn:]
    rs = cfg["rope_scaling"]
    m_all = _mscale(rs["factor"], rs["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * m_all * m_all
    out = torch.empty((b, h, s, dv), dtype=x.dtype, device=x.device)
    for q0 in range(0, s, block):
        q1 = min(q0 + block, s)
        scores = m.mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * scale
        causal = torch.arange(q0, q1, device=x.device)[:, None] >= torch.arange(
            q1, device=x.device)[None, :]
        scores = scores.masked_fill(~causal, float("-inf"))
        out[:, :, q0:q1] = m.mm(torch.softmax(scores, -1), v[:, :, :q1])
    o = m.linear(out.transpose(1, 2).reshape(b, s, h * dv), w("self_attn.o_proj.weight"))
    return o, c, k_pe[:, 0]


def _mlp(m: _Math, x, w, p):
    g = m.linear(x, w(p + "gate_proj.weight"))
    u = m.linear(x, w(p + "up_proj.weight"))
    return m.linear(torch.nn.functional.silu(g) * u, w(p + "down_proj.weight"))


def _moe(m: _Math, cfg, x, w):
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(m.linear(x, w("mlp.gate.weight")), -1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    else:
        top_w = top_w * cfg["routed_scaling_factor"]
    y = _mlp(m, x, w, "mlp.shared_experts.")
    for e in range(cfg["n_routed_experts"]):
        tok, rank = (top_i == e).nonzero(as_tuple=True)
        if tok.numel():
            out = _mlp(m, x[tok], w, f"mlp.experts.{e}.") * top_w[tok, rank, None]
            y = y.index_add(0, tok, out)
    return y, top_i


@torch.no_grad()
def forward(cfg: dict, seed: int, tokens: torch.Tensor, dtype=torch.float32, round_to=None,
            all_logits: bool = False, block: int = 1024) -> dict[str, torch.Tensor]:
    """The model of ``seed`` on ``tokens [B, S]`` (on the device it runs on).
    Returns ``logits`` ``[B, V]`` of the last position (``[B, S, V]`` with
    ``all_logits``), ``choices`` ``[n_moe_layers, B * S, k]`` (each token's
    experts, best first), and the last layer's latent ``c_kv [B, S,
    kv_lora]`` and rotated rope key ``k_rope [B, S, rope]``, all in
    ``dtype``."""
    dev = tokens.device
    shapes = tensor_shapes(cfg)
    m = _Math(dtype, round_to)

    def weights(prefix):
        return lambda name: make(seed, prefix + name, shapes[prefix + name], dev).to(dtype)

    with _no_tf32():
        b, s = tokens.shape
        inv_freq = _yarn_inv_freq(cfg, dtype, dev)
        freqs = torch.arange(s, dtype=dtype, device=dev)[:, None] * inv_freq[None]
        rs = cfg["rope_scaling"]
        gain = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
        emb = torch.cat([freqs, freqs], -1)
        cos, sin = emb.cos() * gain, emb.sin() * gain
        hid = weights("")("model.embed_tokens.weight")[tokens]
        choices = []
        for i in range(cfg["num_hidden_layers"]):
            w = weights(f"model.layers.{i}.")
            o, c_kv, k_rope = _attention(m, cfg, _rmsnorm(hid, w("input_layernorm.weight")), w,
                                         cos, sin, block)
            hid = hid + o
            x = _rmsnorm(hid, w("post_attention_layernorm.weight"))
            if i < cfg["first_k_dense_replace"]:
                hid = hid + _mlp(m, x, w, "mlp.")
            else:
                y, top_i = _moe(m, cfg, x.reshape(b * s, -1), w)
                hid = hid + y.reshape(b, s, -1)
                choices.append(top_i)
        top = weights("")
        hid = _rmsnorm(hid if all_logits else hid[:, -1], top("model.norm.weight"))
        logits = m.linear(hid, top("lm_head.weight"))
    return {"logits": logits, "choices": torch.stack(choices), "c_kv": c_kv, "k_rope": k_rope}
