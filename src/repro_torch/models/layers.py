"""Shared primitive layers: RMSNorm, RoPE, embeddings, the gated MLP, softcap.

The port's counterparts of ``repro.models.layers``. Each layer is an
``nn.Module`` holding the parameters of ``repro``'s ``init_<layer>`` under the
same names (so ``convert.lm_params_from_numpy`` maps one tree onto the other),
drawn from an explicit ``torch.Generator`` with the same distributions and
scales, and a function that applies it with ``repro``'s dtype rules: a
product of two dtypes runs in the wider one, as JAX promotes it
(:func:`matmul`). Each ``<layer>_spec()`` gives ``repro``'s tree of
*logical axis* tuples for the layer's parameters (``distributed.sharding``).

On the meta device (``build_model(..., device="meta")``) a layer holds its
parameters' shapes and dtypes and draws nothing: no generator is needed.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = [
    "DTYPES", "MLP", "Embedding", "RMSNorm", "apply_rope", "dt", "embed", "embedding_spec", "gelu",
    "matmul", "mlp", "mlp_spec", "normal_param", "rmsnorm", "rmsnorm_spec", "rope_freqs",
    "sigmoid", "silu", "softcap", "unembed", "yarn_correction_range", "yarn_mscale",
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


def normal_param(shape, dtype, scale: float, gen: torch.Generator, device) -> nn.Parameter:
    """``normal(shape) * scale`` drawn in ``dtype``, as ``jax.random.normal(key,
    shape, dtype) * scale`` draws it (the numbers differ: tests carry the JAX
    weights across instead). On the meta device nothing is drawn."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        t.normal_(generator=gen)
        t.mul_(scale)
    return nn.Parameter(t)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum`` computes a
    product of float32 and bfloat16 (PyTorch refuses mixed dtypes). Rows of
    any batch times one matrix are one GEMM, as XLA's ``dot_general`` is:
    ``torch.matmul`` would broadcast ``w`` over a strided ``x``'s batch."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    if w.dim() == 2 and x.dim() > 2:
        rows = x.reshape(-1, x.shape[-1]).to(dtype)
        return torch.matmul(rows, w.to(dtype)).reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(dtype), w.to(dtype))


class _Sigmoid(torch.autograd.Function):
    """``1 / (1 + exp(-x))`` op by op, with ``jax.nn.sigmoid``'s derivative
    ``y * (1 - y)``: differentiating the ops themselves gives ``0 * inf =
    nan`` where ``exp(-x)`` overflows (x below about -88)."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as ``jax`` lowers it: ``1 / (1 + exp(-x))`` op by op
    in the tensor's dtype (each op rounds in bfloat16, where a fused
    ``torch.sigmoid`` rounds once and differs on about a third of the
    inputs), differentiable wherever it is finite."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with :func:`sigmoid`, as ``jax.nn.silu``."""
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh approximation), op by op in the
    tensor's dtype as :func:`silu` is."""
    sqrt_2_over_pi = torch.tensor((2 / torch.pi) ** 0.5, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(sqrt_2_over_pi * (x + 0.044715 * x**3)))
    return x * cdf


# ---------------------------------------------------------------------------
# RMSNorm (gemma variant: the scale enters as 1 + scale)
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(orig)


def rmsnorm_spec() -> dict:
    return {"scale": ("embed",)}


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature ``0.1 * mscale * ln(factor) + 1`` (1 for
    ``factor <= 1``)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(head_dim: int, theta: float, yarn) -> tuple[int, int]:
    """The rotary pair indices between which YaRN ramps from extrapolation
    to interpolation: the dims that turn ``beta_fast`` and ``beta_slow``
    times in ``original_max_position`` positions, floored and ceiled."""

    def dim(rotations):
        return (head_dim * math.log(yarn.original_max_position / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    return max(math.floor(dim(yarn.beta_fast)), 0), min(math.ceil(dim(yarn.beta_slow)),
                                                        head_dim - 1)


def rope_freqs(head_dim: int, theta: float, device=None, yarn=None) -> torch.Tensor:
    """The ``head_dim / 2`` inverse frequencies; with ``yarn``
    (``configs.base.YaRN``) YaRN's blend of the extrapolated ones and the
    ones interpolated by ``yarn.factor``, float32 as DeepSeek-V2 computes it."""
    powers = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                       / head_dim)
    if yarn is None:
        return 1.0 / powers
    lo, hi = yarn_correction_range(head_dim, theta, yarn)
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device) - lo)
            / ((hi - lo) if hi > lo else 0.001)).clamp(0, 1)
    extrapolate = 1.0 - ramp
    return 1.0 / (yarn.factor * powers) * (1 - extrapolate) + 1.0 / powers * extrapolate


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn=None) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] integers. Rotates pairs (split-half:
    element i with element i + D/2), in float32, back in ``x``'s dtype. With
    ``yarn``, at YaRN's frequencies, cos and sin scaled by its
    ``mscale / mscale_all_dim`` temperatures' ratio."""
    freqs = rope_freqs(x.shape[-1], theta, x.device, yarn)  # [D/2]
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if yarn is not None:
        gain = yarn_mscale(yarn.factor, yarn.mscale) / yarn_mscale(yarn.factor,
                                                                    yarn.mscale_all_dim)
        if gain != 1.0:
            cos, sin = cos * gain, sin * gain
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
class Embedding(nn.Module):
    """A ``[vocab, d]`` table, ``normal * 0.02``."""

    def __init__(self, vocab: int, d: int, dtype, device, gen: torch.Generator):
        super().__init__()
        self.table = normal_param((vocab, d), dtype, 0.02, gen, device)


def embedding_spec(for_input: bool = False) -> dict:
    """Input tables shard the embed dim (token gathers stay local to a
    shard), output tables the vocab dim (the logits product)."""
    return {"table": ("vocab_in", "embed") if for_input else ("vocab", "embed")}


def embed(table: torch.Tensor, tokens: torch.Tensor, scale: bool, d_model: int) -> torch.Tensor:
    x = table[tokens]
    if scale:
        x = x * torch.tensor(d_model**0.5, dtype=x.dtype)
    return x


def unembed(table: torch.Tensor, x: torch.Tensor, softcap: float | None = None) -> torch.Tensor:
    """Logits ``x @ table^T`` in the promoted dtype, then float32."""
    logits = matmul(x, table.T).float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device, gen: torch.Generator):
        super().__init__()
        self.wi_gate = normal_param((d, d_ff), dtype, d**-0.5, gen, device)
        self.wi_up = normal_param((d, d_ff), dtype, d**-0.5, gen, device)
        self.wo = normal_param((d_ff, d), dtype, d_ff**-0.5, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def mlp_spec() -> dict:
    return {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}


def mlp(params: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    gate = matmul(x, params.wi_gate)
    up = matmul(x, params.wi_up)
    gate = gelu(gate) if act == "gelu" else silu(gate)
    # the down projection comes out in the input dtype (repro's
    # preferred_element_type=x.dtype)
    return matmul(gate * up, params.wo).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
