"""Shared primitive layers: RMSNorm, embeddings, the gated MLP.

The port's counterparts of ``repro.models.layers``. Each layer is an
``nn.Module`` holding the parameters of ``repro``'s ``init_<layer>`` under the
same names (so ``convert.lm_params_from_numpy`` maps one tree onto the other),
drawn from an explicit ``torch.Generator`` with the same distributions and
scales, and a function that applies it with ``repro``'s dtype rules: a
product of two dtypes runs in the wider one, as JAX promotes it
(:func:`matmul`). RoPE waits for the attention families.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = [
    "DTYPES", "MLP", "Embedding", "RMSNorm", "dt", "embed", "matmul", "mlp", "normal_param",
    "rmsnorm", "silu", "unembed",
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


def normal_param(shape, dtype, scale: float, gen: torch.Generator, device) -> nn.Parameter:
    """``normal(shape) * scale`` drawn in ``dtype``, as ``jax.random.normal(key,
    shape, dtype) * scale`` draws it (the numbers differ: tests carry the JAX
    weights across instead)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    t.normal_(generator=gen)
    t.mul_(scale)
    return nn.Parameter(t)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.einsum`` computes a
    product of float32 and bfloat16 (PyTorch refuses mixed dtypes)."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with ``sigmoid(x) = 1 / (1 + exp(-x))`` op by op in
    the tensor's dtype: ``jax.nn.silu`` lowers to these ops, so in bfloat16
    each one rounds (a fused ``torch.sigmoid`` rounds once and differs from
    it on about a third of bfloat16 inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# RMSNorm (gemma variant: the scale enters as 1 + scale)
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(orig)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
class Embedding(nn.Module):
    """A ``[vocab, d]`` table, ``normal * 0.02``."""

    def __init__(self, vocab: int, d: int, dtype, device, gen: torch.Generator):
        super().__init__()
        self.table = normal_param((vocab, d), dtype, 0.02, gen, device)


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
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device, gen: torch.Generator):
        super().__init__()
        self.wi_gate = normal_param((d, d_ff), dtype, d**-0.5, gen, device)
        self.wi_up = normal_param((d, d_ff), dtype, d**-0.5, gen, device)
        self.wo = normal_param((d_ff, d), dtype, d_ff**-0.5, gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = matmul(x, params.wi_gate)
    up = matmul(x, params.wi_up)
    # the down projection comes out in the input dtype (repro's
    # preferred_element_type=x.dtype)
    return matmul(silu(gate) * up, params.wo).to(x.dtype)
