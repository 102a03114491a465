"""Block stack: the port of ``repro.models.backbone`` for RWKV-6 blocks.

``repro`` stacks the parameters of its repeating period along a leading
``[n_periods]`` axis and scans over it. The port unrolls that scan: ``Stack``
is an ``nn.ModuleList`` of ``n_layers`` blocks, layer ``p * len(period) + i``
being block ``i`` of period ``p``, and its forward is a Python loop.
Caches are a list with one dict per layer.

Ported so far: blocks of kind ``rwkv6`` with a dense FFN. Other block kinds,
``shared`` blocks, ``post_block_norm`` and the ``prefix_layers``/``remainder``
blocks raise ``NotImplementedError`` (ROADMAP queue 1, 'LM remainder'), and
so do cross-attention blocks (the model refuses encoders).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import MLP, RMSNorm

__all__ = ["Block", "Stack", "check_ported"]

_LATER = "is not ported to repro_torch yet (ROADMAP queue 1, 'LM remainder')"


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's stack cannot build."""
    for spec in (*cfg.prefix_layers, *cfg.period, *cfg.remainder):
        if spec.kind != "rwkv6":
            raise NotImplementedError(f"block kind {spec.kind!r} {_LATER}")
        if spec.ffn != "dense":
            raise NotImplementedError(f"ffn {spec.ffn!r} {_LATER}")
        if spec.shared:
            raise NotImplementedError(f"a shared block {_LATER}")
    if cfg.prefix_layers or cfg.remainder:
        raise NotImplementedError(f"prefix_layers / remainder {_LATER}")
    if cfg.post_block_norm:
        raise NotImplementedError(f"post_block_norm {_LATER}")


class Block(nn.Module):
    """pre_norm -> inner (time mix) -> residual; ffn_norm -> ffn -> residual."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen: torch.Generator):
        super().__init__()
        self.pre_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.inner = rwkv_mod.RWKV6(cfg, dtype, device, gen)
        self.ffn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device, gen)

    def forward(self, x, cache: dict | None, sequential: bool = False, use_kernel: bool = False):
        h = self.pre_norm(x)
        out, new_cache = self.inner(h, cache or None, sequential, use_kernel)
        x = x + out
        x = x + self.ffn(self.ffn_norm(x))
        return x, ({} if new_cache is None else new_cache)


class Stack(nn.ModuleList):
    """The ``n_layers`` blocks of one model, in order."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen: torch.Generator):
        check_ported(cfg)  # every block of the period is an rwkv6 block with a dense FFN
        super().__init__(Block(cfg, dtype, device, gen) for _ in range(cfg.n_layers))
        self.cfg = cfg

    def init_caches(self, batch: int, max_len: int) -> list[dict[str, torch.Tensor]]:
        """One cache per layer; RWKV-6 state does not grow with ``max_len``."""
        device = self[0].pre_norm.scale.device
        return [rwkv_mod.init_state(batch, self.cfg, device) for _ in self]

    def forward(self, x, positions, caches: list | None = None, sequential: bool = False,
                use_kernel: bool = False):
        """``repro``'s ``Stack.apply``: (x, new caches or None). ``positions``
        are for RoPE, which RWKV-6 blocks do not use."""
        new_caches = [] if caches is not None else None
        for i, block in enumerate(self):
            x, nc = block(x, caches[i] if caches is not None else None, sequential, use_kernel)
            if caches is not None:
                new_caches.append(nc)
        return x, new_caches
