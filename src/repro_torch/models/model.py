"""Top-level model: embeddings + backbone + head, with the serving entry points.

The port of ``repro.models.model``. ``build_model(cfg, device=...)`` returns
a ``Model`` (an ``nn.Module`` holding its parameters) with

  forward(tokens, positions, caches)       -> (h, caches)
  prefill(tokens, caches)                  -> (logits [B, 1, V], caches)
  decode_step(tokens, pos, caches)         -> (logits [B, 1, V], caches)
  init_caches(batch, max_len)              -> {"stack": [per-layer dict]}

``rwkv_kernel`` (default True) runs each prefill chunk of every RWKV-6 layer
through the ``rwkv6_chunk`` CUDA kernel on the card; ``rwkv_kernel=False``
runs its plain version there instead (the yardstick). On the CPU both run
the plain version. ``loss`` and ``cross_entropy`` come with the training
slice (ROADMAP queue 1, 'LM remainder').
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import backbone as bb
from repro_torch.models import layers as L

__all__ = ["Model", "build_model"]


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device, rwkv_kernel: bool = True, seed: int = 0):
        super().__init__()
        if cfg.n_enc_layers or cfg.mtp_depth or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: encoders, MTP and modality frontends are not ported to "
                "repro_torch yet (ROADMAP queue 1, 'LM remainder')"
            )
        self.cfg = cfg
        self.rwkv_kernel = rwkv_kernel
        dtype = L.dt(cfg.param_dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.embedding = L.Embedding(cfg.vocab, cfg.d_model, dtype, device, gen)
        self.stack = bb.Stack(cfg, dtype, device, gen)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.unembed = L.Embedding(cfg.vocab, cfg.d_model, dtype, device, gen)

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    # -- pieces --------------------------------------------------------------
    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        table = self.embedding.table if self.cfg.tie_embeddings else self.unembed.table
        return L.unembed(table, h, self.cfg.final_softcap)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor, caches: dict | None = None,
                sequential: bool = False):
        """(final-normed hidden states [B, S, D], new caches or None).
        ``sequential=True`` runs every RWKV-6 layer's sequential oracle
        instead of the chunked prefill."""
        cfg = self.cfg
        x = L.embed(self.embedding.table, tokens, cfg.scale_embeddings, cfg.d_model)
        x = x.to(L.dt(cfg.compute_dtype))
        stack_caches = caches["stack"] if caches is not None else None
        h, new_stack_caches = self.stack(x, positions, stack_caches, sequential, self.rwkv_kernel)
        h = self.final_norm(h)
        new_caches = None
        if caches is not None:
            new_caches = dict(caches)
            new_caches["stack"] = new_stack_caches
        return h, new_caches

    # -- entry points -----------------------------------------------------------
    def init_caches(self, batch: int, max_len: int) -> dict:
        return {"stack": self.stack.init_caches(batch, max_len)}

    def prefill(self, tokens: torch.Tensor, caches: dict, sequential: bool = False):
        pos = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        h, caches = self.forward(tokens, pos, caches, sequential)
        return self._unembed(h[:, -1:]), caches

    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, caches: dict):
        """tokens: [B, 1]; pos: [B, 1] absolute positions."""
        h, caches = self.forward(tokens, pos, caches)
        return self._unembed(h), caches


def build_model(cfg: ModelConfig, device: torch.device | str = "cuda", rwkv_kernel: bool = True,
                seed: int = 0) -> Model:
    """A ``Model`` initialised at random on ``device`` (the card unless the
    caller asks for the CPU) from ``torch.Generator(device).manual_seed(seed)``,
    with the distributions and scales of ``repro``'s init. Parameters do not
    require gradients: this is the serving path."""
    model = Model(cfg, resolve_device(device), rwkv_kernel=rwkv_kernel, seed=seed)
    return model.requires_grad_(False)
