"""Top-level model: embeddings + backbone + head, with the serving entry points.

The port of ``repro.models.model``. ``build_model(cfg, device=...)`` returns
a ``Model`` (an ``nn.Module`` holding its parameters) with

  forward(tokens, positions, caches, batch) -> (h, caches, aux)
  loss(batch)                              -> (scalar, aux)   [differentiable]
  prefill(tokens, caches, batch)           -> (logits [B, 1, V], caches)
  prefill(..., return_aux=True)            -> (logits, caches, aux)
  decode_step(tokens, pos, caches)         -> (logits [B, 1, V], caches)
  init_caches(batch, max_len)              -> {"stack": [per-layer dict], "enc_out"?}
  param_specs()                            -> {parameter name: logical axes}

Modality frontends are stubs, as in ``repro``: audio (whisper) takes
precomputed frame embeddings ``batch["frames"]`` [B, enc_seq, D] through an
encoder stack of causal attention blocks, whose output the decoder's
cross-attention reads and the caches carry into decode; vision (internvl2)
takes precomputed patch embeddings ``batch["prefix_embeddings"]`` [B,
n_prefix, D], which overwrite the first ``n_prefix`` token embeddings.

MTP (deepseek-v3, ``mtp_depth > 0``) adds one attention block with a dense
FFN applied to ``(h_t, emb(t+1))``, predicting token ``t + 2``; it enters
the loss only, with weight 0.3. ``loss`` (with ``cross_entropy``, the
blockwise ``_chunked_ce`` for ``loss_chunk > 0`` and the switch-style load
term of a MoE router that is not aux-free) is ``repro``'s and
differentiable: ``repro_torch.train.loop`` takes its gradients with respect
to every parameter (a shared block's summed over its applications, as
``jax.grad`` sums them). Serving runs ``prefill`` / ``decode_step`` under
``torch.inference_mode`` (``serve.engine``).

``rwkv_kernel`` (default True) runs each prefill chunk of every RWKV-6 layer
through the ``rwkv6_chunk`` CUDA kernel on the card; ``rwkv_kernel=False``
runs its plain version there instead (the yardstick). On the CPU both run
the plain version. The kernel has no backward (``repro``'s Pallas kernel has
none either): it refuses inputs that require gradients, so a model that
trains is built with ``rwkv_kernel=False``. Attention, MLA, Mamba2 and the
MoE dispatch run in plain PyTorch, as ``repro`` runs them in plain ``jnp``.

``moe_impl="sharded"`` with a ``mesh`` (``distributed.mesh.make_mesh``, which
may repeat one device) runs every MoE block's experts expert-parallel over
the mesh (``models.moe.moe_block_sharded``) in the forward, the loss and its
backward, prefill and decode alike. ``device="meta"`` builds the model's
shapes and dtypes without allocating or drawing anything, for any config
(deepseek-v3-671b included): ``distributed.elastic.remesh_pspecs`` resolves
its shardings from them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.convert import repro_path
from repro_torch.core.device import resolve_device
from repro_torch.models import backbone as bb
from repro_torch.models import layers as L

__all__ = ["MTP", "Model", "build_model", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None):
    """logits: [B, S, V] float32; labels: [B, S] integers. Mean NLL over the
    tokens ``mask`` keeps (all without one)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


class MTP(nn.Module):
    """``repro``'s ``params["mtp"]``: ``proj`` [2D, D], an attention block
    with a dense FFN, and the norms of its two inputs."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen: torch.Generator):
        super().__init__()
        d = cfg.d_model
        self.proj = L.normal_param((2 * d, d), dtype, (2 * d) ** -0.5, gen, device)
        self.block = bb.Block(BlockSpec(kind="attn"), cfg, dtype, device, gen)
        self.norm_h = L.RMSNorm(d, cfg.norm_eps, device)
        self.norm_e = L.RMSNorm(d, cfg.norm_eps, device)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device, rwkv_kernel: bool = True, seed: int = 0,
                 moe_impl: str = "local", loss_chunk: int = 0, mesh=None):
        super().__init__()
        bb.check_moe_impl(moe_impl, mesh)
        self.cfg = cfg
        self.rwkv_kernel = rwkv_kernel
        self.moe_impl = moe_impl
        self.mesh = mesh
        # > 0: blockwise cross-entropy over sequence chunks of this length
        # (never the full [B, S, V] logits)
        self.loss_chunk = loss_chunk
        dtype = L.dt(cfg.param_dtype)
        # the meta device draws nothing, and has no generator
        gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)
        self.embedding = L.Embedding(cfg.vocab, cfg.d_model, dtype, device, gen)
        self.stack = bb.Stack(cfg, dtype, device, gen, cross=cfg.n_enc_layers > 0,
                              moe_impl=moe_impl, mesh=mesh)
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.unembed = L.Embedding(cfg.vocab, cfg.d_model, dtype, device, gen)
        if cfg.n_enc_layers:
            enc_cfg = dataclasses.replace(cfg, period=(BlockSpec(kind="attn", ffn="dense"),),
                                          n_periods=cfg.n_enc_layers, prefix_layers=(),
                                          remainder=())
            self.encoder = bb.Stack(enc_cfg, dtype, device, gen)
            self.enc_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, dtype, device, gen)

    @property
    def device(self) -> torch.device:
        return self.embedding.table.device

    def spec_tree(self) -> dict:
        """``repro``'s ``Model.param_specs()``: the logical axes of every
        parameter, in ``repro``'s tree (scanned periods once per position)."""
        cfg = self.cfg
        tree: dict = {
            # untied input tables shard embed (gather-local); tied tables keep
            # vocab sharding for the dominant unembed product
            "embedding": L.embedding_spec(for_input=not cfg.tie_embeddings),
            "stack": self.stack.spec(),
            "final_norm": L.rmsnorm_spec(),
        }
        if not cfg.tie_embeddings:
            tree["unembed"] = L.embedding_spec()
        if cfg.n_enc_layers:
            tree["encoder"] = self.encoder.spec()
            tree["enc_norm"] = L.rmsnorm_spec()
        if cfg.mtp_depth:
            tree["mtp"] = {
                "proj": ("embed", "embed_out"),
                "block": bb.block_spec_tree(BlockSpec(kind="attn"), cfg),
                "norm_h": L.rmsnorm_spec(),
                "norm_e": L.rmsnorm_spec(),
            }
        return tree

    def param_specs(self) -> dict[str, tuple]:
        """The logical axes of every parameter, keyed by its name in
        ``named_parameters()``: ``repro``'s spec of the same leaf, found
        through ``convert.repro_path`` (each layer of a scanned period takes
        its period position's spec)."""
        tree = self.spec_tree()
        out = {}
        for name, _ in self.named_parameters():
            node = tree
            for key in repro_path(self.cfg, name)[0]:
                node = node[key]
            out[name] = node
        return out

    # -- pieces --------------------------------------------------------------
    def _embed(self, tokens: torch.Tensor, batch: dict | None) -> torch.Tensor:
        cfg = self.cfg
        x = L.embed(self.embedding.table, tokens, cfg.scale_embeddings, cfg.d_model)
        if cfg.frontend == "vision_stub" and batch is not None and "prefix_embeddings" in batch:
            n = cfg.n_prefix_embeddings
            pre = batch["prefix_embeddings"].to(x.dtype)
            x = torch.cat([pre, x[:, n:]], dim=1)
        return x

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Audio stub frontend: frames are precomputed embeddings [B, T, D]."""
        pos = torch.arange(frames.shape[1], device=frames.device).expand(frames.shape[:2])
        h, _, _ = self.encoder(frames.to(L.dt(self.cfg.compute_dtype)), pos)
        return self.enc_norm(h)

    def _unembed(self, h: torch.Tensor) -> torch.Tensor:
        table = self.embedding.table if self.cfg.tie_embeddings else self.unembed.table
        return L.unembed(table, h, self.cfg.final_softcap)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor, caches: dict | None = None,
                batch: dict | None = None, sequential: bool = False):
        """(final-normed hidden states [B, S, D], new caches or None, aux).
        ``batch`` carries the frontends' inputs (``frames``,
        ``prefix_embeddings``: tensors or arrays). ``sequential=True`` runs
        every RWKV-6 and Mamba2 layer's sequential oracle instead of the
        chunked prefill."""
        cfg = self.cfg
        if batch is not None:
            batch = {k: torch.as_tensor(v, device=tokens.device) for k, v in batch.items()}
        x = self._embed(tokens, batch).to(L.dt(cfg.compute_dtype))
        enc_out = None
        if cfg.n_enc_layers and batch is not None and "frames" in batch:
            enc_out = self._encode(batch["frames"])
        elif caches is not None and caches.get("enc_out") is not None:
            enc_out = caches["enc_out"]
        stack_caches = caches["stack"] if caches is not None else None
        h, new_stack_caches, aux = self.stack(x, positions, stack_caches, enc_out, sequential,
                                              self.rwkv_kernel)
        h = self.final_norm(h)
        new_caches = None
        if caches is not None:
            new_caches = dict(caches)
            new_caches["stack"] = new_stack_caches
            if enc_out is not None:
                new_caches["enc_out"] = enc_out
        return h, new_caches, aux

    # -- entry points -----------------------------------------------------------
    def loss(self, batch: dict):
        """``repro``'s ``Model.loss``: (scalar, aux with ``loss``),
        differentiable with respect to the parameters. ``batch`` holds
        ``tokens`` and ``labels`` [B, S], optionally ``mask`` and the
        frontends' inputs (tensors or arrays)."""
        cfg = self.cfg
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        tokens, labels = batch["tokens"].long(), batch["labels"].long()
        pos = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        h, _, aux = self.forward(tokens, pos, None, batch)
        mask = batch.get("mask")
        if self.loss_chunk and tokens.shape[1] % self.loss_chunk == 0:
            total = self._chunked_ce(h, labels, mask)
        else:
            total = cross_entropy(self._unembed(h), labels, mask)
        if cfg.mtp_depth:
            total = total + 0.3 * self._mtp_loss(h, tokens, labels, pos)
        if cfg.n_experts and not cfg.router_aux_free:
            # switch-style aux loss on the mean load imbalance
            load = aux.get("moe_load")
            if load is not None:
                frac = load / torch.clamp_min(load.sum(), 1.0)
                total = total + 1e-2 * cfg.n_experts * torch.sum(frac * frac)
        aux["loss"] = total
        return total, aux

    def _chunked_ce(self, h, labels, mask):
        """Cross-entropy over sequence chunks of ``loss_chunk``: the logits
        live as [B, chunk, V] at a time, never as [B, S, V]."""
        c = self.loss_chunk
        tot = torch.zeros((), device=h.device)
        cnt = torch.zeros((), device=h.device)
        for j in range(h.shape[1] // c):
            sl = slice(j * c, (j + 1) * c)
            logits = self._unembed(h[:, sl])
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[:, sl, None])[..., 0]
            mm = torch.ones_like(lse) if mask is None else mask[:, sl].to(lse.dtype)
            tot = tot + ((lse - gold) * mm).sum()
            cnt = cnt + mm.sum()
        return tot / torch.clamp_min(cnt, 1.0)

    def _mtp_loss(self, h, tokens, labels, pos):
        """DeepSeek-V3 multi-token prediction: predict ``t + 2`` from ``(h_t,
        emb(t+1))``; the last two positions are masked."""
        mtp = self.mtp
        emb_next = self._embed(torch.roll(tokens, -1, dims=1), None).to(h.dtype)
        merged = torch.cat([mtp.norm_h(h), mtp.norm_e(emb_next)], dim=-1)
        hm = L.matmul(merged, mtp.proj)
        hm, _, _ = mtp.block(hm, pos, None)
        logits = self._unembed(hm)
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        mask[:, -2:] = 0.0
        return cross_entropy(logits, torch.roll(labels, -1, dims=1), mask)

    def init_caches(self, batch: int, max_len: int, dtype=None) -> dict:
        """Per-layer caches (attention KV in ``dtype``, the parameter dtype
        by default), and a zero ``enc_out`` for an encoder-decoder."""
        cfg = self.cfg
        dtype = dtype or L.dt(cfg.param_dtype)
        caches = {"stack": self.stack.init_caches(batch, max_len, dtype)}
        if cfg.n_enc_layers:
            caches["enc_out"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dtype,
                                            device=self.device)
        return caches

    def prefill(self, tokens: torch.Tensor, caches: dict, batch: dict | None = None,
                sequential: bool = False, return_aux: bool = False):
        """(logits [B, 1, V] of the last position, caches); with
        ``return_aux``, the forward's ``aux`` third: the MoE counters
        (``moe_load``, ``moe_load_periods`` and, dropless,
        ``moe_dropped`` and ``moe_choices``;
        ``backbone.Stack.forward``), on the device."""
        pos = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
        h, caches, aux = self.forward(tokens, pos, caches, batch, sequential)
        logits = self._unembed(h[:, -1:])
        return (logits, caches, aux) if return_aux else (logits, caches)

    def decode_step(self, tokens: torch.Tensor, pos: torch.Tensor, caches: dict):
        """tokens: [B, 1]; pos: [B, 1] absolute positions."""
        h, caches, _ = self.forward(tokens, pos, caches)
        return self._unembed(h), caches


def build_model(cfg: ModelConfig, device: torch.device | str = "cuda", rwkv_kernel: bool = True,
                seed: int = 0, moe_impl: str = "local", loss_chunk: int = 0,
                requires_grad: bool = False, mesh=None) -> Model:
    """A ``Model`` initialised at random on ``device`` (the card unless the
    caller asks for the CPU) from ``torch.Generator(device).manual_seed(seed)``,
    with the distributions and scales of ``repro``'s init; on ``"meta"``,
    its shapes and dtypes only. Its parameters require gradients only with
    ``requires_grad=True`` (training); by default the model is frozen for
    serving. ``loss_chunk`` is ``repro``'s blockwise cross-entropy chunk.
    ``moe_impl="sharded"`` runs the MoE blocks expert-parallel over ``mesh``
    (a ``distributed.mesh.DeviceMesh``), as ``repro``'s ``build_model(cfg,
    moe_impl="sharded", mesh=...)`` does."""
    model = Model(cfg, resolve_device(device), rwkv_kernel=rwkv_kernel, seed=seed,
                  moe_impl=moe_impl, loss_chunk=loss_chunk, mesh=mesh)
    return model.requires_grad_(requires_grad)
