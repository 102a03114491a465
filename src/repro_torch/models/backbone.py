"""Block stack: the port of ``repro.models.backbone``.

``repro`` builds a model as ``prefix_layers`` (unrolled), ``n_periods``
repetitions of ``period`` (one ``lax.scan`` over parameters stacked along a
leading ``[n_periods]`` axis) and ``remainder`` (unrolled). The port unrolls
the scan: ``Stack`` holds ``n_layers`` blocks in that order, layer
``len(prefix) + p * len(period) + i`` being block ``i`` of period ``p``,
and its forward is a Python loop. Caches are a list with one dict per layer.

Blocks of every kind are ported: ``attn`` (with its sliding window),
``mla``, ``mamba2`` and ``rwkv6``, each with a dense, MoE (plus shared
experts) or no FFN, ``post_block_norm`` and cross-attention to an encoder's
output. A ``shared`` period block (zamba2) is one parameter set,
``stack.shared_block`` as in ``repro``'s tree, applied at every period
position marked ``shared``; each application keeps its own cache in the
per-layer list, as ``repro`` stacks the shared slot's cache per period.
Without caches, each period may run under activation checkpointing
(``cfg.remat``), as ``repro``'s scan body runs under ``jax.checkpoint``.
A MoE block dispatches with ``moe_local`` (``moe_impl="local"``) or, with
``moe_impl="sharded"`` and a ``mesh``, with the expert-parallel
``moe_block_sharded`` (``repro``'s ``apply_block`` chooses the same way); a
config with the ``moe_dropless`` option (``configs.base.PortModelConfig``)
dispatches with ``moe_dropless``, on one device only. The MoE FFN, shared
experts included, runs inside the profiler span ``repro_torch.moe``.

:func:`block_spec_tree` and :meth:`Stack.spec` give ``repro``'s tree of
logical axes for the stack's parameters: ``periods/b{i}`` once per period
position (its leaves stacked over the periods in ``repro``), ``prefix{i}``,
``remainder{i}`` and ``shared_block``.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig, option
from repro_torch.core import cost_hook
from repro_torch.core.tracing import span
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MLP, RMSNorm, dt, mlp, mlp_spec, rmsnorm_spec

__all__ = ["Block", "Stack", "block_spec_tree", "check_moe_impl", "init_block_cache"]

MOE_IMPLS = ("local", "sharded")


def check_moe_impl(moe_impl: str, mesh, cfg: ModelConfig | None = None) -> None:
    """Raise ``ValueError`` for an unknown ``moe_impl``, ``"sharded"``
    without a mesh to shard the experts over, or ``"sharded"`` for a
    dropless config (the expert-parallel exchange has fixed capacities)."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl={moe_impl!r}; have {MOE_IMPLS}")
    if moe_impl == "sharded" and mesh is None:
        raise ValueError('moe_impl="sharded" needs a mesh (distributed.mesh.make_mesh)')
    if moe_impl == "sharded" and cfg is not None and option(cfg, "moe_dropless"):
        raise ValueError(f'{cfg.name} dispatches dropless: moe_impl="sharded" has capacities')


def block_spec_tree(spec: BlockSpec, cfg: ModelConfig, cross: bool = False) -> dict:
    """The logical axes of one block's parameters, under their names."""
    p: dict = {"pre_norm": rmsnorm_spec()}
    if spec.kind == "attn":
        p["inner"] = attn_mod.attention_spec(cfg)
    elif spec.kind == "mla":
        p["inner"] = mla_mod.mla_spec(cfg)
    elif spec.kind == "mamba2":
        p["inner"] = ssm_mod.mamba2_spec(cfg)
    elif spec.kind == "rwkv6":
        p["inner"] = rwkv_mod.rwkv6_spec(cfg)
    if cross:
        p["cross_norm"] = rmsnorm_spec()
        p["cross"] = attn_mod.attention_spec(cfg)
    if cfg.post_block_norm:
        p["post_norm"] = rmsnorm_spec()
    if spec.ffn != "none":
        p["ffn_norm"] = rmsnorm_spec()
        p["ffn"] = mlp_spec() if spec.ffn == "dense" else moe_mod.moe_spec(cfg)
        if spec.ffn == "moe" and cfg.n_shared_experts:
            p["ffn_shared"] = mlp_spec()
        if cfg.post_block_norm:
            p["ffn_post_norm"] = rmsnorm_spec()
    return p


def init_block_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device) -> dict[str, torch.Tensor]:
    """A KV ring for an attention block (``min(window, max_len)`` slots), the
    latent ring for an MLA block (``max_len`` slots), both in ``dtype``; the
    float32 state for a Mamba2 or an RWKV-6 block."""
    if spec.kind == "attn":
        return attn_mod.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim, spec.window,
                                      dtype, device)
    if spec.kind == "mla":
        return mla_mod.init_mla_cache(batch, max_len, cfg, dtype, device)
    if spec.kind == "mamba2":
        return ssm_mod.init_mamba2_state(batch, cfg, device)
    return rwkv_mod.init_state(batch, cfg, device)


class Block(nn.Module):
    """pre_norm -> inner -> [post_norm] -> residual; [cross_norm -> cross
    attention -> residual]; ffn_norm -> ffn (+ shared experts) ->
    [ffn_post_norm] -> residual. ``repro``'s ``init_block`` /
    ``apply_block``, with its parameter names. A MoE FFN dispatches as
    ``moe_impl`` says, over ``mesh`` when sharded."""

    def __init__(self, spec: BlockSpec, cfg: ModelConfig, dtype, device, gen: torch.Generator,
                 cross: bool = False, moe_impl: str = "local", mesh=None):
        super().__init__()
        check_moe_impl(moe_impl, mesh, cfg)
        self.spec = spec
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.mesh = mesh
        d = cfg.d_model
        self.pre_norm = RMSNorm(d, cfg.norm_eps, device)
        if spec.kind == "attn":
            self.inner = attn_mod.Attention(cfg, dtype, device, gen)
        elif spec.kind == "mla":
            self.inner = mla_mod.MLA(cfg, dtype, device, gen)
        elif spec.kind == "mamba2":
            self.inner = ssm_mod.Mamba2(cfg, dtype, device, gen)
        else:
            self.inner = rwkv_mod.RWKV6(cfg, dtype, device, gen)
        if cross:
            self.cross_norm = RMSNorm(d, cfg.norm_eps, device)
            self.cross = attn_mod.Attention(cfg, dtype, device, gen)
        if cfg.post_block_norm:
            self.post_norm = RMSNorm(d, cfg.norm_eps, device)
        if spec.ffn != "none":
            self.ffn_norm = RMSNorm(d, cfg.norm_eps, device)
            if spec.ffn == "dense":
                self.ffn = MLP(d, cfg.d_ff, dtype, device, gen)
            else:
                self.ffn = moe_mod.MoE(cfg, dtype, device, gen)
                if cfg.n_shared_experts:
                    self.ffn_shared = MLP(d, cfg.n_shared_experts * cfg.moe_d_ff, dtype, device,
                                          gen)
            if cfg.post_block_norm:
                self.ffn_post_norm = RMSNorm(d, cfg.norm_eps, device)

    def forward(self, x, positions, cache: dict | None, enc_out=None, sequential: bool = False,
                use_kernel: bool = False):
        """(x, new cache or {}, aux). ``aux`` holds ``moe_load`` [E] for a MoE
        block, and for a dropless one ``moe_dropped`` (a scalar) and
        ``moe_choices`` [B * S, k]. ``sequential`` reaches Mamba2 and RWKV-6
        blocks (their sequential oracles), ``use_kernel`` RWKV-6 blocks only."""
        spec, cfg = self.spec, self.cfg
        aux = {}
        h = self.pre_norm(x)
        if spec.kind == "attn":
            out, new_cache = attn_mod.attention_layer(self.inner, h, positions, cfg,
                                                      window=spec.window, cache=cache or None)
        elif spec.kind == "mla":
            out, new_cache = mla_mod.mla_layer(self.inner, h, positions, cfg, cache or None)
        elif spec.kind == "mamba2":
            out, new_cache = self.inner(h, cache or None, sequential)
        else:
            out, new_cache = self.inner(h, cache or None, sequential, use_kernel)
        if cfg.post_block_norm:
            out = self.post_norm(out)
        x = x + out

        if hasattr(self, "cross") and enc_out is not None:
            hc = self.cross_norm(x)
            ck = attn_mod.project_heads(enc_out, self.cross.wk)
            cv = attn_mod.project_heads(enc_out, self.cross.wv)
            out, _ = attn_mod.attention_layer(self.cross, hc, positions, cfg, window=None,
                                              cross_kv=(ck, cv))
            x = x + out

        if spec.ffn != "none":
            h2 = self.ffn_norm(x)
            if spec.ffn == "dense":
                out2 = mlp(self.ffn, h2)
            else:
                with span("repro_torch.moe"):
                    out2 = self._moe(h2, aux)
            if cfg.post_block_norm:
                out2 = self.ffn_post_norm(out2)
            x = x + out2
        return x, ({} if new_cache is None else new_cache), aux

    def _moe(self, h2, aux: dict):
        """The MoE FFN of ``h2 [B, S, D]``, shared experts included; its
        counters go into ``aux``."""
        cfg = self.cfg
        if self.moe_impl == "sharded":
            out2, moe_aux = moe_mod.moe_block_sharded(self.ffn, h2, cfg, self.mesh)
        else:
            b, s, d = h2.shape
            dispatch = moe_mod.moe_dropless if option(cfg, "moe_dropless") else moe_mod.moe_local
            y, moe_aux = dispatch(self.ffn, h2.reshape(b * s, d), cfg)
            out2 = y.reshape(b, s, d)
        aux["moe_load"] = moe_aux["load"]
        if "dropped" in moe_aux:
            aux["moe_dropped"] = moe_aux["dropped"]
            aux["moe_choices"] = moe_aux["choices"]
        if cfg.n_shared_experts:
            out2 = out2 + mlp(self.ffn_shared, h2)
        return out2


class Stack(nn.Module):
    """The ``n_layers`` blocks of one model, in order: prefix, periods,
    remainder. Indexing, ``len`` and iteration run over the layers, the
    shared block at each of its applications. Each block is registered
    once: layer ``i`` as child ``"i"``, the shared block as
    ``"shared_block"`` (its layers have no child of their own), so
    ``state_dict()`` and ``parameters()`` both hold its parameters once."""

    def __init__(self, cfg: ModelConfig, dtype, device, gen: torch.Generator, cross: bool = False,
                 moe_impl: str = "local", mesh=None):
        super().__init__()
        self.cfg = cfg
        self.cross = cross
        specs = (*cfg.prefix_layers, *cfg.period * cfg.n_periods, *cfg.remainder)
        shared = [spec for spec in cfg.period if spec.shared]
        if shared:
            self.shared_block = Block(shared[0], cfg, dtype, device, gen, cross, moe_impl, mesh)
        layers = []
        for i, spec in enumerate(specs):
            if spec.shared:
                layers.append(self.shared_block)
            else:
                layers.append(Block(spec, cfg, dtype, device, gen, cross, moe_impl, mesh))
                self.add_module(str(i), layers[-1])
        self._layers = tuple(layers)  # a tuple is not registered: the blocks are, once each

    def __len__(self) -> int:
        return len(self._layers)

    def __iter__(self):
        return iter(self._layers)

    def __getitem__(self, i: int) -> Block:
        return self._layers[i]

    def spec(self) -> dict:
        """``repro``'s ``Stack.spec()``: the logical axes of the stack's
        parameters in ``repro``'s tree (``periods/b{i}`` for each unshared
        period position, ``shared_block``, ``prefix{i}``, ``remainder{i}``)."""
        cfg = self.cfg
        tree: dict = {"periods": {f"b{i}": block_spec_tree(b, cfg, self.cross)
                                  for i, b in enumerate(cfg.period) if not b.shared}}
        shared = [b for b in cfg.period if b.shared]
        if shared:
            tree["shared_block"] = block_spec_tree(shared[0], cfg, self.cross)
        for name, blocks in (("prefix", cfg.prefix_layers), ("remainder", cfg.remainder)):
            for i, b in enumerate(blocks):
                tree[f"{name}{i}"] = block_spec_tree(b, cfg, self.cross)
        return tree

    def init_caches(self, batch: int, max_len: int, dtype=None) -> list[dict[str, torch.Tensor]]:
        """One cache per layer, a shared block's applications each their own:
        a KV ring for attention and the latent ring for MLA (in ``dtype``,
        the parameter dtype by default), the float32 state for Mamba2 and
        RWKV-6."""
        device = self[0].pre_norm.scale.device
        dtype = dtype or dt(self.cfg.param_dtype)
        return [init_block_cache(block.spec, self.cfg, batch, max_len, dtype, device)
                for block in self]

    def forward(self, x, positions, caches: list | None = None, enc_out=None,
                sequential: bool = False, use_kernel: bool = False):
        """``repro``'s ``Stack.apply``: (x, new caches or None, aux). ``aux``
        holds, when the stack has MoE blocks, ``moe_load`` [E] summed over
        every layer and ``moe_load_periods`` [n_periods, E], each period's
        MoE blocks summed; when they dispatch dropless, also each MoE
        layer's ``moe_dropped`` [n_moe_layers] and ``moe_choices``
        [n_moe_layers, B * S, k], in order.

        With no caches and gradients on, each period runs under
        ``torch.utils.checkpoint`` when ``cfg.remat`` is not ``"none"``:
        its activations are recomputed in the backward, as ``repro`` wraps
        its scanned period in ``jax.checkpoint`` (``"dots"`` recomputes the
        whole period too)."""
        cfg = self.cfg
        n_pre, n_p = len(cfg.prefix_layers), len(cfg.period)
        remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()
        new_caches = [] if caches is not None else None
        total = None  # every layer's MoE load
        period_loads: list[torch.Tensor | None] = []
        # a dropless MoE layer's counters, in order of the layers
        per_layer = {"moe_dropped": [], "moe_choices": []}

        def run(x, lo: int, hi: int, enc_out=enc_out):
            """Layers ``lo`` to ``hi - 1``: (x, their MoE loads summed or None)."""
            load = None
            for i in range(lo, hi):
                x, nc, block_aux = self[i](x, positions, caches[i] if caches is not None else None,
                                           enc_out, sequential, use_kernel)
                if caches is not None:
                    new_caches.append(nc)
                if "moe_load" in block_aux:
                    load = block_aux["moe_load"] if load is None else load + block_aux["moe_load"]
                for key, got in per_layer.items():
                    if key in block_aux:
                        got.append(block_aux[key])
            return x, load

        def run_period(x, lo: int, hi: int, enc_out=enc_out):
            if remat:
                return checkpoint(run, x, lo, hi, enc_out, use_reentrant=False)
            return run(x, lo, hi, enc_out)

        groups = [(i, i + 1) for i in range(n_pre)]
        groups += [(n_pre + p * n_p, n_pre + (p + 1) * n_p) for p in range(cfg.n_periods)]
        groups += [(i, i + 1) for i in range(n_pre + cfg.n_periods * n_p, len(self))]
        # on the meta device (the dry run) the periods are the same shapes
        # alone: the first stands for every one, as repro's scan body does
        stand_in = x.device.type == "meta" and cfg.n_periods > 1
        for lo, hi in groups:
            period = n_pre <= lo < n_pre + cfg.n_periods * n_p
            if period and stand_in and lo > n_pre:  # the first period stood in
                ran = [t for i in range(n_pre, n_pre + n_p) for t in self[i].parameters()]
                ran_for = [t for i in range(lo, hi) for t in self[i].parameters()]
                if caches is not None:
                    new_caches.extend(caches[lo:hi])
                    ran += [t for c in caches[n_pre:n_pre + n_p] for t in c.values()]
                    ran_for += [t for c in caches[lo:hi] for t in c.values()]
                cost_hook.reads_as(ran, ran_for)
            elif period and stand_in:
                params = {id(p): p for i in range(lo, hi) for p in self[i].parameters()}
                x, load = cost_hook.stand_in(lambda x, *enc: run_period(x, lo, hi, *enc),
                                             cfg.n_periods, [x, *([enc_out] if enc_out is not None
                                                                  else [])],
                                             list(params.values()))
            elif period:
                x, load = run_period(x, lo, hi)
            else:
                x, load = run(x, lo, hi)
            if period:
                period_loads.append(load)
            if load is not None:
                total = load if total is None else total + load
        aux: dict[str, torch.Tensor] = {}
        if total is not None:
            aux["moe_load"] = total
        if any(load is not None for load in period_loads):
            aux["moe_load_periods"] = torch.stack(period_loads)
        for key, got in per_layer.items():
            if got:
                aux[key] = torch.stack(got)
        return x, new_caches, aux
