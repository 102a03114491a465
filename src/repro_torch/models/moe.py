"""Mixture-of-Experts with the DYNAPs two-stage tag dispatch (DESIGN.md §3).

The port of ``repro.models.moe``. The paper's routing scheme applied to
experts: a token with a routing decision is a spiking neuron, the expert id
it emits is its tag, and each expert's fixed-capacity buffer is an AER queue
with FIFO overflow: ``core.two_stage.dispatch_slots`` assigns the slots, the
first ``cap`` assignments of an expert in token order are kept and the rest
dropped.

  * :func:`moe_reference`: every expert computed densely for every token
    (the oracle, small sizes only);
  * :func:`moe_local`: the two-stage dispatch on one device;
  * :func:`moe_dropless`: the same dispatch with no capacity (a
    ``PortModelConfig`` with ``moe_dropless``; DeepSeek-V2-Lite): every
    assignment reaches its expert, the rows sorted by expert and run as one
    grouped GEMM per projection (:func:`grouped_experts_ffn`);
  * :func:`moe_block_sharded` / :func:`moe_sharded`: expert parallelism over
    a :class:`~repro_torch.distributed.mesh.DeviceMesh`. An expert shard is
    the paper's cluster and the expert id within it the tag: stage 1 is an
    ``all_to_all`` of token payloads and tags to their destination shard,
    stage 2 the shard's local dispatch by tag. ``repro`` runs this inside
    ``shard_map``; the port runs each phase for every cell in turn, in bulk
    synchronous steps with the mesh collectives between them, as the sharded
    engine step does (``core.event_engine``).

Routers: softmax top-k (deepseek-moe-16b) and sigmoid + bias aux-free
(deepseek-v3). The router and its bias are float32 whatever the parameter
dtype. Ties in the top-k go to the lower expert id, as ``jax.lax.top_k``
breaks them. The top-k weights are renormalised over the chosen experts
unless the config's ``norm_topk_prob`` option is false (DeepSeek-V2: the raw
softmax probabilities), then times ``routed_scaling_factor``.

Profiler spans (``core/tracing.py``): :func:`moe_local` and
:func:`moe_dropless` open ``repro_torch.moe.dispatch`` around the router,
the top-k, ``dispatch_slots``, the gathers and scatters and the combine,
and ``repro_torch.moe.experts`` around the routed experts' FFN; the block
opens ``repro_torch.moe`` around both and the shared experts.

:func:`aux_loss` is ``repro``'s switch-style balancing loss (``Model.loss``
computes its own load term inline, as ``repro``'s does).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.configs.base import option
from repro_torch.core.tracing import span
from repro_torch.core.two_stage import dispatch_slots
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.models.layers import matmul, normal_param, sigmoid, silu

__all__ = [
    "EXPERT_PARAMS", "MoE", "aux_loss", "ep_axes_for", "expert_capacity", "experts_ffn",
    "grouped_experts_ffn", "moe_block_sharded", "moe_dropless", "moe_local", "moe_reference",
    "moe_sharded", "moe_spec", "route",
]

EXPERT_PARAMS = ("wi_gate", "wi_up", "wo")  # [E, ...]: cut over the EP axes


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """The parameters of ``repro.models.moe.init_moe``, under its names."""

    def __init__(self, cfg, dtype, device, gen: torch.Generator):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        s_in, s_out = d**-0.5, f**-0.5
        self.router = normal_param((d, e), torch.float32, s_in, gen, device)
        self.router_bias = nn.Parameter(torch.zeros(e, dtype=torch.float32, device=device))
        self.wi_gate = normal_param((e, d, f), dtype, s_in, gen, device)
        self.wi_up = normal_param((e, d, f), dtype, s_in, gen, device)
        self.wo = normal_param((e, f, d), dtype, s_out, gen, device)


def moe_spec(cfg) -> dict:
    return {
        "router": ("embed", None),
        "router_bias": (None,),
        "wi_gate": ("experts", "embed", "mlp"),
        "wi_up": ("experts", "embed", "mlp"),
        "wo": ("experts", "mlp", "embed"),
    }


# ---------------------------------------------------------------------------
# routing decisions (which tag does each token emit?)
# ---------------------------------------------------------------------------
def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves ties open)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(params: MoE, x: torch.Tensor, cfg):
    """x: [T, D] -> (top_idx [T, k] int64, top_w [T, k] float32, load [E] float32).

    Aux-free: experts chosen by sigmoid(score) + bias, weights the unbiased
    sigmoid scores. The weights are renormalised over the chosen experts
    unless ``norm_topk_prob`` is false, then scaled by
    ``routed_scaling_factor``."""
    scores = matmul(x.float(), params.router)
    if cfg.router_aux_free:
        affinity = sigmoid(scores)
        _, top_idx = _top_k(affinity + params.router_bias[None, :], cfg.top_k)
        top_w = torch.gather(affinity, 1, top_idx)
    else:
        probs = torch.softmax(scores, dim=-1)
        top_w, top_idx = _top_k(probs, cfg.top_k)
    if option(cfg, "norm_topk_prob"):
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    if option(cfg, "routed_scaling_factor") != 1.0:
        top_w = top_w * option(cfg, "routed_scaling_factor")
    return top_idx, top_w, _counts(top_idx, cfg.n_experts)


def _counts(top_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert, float32 [E]."""
    flat = top_idx.reshape(-1)
    # index_add_ of ones, not bincount: bincount waits for the device to size its output
    return torch.zeros(n_experts, dtype=torch.float32, device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=flat.device))


def aux_loss(params: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing loss: ``E * sum(frac * importance)``, with
    ``frac`` the share of the softmax top-k assignments each expert gets and
    ``importance`` its mean router probability. x: [T, D]."""
    probs = torch.softmax(matmul(x.float(), params.router), dim=-1)
    _, top_idx = _top_k(probs, cfg.top_k)
    frac = _counts(top_idx, cfg.n_experts) / (x.shape[0] * cfg.top_k)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))


# ---------------------------------------------------------------------------
# expert compute
# ---------------------------------------------------------------------------
def experts_ffn(params: MoE, buf: torch.Tensor) -> torch.Tensor:
    """buf: [E, cap, D] -> the same shape through each expert's gated FFN
    (``einsum("ecd,edf->ecf")`` as batched products)."""
    gate = matmul(buf, params.wi_gate)
    up = matmul(buf, params.wi_up)
    return matmul(silu(gate) * up, params.wo)


# ---------------------------------------------------------------------------
# two-stage dispatch on one device
# ---------------------------------------------------------------------------
def expert_capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens: ``max(8, int(t * k / E * capacity_factor))``."""
    return max(8, int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def moe_local(params: MoE, x: torch.Tensor, cfg, capacity: int | None = None):
    """Two-stage dispatch on one device. x: [T, D] -> ([T, D], {"load": [E]}).

    Every expert runs its whole buffer of ``cap`` slots, empty slots
    included, as ``repro`` does. A dropped assignment adds nothing to its
    token; the token's ``k`` weighted expert outputs are summed in ``x``'s
    dtype in order of their rank."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity or expert_capacity(cfg, t)
    with span("repro_torch.moe.dispatch"):
        top_idx, top_w, load = route(params, x, cfg)
        flat_e = top_idx.reshape(-1)  # [T*k]: the emitted tag stream
        slot, keep = dispatch_slots(flat_e, e, cap)
        token_of = torch.arange(t, device=x.device).repeat_interleave(k)
        # dropped assignments go to a sentinel row past the buffers (repro's
        # scatter to e * cap with mode="drop"); kept slots are distinct
        buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
        buf.index_copy_(0, torch.where(keep, slot, e * cap).long(), x[token_of])
    with span("repro_torch.moe.experts"):
        out_buf = experts_ffn(params, buf[:-1].reshape(e, cap, d)).reshape(e * cap, d)
    with span("repro_torch.moe.dispatch"):
        gathered = out_buf[slot.clamp_min(0).long()] * keep[:, None].to(x.dtype)
        return _rank_sum(gathered, top_w.to(x.dtype), t, k), {"load": load}


def _rank_sum(gathered: torch.Tensor, top_w: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Each token's ``k`` expert outputs ``gathered [T*k, D]`` (token-major)
    times their weights ``top_w [T, k]``, summed in order of their rank."""
    terms = (gathered * top_w.reshape(-1)[:, None]).reshape(t, k, -1)
    y = terms[:, 0]
    for j in range(1, k):
        y = y + terms[:, j]
    return y


def grouped_experts_ffn(params: MoE, rows: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """rows: [A, D] sorted by expert, expert ``i``'s rows from ``ends[i - 1]``
    (0 for the first) to ``ends[i]`` (int64 [E], on the device) -> [A, D],
    each row through its expert's gated FFN: each projection one
    ``torch._grouped_mm`` over every expert, with the offsets on the device,
    so nothing waits for the host."""
    offs = ends.to(torch.int32)
    gate = torch._grouped_mm(rows, params.wi_gate, offs=offs)
    up = torch._grouped_mm(rows, params.wi_up, offs=offs)
    return torch._grouped_mm(silu(gate) * up, params.wo, offs=offs)


def moe_dropless(params: MoE, x: torch.Tensor, cfg):
    """Dropless two-stage dispatch on one device. x: [T, D] -> ([T, D],
    {"load": [E] float32, "dropped": float32 scalar, "choices": [T, k] int64}).

    ``dispatch_slots`` ranks each assignment within its expert in stable
    token order, as in :func:`moe_local`, with bins of ``T`` slots: a token
    emits ``k`` distinct tags, so no bin overflows and ``dropped`` (counted
    from the dispatch's own ``keep``) is 0. Each assignment's row in the
    expert-sorted buffer is its expert's start (the load's exclusive
    cumsum, on the device) plus its rank; :func:`grouped_experts_ffn` runs
    the buffer, and each token sums its ``k`` weighted outputs in order of
    rank. ``choices`` are the routed experts, best first."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    with span("repro_torch.moe.dispatch"):
        top_idx, top_w, load = route(params, x, cfg)
        flat_e = top_idx.reshape(-1)  # [T*k]: the emitted tag stream
        slot, keep = dispatch_slots(flat_e, e, t)
        ends = torch.cumsum(load.long(), 0)
        row = (ends - load.long())[flat_e] + slot.long() - flat_e * t
        token_of = torch.arange(t, device=x.device).repeat_interleave(k)
        source = torch.empty_like(token_of).index_copy_(0, row, token_of)
        rows = x[source]
    with span("repro_torch.moe.experts"):
        out = grouped_experts_ffn(params, rows, ends)
    with span("repro_torch.moe.dispatch"):
        y = _rank_sum(out[row], top_w.to(x.dtype), t, k)
        dropped = (t * k - keep.sum()).float()
    return y, {"load": load, "dropped": dropped, "choices": top_idx}


def moe_reference(params: MoE, x: torch.Tensor, cfg):
    """Oracle: every expert computed densely for every token (small sizes only)."""
    t, d = x.shape
    top_idx, top_w, load = route(params, x, cfg)
    combine = torch.zeros((t, cfg.n_experts), dtype=torch.float32, device=x.device)
    combine.scatter_add_(1, top_idx, top_w)
    all_out = experts_ffn(params, x[None].expand(cfg.n_experts, t, d))
    y = torch.einsum("te,etd->td", combine, all_out.float()).to(x.dtype)
    return y, {"load": load}


# ---------------------------------------------------------------------------
# expert parallelism over a device mesh
# ---------------------------------------------------------------------------
def _scatter_rows(rows: torch.Tensor, idx: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``[n, ...]`` of ``fill`` with ``rows[a]`` at row ``idx[a]``; an index
    of ``n`` (a dropped row) lands on a sentinel row that is cut off. Kept
    indices are distinct, so this is ``repro``'s scatter into zeros (or
    into -1 for the tags)."""
    out = torch.full((n + 1, *rows.shape[1:]), fill, dtype=rows.dtype, device=rows.device)
    return out.index_copy(0, idx.long(), rows)[:-1]


def _pack(params, x: torch.Tensor, cfg, tp: int, cap_send: int, owned):
    """Phase 1 of one cell: route its tokens and pack the per-destination
    send buffers. Returns the ``[tp, cap_send, D]`` payloads, the
    ``[tp, cap_send]`` tags (-1 where empty), what the combine needs
    (``slot``, ``keep``, ``top_w``) and the cell's emitted load ``[E]``."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_local = e // tp
    top_idx, top_w, _ = route(params, x, cfg)
    flat_e = top_idx.reshape(-1)  # [T*k]: the emitted tag stream
    if owned is not None:
        flat_e = torch.where(owned.repeat_interleave(k), flat_e, -1)
    # load counts only the assignments this cell emits (exact once summed)
    emitted = flat_e >= 0
    load = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_e.clamp_min(0), emitted.float())
    dest = torch.where(emitted, flat_e // e_local, -1)  # the destination shard
    tag = flat_e % e_local  # the expert within it
    slot, keep = dispatch_slots(torch.where(emitted, dest, tp), tp, cap_send)
    keep = keep & emitted
    token_of = torch.arange(t, device=x.device).repeat_interleave(k)
    drop = tp * cap_send
    idx = torch.where(keep, slot, drop)
    payload = _scatter_rows(x[token_of], idx, drop).reshape(tp, cap_send, d)
    tags = _scatter_rows(torch.where(keep, tag, -1).to(torch.int32), idx, drop,
                         fill=-1).reshape(tp, cap_send)
    return payload, tags, (slot, keep, top_w), load


def _expert_pass(params, ev_x: torch.Tensor, ev_tag: torch.Tensor, e_local: int,
                 cap_recv: int):
    """Phase 3 of one cell: the received events dispatched by tag into its
    experts' buffers and through them; each event picks its result back up
    (zero where it was dropped). Returns (results, events dispatched)."""
    n, d = ev_x.shape
    valid = ev_tag >= 0
    slot2, keep2 = dispatch_slots(torch.where(valid, ev_tag, e_local), e_local, cap_recv)
    keep2 = keep2 & valid
    drop2 = e_local * cap_recv
    buf = _scatter_rows(ev_x, torch.where(keep2, slot2, drop2), drop2)
    out_buf = experts_ffn(params, buf.reshape(e_local, cap_recv, d)).reshape(drop2, d)
    ev_out = out_buf[slot2.clamp_min(0).long()] * keep2[:, None].to(ev_x.dtype)
    return ev_out, keep2.sum()


def _combine(back: torch.Tensor, slot, keep, top_w, t: int, k: int) -> torch.Tensor:
    """Phase 5 of one cell: each token's ``k`` weighted results summed in
    rank order, as :func:`moe_local` sums them."""
    gathered = back[slot.clamp_min(0).long()] * keep[:, None].to(back.dtype)
    return _rank_sum(gathered, top_w.to(back.dtype), t, k)


def moe_sharded(params: dict, x: dict, cfg, mesh, axis="model", owned: dict | None = None):
    """Expert-parallel dispatch over ``mesh``, every cell at once.

    ``params[cell]`` holds (as attributes, like :class:`MoE`) the cell's
    router and router bias (whole) and its slab of the experts (``[E / tp,
    ...]``: experts ``[r * E / tp, (r + 1) * E / tp)`` for the cell of rank
    ``r`` along ``axis``, a mesh axis or a tuple: ``("data", "model")`` is
    EP over both); ``x[cell]`` its tokens
    ``[t, D]``; ``owned[cell]`` (optional, bool ``[t]``) the tokens the cell
    dispatches, when tokens are replicated over part of the EP axes. Runs
    ``repro``'s ``moe_sharded`` in five bulk-synchronous phases: every cell
    routes and packs its send buffers; ``all_to_all`` over each EP group;
    every cell dispatches what it received by tag and runs its experts;
    ``all_to_all`` back; every cell combines its tokens' results. Returns
    ``({cell: y [t, D]}, {cell: {"load": [E], "dispatched": events that
    reached an expert slot}})``.
    """
    tp = mesh.axes_size(axis)
    e, k = cfg.n_experts, cfg.top_k
    e_local = e // tp
    t = next(iter(x.values())).shape[0]
    cap_send = max(8, int(t * k / tp * cfg.capacity_factor))
    cap_recv = max(8, int(t * k / e_local * cfg.capacity_factor))
    d = next(iter(x.values())).shape[1]
    cells = mesh.cells()
    # each cell's parameters as a dict, so a meta mesh's representative cell
    # takes (and differentiates) its tensors
    cp = {c: dict(vars(params[c])) for c in cells}
    packed = mesh.map_cells(
        lambda p, xx, own: _pack(SimpleNamespace(**p), xx, cfg, tp, cap_send, own),
        {c: (cp[c], x[c], None if owned is None else owned[c]) for c in cells})
    recv_x = _exchange(mesh, axis, {c: packed[c][0] for c in cells})
    recv_tag = _exchange(mesh, axis, {c: packed[c][1] for c in cells})
    passed = mesh.map_cells(
        lambda p, rx, rt: _expert_pass(SimpleNamespace(**p), rx.reshape(tp * cap_send, d),
                                       rt.reshape(tp * cap_send), e_local, cap_recv),
        {c: (cp[c], recv_x[c], recv_tag[c]) for c in cells})
    back = _exchange(mesh, axis, _each({c: passed[c][0] for c in cells},
                                       lambda o: o.reshape(tp, cap_send, d)))
    y = mesh.map_cells(lambda b, sends: _combine(b.reshape(tp * cap_send, d), *sends, t, k),
                       {c: (back[c], packed[c][2]) for c in cells})
    return y, {c: {"load": packed[c][3], "dispatched": passed[c][1]} for c in cells}


def _each(parts: dict, fn) -> dict:
    """``fn`` of every cell's value, once per distinct tensor (a meta mesh
    holds one tensor for every cell)."""
    memo: dict[int, object] = {}
    out = {}
    for cell, v in parts.items():
        if id(v) not in memo:
            memo[id(v)] = fn(v)
        out[cell] = memo[id(v)]
    return out


def _exchange(mesh, axis, parts: dict) -> dict:
    """``all_to_all`` of every cell's ``[tp, ...]`` buffer over its EP group
    (split and joined on dim 0, untiled): row ``i`` of what a cell receives
    is what the group's cell ``i`` packed for it."""
    out = {}
    for group in mesh.groups(axis):
        for cell, got in zip(group, mesh_mod.all_to_all([parts[c] for c in group], 0, 0)):
            out[cell] = got
    return out


def ep_axes_for(cfg, mesh, model_axis: str = "model") -> tuple[str, ...]:
    """The EP mesh axes: the resolution rule of the expert weights
    (``distributed.sharding.RULES["experts"]``), so dispatch matches
    storage; ``()`` when no candidate divides the experts."""
    for cand in (("data", model_axis), (model_axis,), ("data",)):
        if all(a in mesh.shape for a in cand):
            size = math.prod(mesh.shape[a] for a in cand)
            if size > 1 and cfg.n_experts % size == 0:
                return cand
    return ()


def moe_block_sharded(params: MoE, x3: torch.Tensor, cfg, mesh, model_axis: str = "model"):
    """x3: [B, S, D] (global) -> ([B, S, D], {"load": [E], "dispatched"}).

    ``repro``'s ``moe_block_sharded``. The activation layout adapts to the
    shape: tokens split over the batch axes that divide B and, when S
    divides the model axis (train, prefill), the sequence over ``model``, so
    every cell dispatches a distinct slab; otherwise (decode) tokens are
    replicated over the EP axes the activations leave free, each replica
    dispatches its strided ``owned`` share and the outputs are summed over
    those axes. ``load`` is every cell's emitted count summed and divided by
    the number of identical replicas (mesh axes neither EP nor used by the
    activations): bit-equal to ``repro``'s. Expert weights are cut ``P(ep)``
    (views when the mesh's devices are the weights'); the router and its
    bias are whole on every cell. The EP exchange never crosses the pod
    axis. A mesh with no EP axis dispatches with :func:`moe_local`."""
    ep = ep_axes_for(cfg, mesh, model_axis)
    b, s, d = x3.shape
    if not ep:  # a tiny config or a one-cell mesh: local dispatch
        y, aux = moe_local(params, x3.reshape(b * s, d), cfg)
        return y.reshape(b, s, d), aux
    s_shardable = s % mesh.shape[model_axis] == 0 and s > 1
    # batch sharding: as many of (pod, data) as divide B
    b_axes = [a for a in ("pod", "data") if a in mesh.shape]
    while b_axes and b % mesh.axes_size(b_axes) != 0:
        b_axes.pop(0)
    b_entry = tuple(b_axes) if b_axes else None
    if s_shardable:
        act_used = set(b_axes) | {model_axis}
        in_x = mesh_mod.P(b_entry, model_axis, None)
    else:
        act_used = set(b_axes)
        in_x = mesh_mod.P(b_entry, None, None)
    rep_axes = tuple(a for a in ep if a not in act_used)
    # non-EP axes over which tokens are replicated run identical dispatches
    # (data-parallel replicas): their multiplicity is divided out of the load
    dup = math.prod(mesh.shape[a] for a in mesh.axis_names if a not in ep and a not in act_used)

    x_sharding = mesh_mod.NamedSharding(mesh, in_x)
    slabs = x_sharding.shard(x3)
    xs = _each(slabs, lambda slab: slab.reshape(-1, d))
    experts = {name: mesh_mod.NamedSharding(mesh, mesh_mod.P(ep)).shard(getattr(params, name))
               for name in EXPERT_PARAMS}
    # the router and its bias whole on every cell: their gradients sum over
    # the mesh, as repro's shard_map sums those of a replicated input
    whole = {name: mesh_mod.NamedSharding(mesh, mesh_mod.P()).shard(getattr(params, name))
             for name in ("router", "router_bias")}
    cell_params = {cell: SimpleNamespace(
        **{name: whole[name][cell] for name in whole},
        **{name: experts[name][cell] for name in EXPERT_PARAMS}) for cell in mesh.cells()}
    owned = None
    if rep_axes:
        n_rep = mesh.axes_size(rep_axes)
        owned = mesh.map_cells(
            lambda xx, rank: torch.arange(xx.shape[0], device=xx.device) % n_rep == rank,
            {cell: (xs[cell], mesh.index(cell, rep_axes)) for cell in mesh.cells()})
    ys, auxes = moe_sharded(cell_params, xs, cfg, mesh, axis=ep, owned=owned)
    if rep_axes:
        for group in mesh.groups(rep_axes):
            for cell, total in zip(group, mesh_mod.psum([ys[c] for c in group])):
                ys[cell] = total
    cells = mesh.cells()
    # the exact global load: every cell's emitted counts, de-duplicated
    load = mesh_mod.psum([auxes[c]["load"] for c in cells])[0] / dup
    # a diagnostic repro does not have: summed on the home device, no collective
    dispatched = torch.stack([auxes[c]["dispatched"].to(x3.device) for c in cells])
    dispatched = dispatched.float().sum() / dup
    slab_shape = next(iter(slabs.values())).shape
    y = x_sharding.unshard(_each(ys, lambda yy: yy.reshape(slab_shape)), x3.device)
    return y, {"load": load.to(x3.device), "dispatched": dispatched.to(x3.device)}
