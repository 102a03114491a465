"""Carry routing tables, neuron parameters, neuron state, LM weights and LM
train states across from ``repro``, and LM weights back.

The functions read plain numpy arrays and dataclass fields, so they work on
``repro`` objects without importing ``repro`` (or JAX): tests use them to
feed both packages the same network, state and weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.core.tags import RoutingTables

__all__ = [
    "carry_from_numpy", "lm_params_from_numpy", "lm_params_to_numpy", "params_from_jax",
    "repro_ndim", "repro_path", "state_from_numpy", "tables_from_numpy", "train_state_from_numpy",
]


def tables_from_numpy(tables) -> RoutingTables:
    """The port's :class:`RoutingTables` from any object with ``repro``'s
    table fields (``src_tag``, ``src_dest``, ``cam_tag``, ``cam_syn``,
    ``cluster_size``, ``k_tags``, ``tile_of_cluster``)."""
    placement = getattr(tables, "tile_of_cluster", None)
    return RoutingTables(
        src_tag=np.asarray(tables.src_tag, dtype=np.int32),
        src_dest=np.asarray(tables.src_dest, dtype=np.int32),
        cam_tag=np.asarray(tables.cam_tag, dtype=np.int32),
        cam_syn=np.asarray(tables.cam_syn, dtype=np.int32),
        cluster_size=int(tables.cluster_size),
        k_tags=int(tables.k_tags),
        tile_of_cluster=None if placement is None else np.asarray(placement),
    )


def params_from_jax(params) -> NeuronParams:
    """The port's :class:`NeuronParams` from ``repro``'s (a dataclass of floats)."""
    return NeuronParams(
        **{f.name: getattr(params, f.name) for f in dataclasses.fields(NeuronParams)}
    )


def state_from_numpy(v, w, refrac, i_syn, device: torch.device | str = "cuda") -> NeuronState:
    """A :class:`NeuronState` from array-likes ``v, w, refrac [..., N]`` and
    ``i_syn [..., N, 4]`` (float32 on ``device``: the card unless the caller
    asks for the CPU)."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return NeuronState(v=t(v), w=t(w), refrac=t(refrac), i_syn=t(i_syn))


def carry_from_numpy(carry, device: torch.device | str = "cuda") -> tuple:
    """The port's engine carry from ``repro``'s, through numpy arrays.

    ``carry`` is ``(state, spikes)`` (queued mode), ``(state, spikes,
    inflight)`` (fabric roll mode) or ``(state, spikes, ring, cursor)``
    (fabric ring mode); ``state`` has ``v, w, refrac, i_syn``. Floats become
    float32 tensors on ``device`` (the card unless the caller asks for the
    CPU) and the ring cursor a 0-dim int32 tensor, so both engines can step
    on from the same mid-flight state.
    """
    state, spikes, *delay_line = carry
    if len(delay_line) > 2:
        raise ValueError(f"a carry has 2, 3 or 4 elements, got {len(carry)}")
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    out = [state_from_numpy(state.v, state.w, state.refrac, state.i_syn, device), f32(spikes)]
    if delay_line:
        out.append(f32(delay_line[0]))
    if len(delay_line) == 2:
        out.append(torch.as_tensor(np.array(delay_line[1], dtype=np.int32), device=device))
    return tuple(out)


def _layout(cfg) -> dict[str, tuple[int, int, int]]:
    """Per stack, (layers before the periods, blocks per period, the first
    layer after them); the encoder is periods only, one block each."""
    n_pre, n_p = len(cfg.prefix_layers), len(cfg.period)
    return {"stack": (n_pre, n_p, n_pre + cfg.n_periods * n_p),
            "encoder": (0, 1, cfg.n_enc_layers)}


def _port_names(cfg, path: tuple[str, ...], a):
    """(port name, leaf) pairs for ``repro``'s leaf at ``path``: a period
    leaf (``periods/b{i}/...``) gives one slice per period, anything else
    itself under its dotted path. A q8 moment (``{"q", "scale"}``) is sliced
    part by part."""
    top, part = path[0], path[1] if len(path) > 1 else ""
    layout = _layout(cfg)
    if top in ("embedding", "unembed", "final_norm", "enc_norm", "mtp") or (
            top == "stack" and part == "shared_block"):
        return [(".".join(path), a)]
    if top in layout and part == "periods" and len(path) > 3:
        pre, per, _ = layout[top]
        i = int(path[2].removeprefix("b"))
        n = np.shape(a["q"] if isinstance(a, dict) else a)[0]
        take = (lambda x, p: {k: v[p] for k, v in x.items()}) if isinstance(a, dict) else (
            lambda x, p: x[p])
        return [(".".join((top, str(pre + p * per + i), *path[3:])), take(a, p))
                for p in range(n)]
    if top == "stack" and part.startswith("prefix") and len(path) > 2:
        return [(".".join((top, part.removeprefix("prefix"), *path[2:])), a)]
    if top == "stack" and part.startswith("remainder") and len(path) > 2:
        layer = layout[top][2] + int(part.removeprefix("remainder"))
        return [(".".join((top, str(layer), *path[2:])), a)]
    raise ValueError(f"parameter {'/'.join(path)} is not part of repro's LM tree")


def repro_path(cfg, name: str) -> tuple[tuple[str, ...], int | None]:
    """``repro``'s path of the port's parameter ``name`` and, for a leaf of a
    scanned period, the period it is row of (else ``None``)."""
    parts = tuple(name.split("."))
    if parts[0] not in ("stack", "encoder") or not parts[1].isdigit():
        return parts, None
    pre, per, post = _layout(cfg)[parts[0]]
    layer, rest = int(parts[1]), parts[2:]
    if layer < pre:
        return ("stack", f"prefix{layer}", *rest), None
    if layer >= post:
        return ("stack", f"remainder{layer - post}", *rest), None
    period, i = divmod(layer - pre, per)
    return (parts[0], "periods", f"b{i}", *rest), period


def repro_ndim(cfg, name: str, ndim: int) -> int:
    """The rank of the port's parameter ``name`` (of rank ``ndim``) in
    ``repro``'s tree, where a scanned period's leaves carry one more leading
    axis, ``[n_periods]``: that is the rank ``repro``'s AdamW judges its
    weight decay by (``ndim >= 2``), so it decays every norm scale and
    ``router_bias`` of ``stack/periods`` and ``encoder/periods``, but not
    those of the prefix, the remainder, the shared block or MTP."""
    return ndim + (repro_path(cfg, name)[1] is not None)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: go through float32, exactly
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _from_repro(cfg, tree, device) -> dict:
    """``tree``'s leaves (a q8 moment counts as one) under the port's names,
    as tensors on ``device``."""
    out = {}
    for path, a in _leaves(tree):
        for name, leaf in _port_names(cfg, path, a):
            out[name] = ({k: _to_torch(v, device) for k, v in leaf.items()} if _is_q8(leaf)
                         else _to_torch(leaf, device))
    return out


def lm_params_from_numpy(cfg, tree, device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """The port's LM state dict from ``repro``'s parameter pytree as numpy
    arrays (``jax.tree.map(np.asarray, params)``), for ``Model.load_state_dict``.

    ``repro`` keeps its unrolled blocks as ``prefix{i}`` / ``remainder{i}``
    and stacks its scanned periods along a leading ``[n_periods]`` axis
    (``periods/b{i}``); the port's stacks have one module per layer, in the
    order prefix, periods, remainder. So under ``stack``, ``prefix{i}``
    becomes layer ``i``, period ``p``'s block ``i`` layer ``len(prefix) + p *
    len(period) + i`` and ``remainder{i}`` the layer after the periods' last
    plus ``i``. The encoder (``encoder/periods/b0``, one block per period)
    unstacks the same way. The shared block (``stack/shared_block``, one
    parameter set), MTP (``mtp``), the embeddings, the norms and every leaf
    inside a block (MoE experts ``[E, ...]``, shared experts, q/k norms,
    cross-attention, post-block norms, MLA and Mamba2 parameters) keep their
    names. Every array keeps its dtype (bfloat16 stays bfloat16) and lands
    on ``device``, the card unless the caller asks for the CPU. A leaf
    outside ``repro``'s LM tree raises ``ValueError``.
    """
    return _from_repro(cfg, tree, resolve_device(device))


def lm_params_to_numpy(cfg, params) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: ``repro``'s parameter tree
    (nested dicts of numpy arrays) from the port's parameters (a dict of
    tensors by name, or a ``Model``), each period's layers stacked again
    along a leading ``[n_periods]`` axis. A bfloat16 tensor comes back as a
    float32 array of the same values (numpy has no bfloat16)."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    tree: dict = {}
    rows: dict[tuple[str, ...], dict[int, np.ndarray]] = {}
    for name, t in params.items():
        t = t.detach().cpu()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        path, period = repro_path(cfg, name)
        if period is None:
            _set(tree, path, a)
        else:
            rows.setdefault(path, {})[period] = a
    for path, by_period in rows.items():
        _set(tree, path, np.stack([by_period[p] for p in sorted(by_period)]))
    return tree


def train_state_from_numpy(cfg, state, device: torch.device | str = "cuda") -> dict:
    """The port's train state (``repro_torch.train.loop``) from ``repro``'s
    ``{"params", "opt": {"m", "v", "step"}}`` as numpy arrays, periods
    unstacked as :func:`lm_params_from_numpy` unstacks them. q8 moments
    (``{"q", "scale"}`` per leaf, blocks over the last axis) are sliced per
    period the same way; bfloat16 moments stay bfloat16."""
    device = resolve_device(device)
    opt = state["opt"]
    return {
        "params": _from_repro(cfg, state["params"], device),
        "opt": {"m": _from_repro(cfg, opt["m"], device), "v": _from_repro(cfg, opt["v"], device),
                "step": torch.as_tensor(np.array(opt["step"], dtype=np.int32), device=device)},
    }


def _set(tree: dict, path: tuple[str, ...], leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _leaves(tree, path: tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict, in key order; a q8 moment
    (``{"q", "scale"}``) is one leaf."""
    if isinstance(tree, dict) and not _is_q8(tree):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, str(key)))
    else:
        yield path, tree
