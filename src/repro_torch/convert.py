"""Carry routing tables, neuron parameters, neuron state and LM weights across
from ``repro``.

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
    "carry_from_numpy", "lm_params_from_numpy", "params_from_jax", "state_from_numpy",
    "tables_from_numpy",
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
    device = resolve_device(device)
    n_pre, n_p = len(cfg.prefix_layers), len(cfg.period)
    layout = {"stack": (n_pre, n_p, n_pre + cfg.n_periods * n_p), "encoder": (0, 1, 0)}
    out: dict[str, torch.Tensor] = {}

    def put(name: str, a) -> None:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16: go through float32, exactly
            out[name] = torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
        else:
            out[name] = torch.as_tensor(np.array(a), device=device)

    for path, a in _leaves(tree):
        top, part = path[0], path[1] if len(path) > 1 else ""
        if top in ("embedding", "unembed", "final_norm", "enc_norm", "mtp") or (
                top == "stack" and part == "shared_block"):
            put(".".join(path), a)
        elif top in layout and part == "periods" and len(path) > 3:
            pre, per, _ = layout[top]
            i = int(path[2].removeprefix("b"))
            for period in range(np.shape(a)[0]):
                put(".".join((top, str(pre + period * per + i), *path[3:])), a[period])
        elif top == "stack" and part.startswith("prefix") and len(path) > 2:
            put(".".join((top, part.removeprefix("prefix"), *path[2:])), a)
        elif top == "stack" and part.startswith("remainder") and len(path) > 2:
            layer = layout[top][2] + int(part.removeprefix("remainder"))
            put(".".join((top, str(layer), *path[2:])), a)
        else:
            raise ValueError(f"parameter {'/'.join(path)} is not part of repro's LM tree")
    return out


def _leaves(tree, path: tuple[str, ...] = ()):
    """(path, leaf) pairs of a nested dict, in key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, str(key)))
    else:
        yield path, tree
