"""Carry routing tables, neuron parameters and neuron state across from ``repro``.

The functions read plain numpy arrays and dataclass fields, so they work on
``repro`` objects without importing ``repro`` (or JAX): tests use them to
feed both packages the same network and state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.core.tags import RoutingTables

__all__ = ["tables_from_numpy", "params_from_jax", "state_from_numpy"]


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


def state_from_numpy(v, w, refrac, i_syn, device: torch.device | str = "cpu") -> NeuronState:
    """A :class:`NeuronState` from array-likes ``v, w, refrac [..., N]`` and
    ``i_syn [..., N, 4]`` (float32 on ``device``)."""

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)

    return NeuronState(v=t(v), w=t(w), refrac=t(refrac), i_syn=t(i_syn))
