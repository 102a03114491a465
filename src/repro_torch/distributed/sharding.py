"""Logical-axis -> PartitionSpec resolution: the port of
``repro.distributed.sharding``.

Models name every parameter's dims with logical axes ("embed", "heads",
"mlp", "experts", ...; the ``*_spec`` functions of ``repro_torch.models``
and ``Model.param_specs()``). :func:`resolve` maps those names onto a
concrete mesh with ``repro``'s *priority + divisibility* policy: each
logical name carries an ordered list of candidate mesh axes (``RULES``),
and the resolver gives a dim the first candidate whose size divides it and
whose mesh axes the tensor does not use yet, the names of lower
``PRIORITY`` first. A dim that cannot shard falls back gracefully (yi-34b's
56 heads on a 16-way model axis shard the embed dim instead), and "embed"
shards only a tensor of at least ``EMBED_FALLBACK_MIN_ELEMS`` elements.
Expert tensors prefer ``("data", "model")`` jointly and fall back to
``"model"`` alone; the pod axis never carries experts.

The resolver reads only ``mesh.shape`` (a dict of axis sizes), so a
duck-typed mesh works as well as a :class:`~repro_torch.distributed.mesh.DeviceMesh`.
Specs are the port's :class:`~repro_torch.distributed.mesh.PartitionSpec`.

``repro``'s ``activation_mesh`` / ``active_axis_size`` / ``constrain`` pin
activation layouts for XLA's partitioner while tracing. Eager PyTorch has no
partitioner to pin, so the port has no counterpart (as
``repro_torch.models.attention`` has none of the attention hints).
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.distributed.mesh import P, axes_tuple, named, tree_map

__all__ = [
    "BATCH_AXES", "EMBED_FALLBACK_MIN_ELEMS", "PRIORITY", "RULES", "SEQ_AXES", "batch_pspec",
    "cache_pspec", "named", "resolve", "token_pspec", "tree_pspecs",
]

# ordered candidates per logical axis name; each candidate is a mesh-axis
# name or a tuple of names (sharded over their product)
RULES: dict[str, tuple] = {
    "experts": (("data", "model"), "model", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_flat": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "vocab_in": (),
    "inner": ("model",),
    "ssm_heads": ("model",),
    "embed": ("model",),  # used only as fallback via priority ordering
    "kv_lora": (),
    "q_lora": (),
    "head_dim": (),
    "embed_out": (),
}

# resolution priority: lower = claimed first
PRIORITY = {
    "experts": 0,
    "heads": 1,
    "kv_heads": 1,
    "heads_flat": 1,
    "mlp": 1,
    "vocab": 1,
    "inner": 1,
    "ssm_heads": 1,
    "embed": 5,
}

# activation / input logical axes
BATCH_AXES = ("pod", "data")
SEQ_AXES = ("data",)

# minimum tensor size (elements) for the row-parallel "embed" fallback; below
# this, replicating the weight beats per-matmul all-reduces
EMBED_FALLBACK_MIN_ELEMS = 2**25


def _axes_size(mesh, axes) -> int:
    """The product of ``axes``' sizes; 0 when one is not on the mesh."""
    size = 1
    for a in axes_tuple(axes):
        if a not in mesh.shape:
            return 0  # axis absent from this mesh -> candidate unusable
        size *= mesh.shape[a]
    return size


def resolve(logical: tuple, shape: tuple, mesh) -> P:
    """One tensor: logical axis names + concrete shape -> PartitionSpec."""
    assert len(logical) == len(shape), (logical, shape)
    assignment: list = [None] * len(logical)
    used: set[str] = set()
    order = sorted(range(len(logical)), key=lambda i: PRIORITY.get(logical[i] or "", 9))
    total_elems = math.prod(int(d) for d in shape)
    for i in order:
        name = logical[i]
        if name is None:
            continue
        if name == "embed" and total_elems < EMBED_FALLBACK_MIN_ELEMS:
            # replicating a small weight beats row-parallel all-reduces
            continue
        for cand in RULES.get(name, ()):
            size = _axes_size(mesh, cand)
            flat = axes_tuple(cand)
            if size > 1 and shape[i] % size == 0 and not (set(flat) & used):
                assignment[i] = cand
                used.update(flat)
                break
    return P(*assignment)


def tree_pspecs(spec_tree: Any, shape_tree: Any, mesh, prefix_none: int = 0):
    """Resolve a whole spec tree (logical tuples at its leaves) against a
    tree of the same structure holding shapes (tuples, ``torch.Size`` or
    anything with ``.shape``). ``prefix_none`` prepends unsharded leading
    dims (the stacked-period axis) to each logical tuple."""

    def one(spec, shaped):
        shape = tuple(getattr(shaped, "shape", shaped))
        return resolve((None,) * prefix_none + tuple(spec), shape, mesh)

    return tree_map(one, spec_tree, shape_tree, is_leaf=lambda x: isinstance(x, tuple))


def batch_pspec(global_batch: int, mesh) -> P:
    """Shard the batch dim over as many of (pod, data) as divide it."""
    axes = [a for a in BATCH_AXES if a in mesh.shape]
    while axes and global_batch % math.prod(mesh.shape[a] for a in axes) != 0:
        axes.pop(0)
    return P(tuple(axes) if axes else None)


def token_pspec(global_batch: int, seq: int, mesh) -> P:
    """[batch, seq] inputs: the batch as :func:`batch_pspec`, the sequence
    over the first of ``SEQ_AXES`` the batch leaves free and that divides it."""
    b_axes = batch_pspec(global_batch, mesh)[0]
    used = set(axes_tuple(b_axes)) if b_axes else set()
    seq_axes = [a for a in SEQ_AXES
                if a in mesh.shape and a not in used and seq % mesh.shape[a] == 0]
    return P(b_axes, seq_axes[0] if seq_axes else None)


def cache_pspec(shape: tuple, kind: tuple, mesh) -> P:
    """KV-cache style tensors: kind names each dim from
    {"batch", "seq", "kv_heads", "heads", "head_dim", "state", None}."""
    assignment: list = [None] * len(shape)
    used: set[str] = set()
    for i, (name, dim) in enumerate(zip(kind, shape)):
        if name == "batch":
            axes = [a for a in BATCH_AXES if a in mesh.shape and a not in used]
            while axes and dim % math.prod(mesh.shape[a] for a in axes) != 0:
                axes.pop(0)
            if axes:
                assignment[i] = tuple(axes)
                used.update(axes)
        elif name == "seq":
            for a in SEQ_AXES:
                if a in mesh.shape and a not in used and dim % mesh.shape[a] == 0:
                    assignment[i] = a
                    used.add(a)
                    break
        elif name in ("kv_heads", "heads", "state"):
            if "model" not in used and "model" in mesh.shape and dim % mesh.shape["model"] == 0:
                assignment[i] = "model"
                used.add("model")
    return P(*assignment)
