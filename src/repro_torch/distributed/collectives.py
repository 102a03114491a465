"""Hierarchical collectives and gradient compression (DESIGN.md §3, §6).

The port of ``repro.distributed.collectives`` over the port's single-process
:class:`~repro_torch.distributed.mesh.DeviceMesh`. The paper's R1/R2/R3
hierarchy concentrates local traffic so that only a residue crosses the
expensive global fabric; across pods of accelerators that is:

* :func:`hierarchical_all_reduce`: reduce-scatter inside the pod (the inner
  axis), all-reduce the ``1 / inner``-sized shard across pods (the outer
  axis: the only cross-pod bytes), all-gather inside the pod;
* :func:`hierarchical_all_to_all`: a two-stage all-to-all for EP over
  several pods, the pod's traffic concentrated inside the pod first, then
  one pod-to-pod exchange;
* :func:`compress_int8` / :func:`decompress_int8` and
  :func:`ef_all_reduce`: an int8 cross-pod gradient exchange whose
  quantisation residual is fed back into the next step's gradient (error
  feedback), on the outer hop only;
* :func:`all_reduce_cross_pod_bytes`: the bytes that cross the pods' cut.

``repro`` calls these inside ``shard_map`` on each device's local array.
Here each takes the mesh, every cell's tensor (a dict keyed by cell, as
``NamedSharding.shard`` gives them) and the axis names, and returns every
cell's result in a new dict, built from the mesh collectives
(``distributed.mesh``): fresh tensors on each cell's device, differentiable.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import mesh as mesh_mod

__all__ = [
    "all_reduce_cross_pod_bytes", "compress_int8", "decompress_int8", "ef_all_reduce",
    "flat_all_reduce", "hierarchical_all_reduce", "hierarchical_all_to_all",
]


def _over_groups(mesh, parts: dict, axes, collective) -> dict:
    """``collective`` (a function of one group's list of tensors) over every
    group of ``axes``; every cell's result, by cell."""
    out = {}
    for group in mesh.groups(axes):
        for cell, got in zip(group, collective([parts[c] for c in group])):
            out[cell] = got
    return out


# ---------------------------------------------------------------------------
# hierarchical all-reduce
# ---------------------------------------------------------------------------
def hierarchical_all_reduce(mesh, x: dict, inner_axis: str, outer_axis: str) -> dict:
    """The sum over ``(inner, outer)`` with the cross-outer hop at
    ``1 / inner`` of the bytes: :func:`flat_all_reduce` up to the order of
    the float additions."""
    n_inner = mesh.shape[inner_axis]
    shape = next(iter(x.values())).shape
    n = next(iter(x.values())).numel()
    pad = (-n) % n_inner
    rows = {c: torch.nn.functional.pad(v.reshape(-1), (0, pad)).reshape(n_inner, -1)
            for c, v in x.items()}
    # R1/R2: reduce-scatter inside the pod
    shard = _over_groups(mesh, rows, inner_axis,
                         lambda ps: mesh_mod.psum_scatter(ps, 0, tiled=False))
    # R3: only 1 / n_inner of the bytes cross pods
    shard = _over_groups(mesh, shard, outer_axis, mesh_mod.psum)
    # R1/R2: all-gather back
    full = _over_groups(mesh, shard, inner_axis, lambda ps: mesh_mod.all_gather(ps, 0))
    return {c: v.reshape(-1)[:n].reshape(shape) for c, v in full.items()}


def flat_all_reduce(mesh, x: dict, axes) -> dict:
    """The sum over ``axes`` (one name or a tuple), on every cell."""
    return _over_groups(mesh, x, axes, mesh_mod.psum)


# ---------------------------------------------------------------------------
# hierarchical all-to-all (in-pod concentrate, cross-pod exchange)
# ---------------------------------------------------------------------------
def hierarchical_all_to_all(mesh, x: dict, inner_axis: str, outer_axis: str) -> dict:
    """Each cell's ``x`` is ``[n_total, ...]``, one slab per destination
    ``d = outer * n_inner + inner``: the all-to-all over ``(outer, inner)``
    jointly, in two stages. Stage A exchanges inside the pod, so that each
    cell then holds all of its pod's traffic for its column of remote
    cells; stage B is one cross-pod exchange, which moves each byte across
    the pods exactly once."""
    n_inner, n_outer = mesh.shape[inner_axis], mesh.shape[outer_axis]
    n_total = n_inner * n_outer
    first = next(iter(x.values()))
    if first.shape[0] != n_total:
        raise ValueError(f"x of shape {tuple(first.shape)} needs one slab per destination, "
                         f"{n_total}")
    rest = first.shape[1:]
    # [outer_dest, inner_dest, ...] -> [inner_dest, outer_dest, ...]
    y = {c: v.reshape(n_outer, n_inner, *rest).movedim(1, 0) for c, v in x.items()}
    # stage A (R1/R2): in-pod exchange; rows become [src_inner, outer_dest]
    y = _over_groups(mesh, y, inner_axis, lambda ps: mesh_mod.all_to_all(ps, 0, 0))
    # stage B (R3): one pod-to-pod exchange on the outer_dest dim
    y = _over_groups(mesh, y, outer_axis, lambda ps: mesh_mod.all_to_all(ps, 1, 1))
    # [src_inner, src_outer, ...] -> the linear source index
    return {c: v.movedim(1, 0).reshape(n_total, *rest) for c, v in y.items()}


# ---------------------------------------------------------------------------
# int8 compression with error feedback (cross-pod hop only)
# ---------------------------------------------------------------------------
def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``(q, scale)``, ``scale`` float32."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def ef_all_reduce(mesh, grad: dict, error: dict, outer_axis: str) -> tuple[dict, dict]:
    """Error-feedback compressed mean across ``outer_axis``: each cell sends
    its gradient plus its carried error as int8 (one float32 scale) and
    keeps the quantisation residual as its new error. Returns (every cell's
    mean of the decompressed values, every cell's new error). ``repro``'s
    ``inner_axis`` argument, which it never reads, is left out."""
    n_outer = mesh.shape[outer_axis]
    sent, new_error = {}, {}
    for c, g in grad.items():
        x = g + error[c]
        q, scale = compress_int8(x)
        sent[c] = decompress_int8(q, scale, x.dtype)
        new_error[c] = x - sent[c]
    # the wire carries the int8 payload and one float32 scale; the reduction
    # itself runs on the decompressed values (the mean across pods)
    reduced = _over_groups(mesh, sent, outer_axis, mesh_mod.psum)
    return {c: v / n_outer for c, v in reduced.items()}, new_error


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
def all_reduce_cross_pod_bytes(n_bytes: int, n_pods: int, in_pod_size: int,
                               hierarchical: bool) -> float:
    """Bytes crossing the inter-pod cut for one all-reduce of ``n_bytes``:
    a flat ring over every device pushes every byte across it (the
    ``2 (P - 1) / P`` factor); the hierarchical one only the in-pod
    reduce-scattered shard, ``1 / in_pod_size`` of the bytes."""
    if n_pods <= 1:
        return 0.0
    ring = 2 * (n_pods - 1) / n_pods
    if hierarchical:
        return n_bytes / in_pod_size * ring
    return n_bytes * ring
