"""A single-process device mesh and the collectives of the sharded step.

Counterpart of what ``repro``'s sharded engine and fleet take from
``jax.sharding`` and ``repro.distributed.sharding``. One Python process
owns every device, as in ``repro`` (single-controller): a
:class:`DeviceMesh` is an array of ``torch.device`` with named axes
(``("data", "model")`` by default: batch slots over ``data``, clusters over
``model``). A device may appear in it more than once, so a mesh of several
cells runs on one card, as ``repro``'s tests run meshes on fake CPU devices.

* :class:`PartitionSpec` (``P``) names, per leading dim of an array, the
  mesh axis it is cut along, or a tuple of axes (cut over their product,
  row-major with the first axis major, as ``jax.sharding.PartitionSpec``
  orders it), or ``None`` (not cut); trailing dims past the spec and mesh
  axes it does not name are replicated.
* :class:`NamedSharding` cuts a global tensor into the cells' slabs
  (:meth:`~NamedSharding.shard`: a view where the cell's device is the
  tensor's, else a copy) and joins the cells' slabs back
  (:meth:`~NamedSharding.unshard`). A value *placed* on a mesh
  (:meth:`~NamedSharding.place`) is the global tensor on the mesh's first
  device, its home: the sharded step cuts it per step.
* :func:`psum`, :func:`psum_scatter`, :func:`all_to_all` and
  :func:`all_gather` are the collectives of the sharded steps, as plain
  functions over the list of one group's per-cell tensors
  (:meth:`DeviceMesh.groups` lists the groups over one axis or a tuple of
  axes, :meth:`DeviceMesh.index` a cell's rank in its group). Each result
  is built in fresh tensors, never in a cell's own buffer, so cells that
  share a device never read a half-summed slab. They are autograd ops:
  gradients flow back through them to every cell's input.

``torch.distributed`` is not used: a rank per device would turn the
fleet's single-process control plane into a distributed protocol, and two
ranks cannot share one GPU.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core import cost_hook
from repro_torch.core.device import resolve_device

__all__ = [
    "AXES",
    "DeviceMesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "all_gather",
    "all_to_all",
    "axes_tuple",
    "make_mesh",
    "named",
    "psum",
    "psum_scatter",
    "tree_map",
    "visible_devices",
]

AXES = ("data", "model")


class PartitionSpec(tuple):
    """Stand-in for ``jax.sharding.PartitionSpec``: ``P("data", "model")``
    cuts dim 0 over mesh axis ``data`` and dim 1 over ``model``; ``P()`` is
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axes_tuple(axes) -> tuple[str, ...]:
    """A spec entry or collective's axes as a tuple of names: ``"model"``
    gives ``("model",)``, a tuple stays as it is."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


def visible_devices(device: torch.device | str = "cuda") -> list[torch.device]:
    """The distinct devices of ``device``'s type this process sees: every
    GPU for ``cuda`` (raises without one), the one host for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


class DeviceMesh:
    """An N-D array of ``torch.device`` with one name per axis."""

    def __init__(self, devices, axis_names: tuple[str, ...] = AXES):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = resolve_device(src[idx])
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(
                f"a mesh of shape {arr.shape} needs {arr.ndim} distinct axis names, "
                f"got {tuple(axis_names)}"
            )
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self) -> torch.device:
        """The first device: where values placed on the mesh live."""
        return self.devices.flat[0]

    def cells(self) -> list[tuple[int, ...]]:
        return list(np.ndindex(self.devices.shape))

    def device(self, cell: tuple[int, ...]) -> torch.device:
        return self.devices[cell]

    def axes_size(self, axes) -> int:
        """The number of cells along ``axes`` (one name or a tuple)."""
        return math.prod(self.shape[a] for a in axes_tuple(axes))

    def index(self, cell: tuple[int, ...], axes) -> int:
        """``cell``'s rank along ``axes``: its coordinate on one axis, or
        over a tuple the linear index, row-major with the first axis major
        (``repro``'s ``_axes_linear_index``)."""
        idx = 0
        for a in axes_tuple(axes):
            idx = idx * self.shape[a] + cell[self.axis_names.index(a)]
        return idx

    def groups(self, axes) -> list[list[tuple[int, ...]]]:
        """The cells in groups along ``axes`` (one name or a tuple; the
        other coordinates fixed), each group in rank order
        (:meth:`index`): the participants of one collective."""
        ks = [self.axis_names.index(a) for a in axes_tuple(axes)]
        dims = self.devices.shape
        others = [i for i in range(len(dims)) if i not in ks]
        out = []
        for rest in itertools.product(*(range(dims[i]) for i in others)):
            group = []
            for along in itertools.product(*(range(dims[k]) for k in ks)):
                cell = [0] * len(dims)
                for i, c in zip(others, rest):
                    cell[i] = c
                for k, c in zip(ks, along):
                    cell[k] = c
                group.append(tuple(cell))
            out.append(group)
        return out

    @property
    def on_meta(self) -> bool:
        """Every cell is the meta device. Values are shapes alone there, the
        same for every cell of a sharded value: a per-cell dict holds one
        tensor for all cells, and the primitives below compute each result
        once (and report every cell's collective payload)."""
        return all(d.type == "meta" for d in self.devices.flat)

    def map_cells(self, fn, args: dict) -> dict:
        """``{cell: fn(*args[cell])}`` over every cell, in turn. On a mesh of
        the meta device every cell does the same work on shapes alone: the
        first cell's call runs once and stands for every cell, counted once
        per cell by a ``launch.costs.CostCounter`` in the forward and the
        backward, and every cell's inputs take its gradients (a mesh of 512
        cells dry-runs in about the time of one)."""
        cells = self.cells()
        if not self.on_meta:
            return {cell: fn(*args[cell]) for cell in cells}
        got = _for_every_cell(fn, [args[cell] for cell in cells])
        return dict.fromkeys(cells, got)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _for_every_cell(fn, cell_args: list[tuple]):
    """The first cell's ``fn(*args)``, standing for every cell's (see
    :meth:`DeviceMesh.map_cells`)."""
    leaves, spec = tree_flatten(cell_args[0])
    slots = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    inputs = [leaves[i] for i in slots]
    # another cell's tensors join the inputs (and take the first cell's
    # gradients) where they are not the first cell's own
    for a in cell_args[1:]:
        theirs = [tree_flatten(a)[0][i] for i in slots]
        if any(t is not mine for t, mine in zip(theirs, inputs[:len(slots)])):
            inputs += theirs
    out_spec = []

    def run(*ts):
        vals = list(leaves)
        for i, t in zip(slots, ts):
            vals[i] = t
        outs, o_spec = tree_flatten(fn(*tree_unflatten(vals, spec)))
        out_spec[:] = [o_spec]
        return tuple(outs)

    if _differentiable(inputs):
        outs = _ForEveryCell.apply(run, len(cell_args), len(slots), *inputs)
    else:
        with cost_hook.scaled(len(cell_args)):
            outs = run(*inputs[:len(slots)])
    return tree_unflatten(list(outs), out_spec[0])


class _ForEveryCell(torch.autograd.Function):
    """The first cell's work counted for ``n`` cells, forward and backward;
    ``inputs`` holds the first cell's ``k`` tensors, then those of each cell
    that has tensors of its own. The forward
    keeps no graph; the backward rebuilds it uncounted, counts its gradient
    ``n`` times and hands every cell's inputs the first cell's gradients."""

    @staticmethod
    def forward(ctx, run, n, k, *inputs):
        ctx.run, ctx.n, ctx.k = run, n, k
        ctx.save_for_backward(*inputs[:k])
        with cost_hook.scaled(n):
            return run(*inputs[:k])

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.k
        groups = (len(ctx.needs_input_grad) - 3) // k
        need = [any(ctx.needs_input_grad[3 + c * k + i] for c in range(groups)) for i in range(k)]
        inputs = [x.detach().requires_grad_(w) for x, w in zip(ctx.saved_tensors, need)]
        with cost_hook.suspended(), torch.enable_grad():
            outs = ctx.run(*inputs)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wanted = [x for x in inputs if x.requires_grad]
        first = [None] * k
        if pairs and wanted:
            with cost_hook.scaled(ctx.n):
                got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                               [g for _, g in pairs], allow_unused=True))
            first = [next(got) if x.requires_grad else None for x in inputs]
        return (None, None, None, *(first[j % k] if ctx.needs_input_grad[3 + j] else None
                                    for j in range(groups * k)))


def make_mesh(shape, axis_names: tuple[str, ...] = AXES, devices=None,
              device: torch.device | str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (which may repeat a device), or
    over the first ``prod(shape)`` distinct visible devices of ``device``'s
    type; raises when there are fewer."""
    shape = tuple(int(n) for n in shape)
    need = math.prod(shape)
    if devices is None:
        avail = visible_devices(device)
        if need > len(avail):
            raise ValueError(
                f"mesh needs {need} devices, only {len(avail)} visible "
                "(pass devices=, which may name one device more than once)"
            )
        devices = avail[:need]
    devices = list(devices)
    if len(devices) != need:
        raise ValueError(f"got {len(devices)} devices for a {' x '.join(map(str, shape))} mesh")
    arr = np.empty(need, dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(shape), axis_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a global tensor is cut over ``mesh``: ``spec`` names one mesh
    axis, a tuple of axes or ``None`` per leading dim."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def _cut(self) -> list[tuple[int, tuple[str, ...]]]:
        cut = [(dim, axes_tuple(ax)) for dim, ax in enumerate(self.spec) if ax is not None]
        for _, axes in cut:
            for ax in axes:
                if ax not in self.mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {ax!r}, mesh has "
                                     f"{self.mesh.axis_names}")
        return cut

    def check(self, shape) -> None:
        """Raise unless every cut dim divides over its mesh axes."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape} has dims")
        for dim, axes in self._cut():
            n = self.mesh.axes_size(axes)
            if shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of shape {shape} does not divide over the {n} "
                    f"devices of mesh axes {axes}"
                )

    def slab(self, x: torch.Tensor, cell: tuple[int, ...]) -> torch.Tensor:
        """``cell``'s slab of ``x``, a view on ``x``'s device."""
        for dim, axes in self._cut():
            w = x.shape[dim] // self.mesh.axes_size(axes)
            x = x.narrow(dim, self.mesh.index(cell, axes) * w, w)
        return x

    def shard(self, x: torch.Tensor) -> dict[tuple[int, ...], torch.Tensor]:
        """Every cell's slab on the cell's device: a view where that is
        ``x``'s device, else a copy. Its transpose sums the gradients of a
        slab's replicas (the cells that differ only on axes the spec leaves
        out) with :func:`psum`."""
        self.check(x.shape)
        cells = self.mesh.cells()
        if self.mesh.on_meta:
            slab = _MetaShard.apply(self, x) if _differentiable([x]) else self.slab(x, cells[0])
            return dict.fromkeys(cells, slab)
        if _differentiable([x]):
            return dict(zip(cells, _Shard.apply(self, x)))
        return {cell: self.slab(x, cell).to(self.mesh.device(cell), non_blocking=True)
                for cell in cells}

    def replicated_axes(self) -> tuple[str, ...]:
        """The mesh axes the spec does not cut: a slab's replicas differ on them."""
        named = {a for _, axes in self._cut() for a in axes}
        return tuple(a for a in self.mesh.axis_names if a not in named)

    def unshard(self, parts: dict, device: torch.device) -> torch.Tensor:
        """The global tensor on ``device`` from the cells' slabs (replicated
        axes read their first cell). One cell's slab comes back as it is."""
        cut = self._cut()
        first = next(iter(parts.values()))
        if self.mesh.on_meta and all(p is first for p in parts.values()):
            reps = [1] * first.dim()
            for dim, axes in cut:
                reps[dim] = self.mesh.axes_size(axes)
            return first.repeat(*reps).to(device)

        def build(fixed: dict[str, int], k: int) -> torch.Tensor:
            if k == len(cut):
                cell = tuple(fixed.get(name, 0) for name in self.mesh.axis_names)
                return parts[cell].to(device, non_blocking=True)
            dim, axes = cut[k]
            sizes = [self.mesh.shape[a] for a in axes]
            pieces = [build({**fixed, **dict(zip(axes, coords))}, k + 1)
                      for coords in itertools.product(*(range(n) for n in sizes))]
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

        return build({}, 0)

    def place(self, x) -> torch.Tensor:
        """``x`` (tensor or numpy) placed on the mesh: checked against the
        spec and moved to the mesh's home device."""
        t = torch.as_tensor(x)
        self.check(t.shape)
        return t.to(self.mesh.home)


class _Shard(torch.autograd.Function):
    """:meth:`NamedSharding.shard`, whose transpose is a :func:`psum` of
    each slab's gradients over its replicas, into the global gradient."""

    @staticmethod
    def forward(ctx, sharding, x):
        ctx.sharding = sharding
        ctx.set_materialize_grads(False)
        return _distinct([sharding.slab(x, cell).to(sharding.mesh.device(cell), non_blocking=True)
                          for cell in sharding.mesh.cells()])

    @staticmethod
    def backward(ctx, *grads):
        sh = ctx.sharding
        if all(g is None for g in grads):
            return None, None
        like = next(g for g in grads if g is not None)
        by_cell = {c: torch.zeros_like(like) if g is None else g
                   for c, g in zip(sh.mesh.cells(), grads)}
        summed = {}
        for group in sh.mesh.groups(sh.replicated_axes()):
            parts = [by_cell[c] for c in group]
            total = psum(parts)[0] if len(parts) > 1 else parts[0]
            summed.update(dict.fromkeys(group, total))
        return None, sh.unshard(summed, sh.mesh.home)


class _MetaShard(torch.autograd.Function):
    """:meth:`NamedSharding.shard` on a meta mesh: the first cell's slab
    stands for every cell's, and the transpose reports the :func:`psum` of
    every cell's gradient over its replicas."""

    @staticmethod
    def forward(ctx, sharding, x):
        ctx.sharding = sharding
        ctx.set_materialize_grads(False)
        return sharding.slab(x, sharding.mesh.cells()[0]).clone()

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        sh = ctx.sharding
        if sh.mesh.axes_size(sh.replicated_axes()) > 1:
            _reports("all-reduce", [g] * sh.mesh.size, 2.0)
        return None, sh.unshard(dict.fromkeys(sh.mesh.cells(), g), g.device)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, tuples, lists, dataclasses;
    ``None`` holds no leaf) and the matching leaves of ``rest``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not _is_spec(tree):
        items = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        return type(tree)(items)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest),
                             is_leaf=is_leaf)
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def named(mesh: DeviceMesh, spec_tree):
    """A tree of :class:`NamedSharding` from a tree of specs (``repro``'s
    ``distributed.sharding.named``)."""
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree, is_leaf=_is_spec)


def _reports(kind: str, parts: list[torch.Tensor], factor: float) -> None:
    """Tell a counting ``launch.costs.CostCounter`` of one collective."""
    obs = cost_hook.observer
    if obs is not None:
        obs.collective(kind, sum(p.numel() * p.element_size() for p in parts), factor)


def _differentiable(parts) -> bool:
    return torch.is_grad_enabled() and any(p.requires_grad for p in parts)


def _distinct(outs: list[torch.Tensor]) -> tuple[torch.Tensor, ...]:
    """``outs`` with a tensor that appears twice cloned: an autograd
    function hands back one tensor per output."""
    seen: set[int] = set()
    got = []
    for t in outs:
        got.append(t.clone() if id(t) in seen else t)
        seen.add(id(t))
    return tuple(got)


def _one_meta_value(parts: list[torch.Tensor]) -> bool:
    """A meta mesh's per-cell value: one tensor for every cell."""
    return parts[0].device.type == "meta" and all(p is parts[0] for p in parts)


class _MetaCollective(torch.autograd.Function):
    """A collective over one meta value, computed once: its result passes
    through, and the backward reports the transpose over the ``n`` cells
    (an all-reduce's is an all-reduce, an all-to-all's an all-to-all of the
    same payload). The gradient, one shape for every cell, passes back."""

    @staticmethod
    def forward(ctx, kind, factor, n, x):
        ctx.kind, ctx.factor, ctx.n = kind, factor, n
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g is not None:
            _reports(ctx.kind, [g] * ctx.n, ctx.factor)
        return None, None, None, g


def _transpose(grads, collective) -> tuple:
    """A collective's gradients through its transpose; no gradient reaching
    any output runs (and reports) no transpose, as a symbolic zero in JAX."""
    if all(g is None for g in grads):
        return (None,) * len(grads)
    like = next(g for g in grads if g is not None)
    return tuple(collective([torch.zeros_like(like) if g is None else g for g in grads]))


class _PSum(torch.autograd.Function):
    """:func:`psum`, whose transpose is :func:`psum` of the gradients."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.set_materialize_grads(False)
        return _distinct(_psum(list(parts)))

    @staticmethod
    def backward(ctx, *grads):
        return _transpose(grads, lambda gs: psum(gs))


class _PSumScatter(torch.autograd.Function):
    """:func:`psum_scatter`, whose transpose is :func:`all_gather`."""

    @staticmethod
    def forward(ctx, dim, tiled, *parts):
        ctx.dim, ctx.tiled = dim, tiled
        ctx.set_materialize_grads(False)
        return _distinct(_psum_scatter(list(parts), dim, tiled))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_transpose(grads, lambda gs: all_gather(gs, ctx.dim, ctx.tiled)))


class _AllGather(torch.autograd.Function):
    """:func:`all_gather`, whose transpose is :func:`psum_scatter`."""

    @staticmethod
    def forward(ctx, dim, tiled, *parts):
        ctx.dim, ctx.tiled = dim, tiled
        ctx.set_materialize_grads(False)
        return _distinct(_all_gather(list(parts), dim, tiled))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_transpose(grads, lambda gs: psum_scatter(gs, ctx.dim, ctx.tiled)))


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`, whose transpose is :func:`all_to_all` with the
    split and concat dims swapped."""

    @staticmethod
    def forward(ctx, split_dim, concat_dim, tiled, *parts):
        ctx.dims, ctx.tiled = (split_dim, concat_dim), tiled
        ctx.set_materialize_grads(False)
        return _distinct(_all_to_all(list(parts), split_dim, concat_dim, tiled))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        return (None, None, None,
                *_transpose(grads, lambda gs: all_to_all(gs, concat_dim, split_dim, ctx.tiled)))


def psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise sum of the group's tensors, replicated back to every
    cell's device (one fresh tensor per device). Its transpose is itself."""
    _reports("all-reduce", parts, 2.0)  # a ring moves each byte twice
    if _one_meta_value(parts):
        return [_MetaCollective.apply("all-reduce", 2.0, len(parts), parts[0])] * len(parts)
    if _differentiable(parts):
        return list(_PSum.apply(*parts))
    return _psum(parts)


def _psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev, non_blocking=True)
    return [total if p.device == dev else total.to(p.device, non_blocking=True) for p in parts]


def psum_scatter(parts: list[torch.Tensor], dim: int, tiled: bool = True) -> list[torch.Tensor]:
    """Sum the group's partial tensors and hand cell ``j`` the ``j``-th slab
    of the sum along ``dim`` (``tiled=False``: the dim has the group's size
    and is dropped), on its own device. Each slab is summed into a fresh
    tensor; a group of one hands back its tensor as it is. Its transpose is
    :func:`all_gather`."""
    _reports("reduce-scatter", parts, 1.0)
    if _differentiable(parts):
        return list(_PSumScatter.apply(dim, tiled, *parts))
    return _psum_scatter(parts, dim, tiled)


def _psum_scatter(parts: list[torch.Tensor], dim: int, tiled: bool) -> list[torch.Tensor]:
    n = len(parts)
    dim = dim % parts[0].ndim
    size = parts[0].shape[dim]
    if size % n or (not tiled and size != n):
        raise ValueError(f"dim {dim} of size {size} does not scatter over {n} cells"
                         f"{'' if tiled else ' untiled'}")
    w = size // n
    out = []
    for j, pj in enumerate(parts):
        acc = None
        for p in parts:
            s = p.narrow(dim, j * w, w).to(pj.device, non_blocking=True)
            acc = s if acc is None else acc + s
        out.append(acc if tiled else acc.squeeze(dim))
    return out


def all_to_all(parts: list[torch.Tensor], split_dim: int, concat_dim: int,
               tiled: bool = False) -> list[torch.Tensor]:
    """``jax.lax.all_to_all`` over one group: every tensor is cut into the
    group's ``n`` slabs along ``split_dim``, and cell ``j`` receives slab
    ``j`` of every source, joined along ``concat_dim`` in source order, on
    its own device. ``tiled=False``: ``split_dim`` has size ``n`` and is
    dropped, and the sources stack along a new dim at ``concat_dim``. Its
    transpose is itself with the two dims swapped."""
    _reports("all-to-all", parts, 1.0)
    if _one_meta_value(parts):
        got = _all_to_all(parts, split_dim, concat_dim, tiled, first_only=True)[0]
        return [_MetaCollective.apply("all-to-all", 1.0, len(parts), got)] * len(parts)
    if _differentiable(parts):
        return list(_AllToAll.apply(split_dim, concat_dim, tiled, *parts))
    return _all_to_all(parts, split_dim, concat_dim, tiled)


def _all_to_all(parts: list[torch.Tensor], split_dim: int, concat_dim: int,
                tiled: bool, first_only: bool = False) -> list[torch.Tensor]:
    """``first_only``: every source is one tensor (a meta mesh's value);
    only the first destination's result is built."""
    n = len(parts)
    ndim = parts[0].ndim
    split_dim, concat_dim = split_dim % ndim, concat_dim % ndim
    if not tiled:
        if parts[0].shape[split_dim] != n:
            raise ValueError(f"dim {split_dim} of shape {tuple(parts[0].shape)} is not the "
                             f"group's size {n}")
        if split_dim < concat_dim:
            concat_dim += 1
        elif concat_dim < split_dim:
            split_dim += 1
        if split_dim != concat_dim:
            parts = ([parts[0].unsqueeze(concat_dim)] * n if first_only
                     else [p.unsqueeze(concat_dim) for p in parts])
    size = parts[0].shape[split_dim]
    if size % n:
        raise ValueError(f"dim {split_dim} of size {size} does not split over {n} cells")
    w = size // n
    squeeze = not tiled and split_dim != concat_dim
    if first_only:
        # the first destination's slab of each (identical) source, n times
        slab = parts[0].narrow(split_dim, 0, w).unsqueeze(concat_dim)
        shape = list(slab.shape)
        shape[concat_dim] = n
        got = slab.expand(shape).flatten(concat_dim, concat_dim + 1)
        return [got.squeeze(split_dim) if squeeze else got]
    out = []
    for j, pj in enumerate(parts):
        slabs = [p.narrow(split_dim, j * w, w).to(pj.device, non_blocking=True) for p in parts]
        got = torch.cat(slabs, concat_dim)
        out.append(got.squeeze(split_dim) if squeeze else got)
    return out


def all_gather(parts: list[torch.Tensor], dim: int, tiled: bool = False) -> list[torch.Tensor]:
    """Every cell receives the group's tensors in rank order on its own
    device: joined along ``dim`` (``tiled=True``), or stacked along a new
    dim at ``dim``. Its transpose is :func:`psum_scatter`."""
    _reports("all-gather", parts, max(len(parts) - 1, 1))
    if _differentiable(parts):
        return list(_AllGather.apply(dim, tiled, *parts))
    return _all_gather(parts, dim, tiled)


def _all_gather(parts: list[torch.Tensor], dim: int, tiled: bool) -> list[torch.Tensor]:
    out = []
    for pj in parts:
        pieces = [p.to(pj.device, non_blocking=True) for p in parts]
        out.append(torch.cat(pieces, dim) if tiled else torch.stack(pieces, dim))
    return out
