"""A single-process device mesh and the collectives of the sharded step.

Counterpart of what ``repro``'s sharded engine and fleet take from
``jax.sharding`` and ``repro.distributed.sharding``. One Python process
owns every device, as in ``repro`` (single-controller): a
:class:`DeviceMesh` is an array of ``torch.device`` with named axes
(``("data", "model")`` by default: batch slots over ``data``, clusters over
``model``). A device may appear in it more than once, so a mesh of several
cells runs on one card, as ``repro``'s tests run meshes on fake CPU devices.

* :class:`PartitionSpec` (``P``) names, per leading dim of an array, the
  mesh axis it is cut along (``None``: not cut); trailing dims past the
  spec and mesh axes it does not name are replicated.
* :class:`NamedSharding` cuts a global tensor into the cells' slabs
  (:meth:`~NamedSharding.shard`: a view where the cell's device is the
  tensor's, else a copy) and joins the cells' slabs back
  (:meth:`~NamedSharding.unshard`). A value *placed* on a mesh
  (:meth:`~NamedSharding.place`) is the global tensor on the mesh's first
  device, its home: the sharded step cuts it per step.
* :func:`psum` and :func:`psum_scatter` are the collectives of the sharded
  step, as plain functions over the list of one axis group's per-cell
  tensors. Each sum is built in fresh tensors, never in a cell's own
  buffer, so cells that share a device never read a half-summed slab.

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

from repro_torch.core.device import resolve_device

__all__ = [
    "AXES",
    "DeviceMesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
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

    def index(self, cell: tuple[int, ...], axis: str) -> int:
        return cell[self.axis_names.index(axis)]

    def groups(self, axis: str) -> list[list[tuple[int, ...]]]:
        """The cells in groups along ``axis`` (the other coordinates fixed),
        each group in axis order: the participants of one collective."""
        k = self.axis_names.index(axis)
        others = [range(n) for i, n in enumerate(self.devices.shape) if i != k]
        out = []
        for rest in itertools.product(*others):
            out.append([(*rest[:k], j, *rest[k:]) for j in range(self.devices.shape[k])])
        return out

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices.flat]})"


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
    axis (or ``None``) per leading dim."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def _cut(self) -> list[tuple[int, str]]:
        cut = [(dim, ax) for dim, ax in enumerate(self.spec) if ax is not None]
        for _, ax in cut:
            if ax not in self.mesh.shape:
                raise ValueError(f"spec {self.spec} names axis {ax!r}, mesh has "
                                 f"{self.mesh.axis_names}")
        return cut

    def check(self, shape) -> None:
        """Raise unless every cut dim divides over its mesh axis."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape} has dims")
        for dim, ax in self._cut():
            n = self.mesh.shape[ax]
            if shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of shape {shape} does not divide over the {n} "
                    f"devices of mesh axis {ax!r}"
                )

    def slab(self, x: torch.Tensor, cell: tuple[int, ...]) -> torch.Tensor:
        """``cell``'s slab of ``x``, a view on ``x``'s device."""
        for dim, ax in self._cut():
            w = x.shape[dim] // self.mesh.shape[ax]
            x = x.narrow(dim, self.mesh.index(cell, ax) * w, w)
        return x

    def shard(self, x: torch.Tensor) -> dict[tuple[int, ...], torch.Tensor]:
        """Every cell's slab on the cell's device: a view where that is
        ``x``'s device, else a copy."""
        self.check(x.shape)
        return {cell: self.slab(x, cell).to(self.mesh.device(cell), non_blocking=True)
                for cell in self.mesh.cells()}

    def unshard(self, parts: dict, device: torch.device) -> torch.Tensor:
        """The global tensor on ``device`` from the cells' slabs (replicated
        axes read their first cell). One cell's slab comes back as it is."""
        cut = self._cut()

        def build(fixed: dict[str, int], k: int) -> torch.Tensor:
            if k == len(cut):
                cell = tuple(fixed.get(name, 0) for name in self.mesh.axis_names)
                return parts[cell].to(device, non_blocking=True)
            dim, ax = cut[k]
            pieces = [build({**fixed, ax: i}, k + 1) for i in range(self.mesh.shape[ax])]
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

        return build({}, 0)

    def place(self, x) -> torch.Tensor:
        """``x`` (tensor or numpy) placed on the mesh: checked against the
        spec and moved to the mesh's home device."""
        t = torch.as_tensor(x)
        self.check(t.shape)
        return t.to(self.mesh.home)


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


def psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise sum of the group's tensors, replicated back to every
    cell's device (one fresh tensor per device)."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev, non_blocking=True)
    return [total if p.device == dev else total.to(p.device, non_blocking=True) for p in parts]


def psum_scatter(parts: list[torch.Tensor], dim: int, tiled: bool = True) -> list[torch.Tensor]:
    """Sum the group's partial tensors and hand cell ``j`` the ``j``-th slab
    of the sum along ``dim`` (``tiled=False``: the dim has the group's size
    and is dropped), on its own device. Each slab is summed into a fresh
    tensor; a group of one hands back its tensor as it is."""
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
