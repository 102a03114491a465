"""Roofline counts of one step, op by op as ``torch`` dispatches it.

The port of ``repro.launch.costs``. ``repro`` walks the jaxpr of a traced
step (``jaxpr_cost``): it multiplies a scanned body by its trip count and
counts dot FLOPs from shapes, the bytes of the "major" ops, and the
collectives' payload. The port runs the step itself, eagerly, under
:class:`CostCounter`, a ``TorchDispatchMode`` that sees every ``aten`` op
the step runs: every period of the stack, the backward and the remat
recompute included (as ``jax.grad``'s jaxpr holds them), so no trip-count
correction is needed. On the meta device nothing is allocated or computed,
and the counts are the same as on the card.

It counts, in global terms (a dense layer runs whole on the mesh's home
device; a sharded MoE block's cells sum to the global work):

* **FLOPs** of ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``
  and ``convolution``, ``2 * batch * m * n * k`` (``einsum`` and
  ``matmul`` reach these ops), split by the first operand's dtype;
* **bytes** by class: ``dot``, operand plus result bytes of those ops;
  ``index``, the same of gather, scatter and index ops, ``sort`` /
  ``topk`` and slice updates (``repro``'s ``_MAJOR_BYTES_PRIMS``, which
  assume that elementwise ops fuse); ``inputs``, the step's inputs read
  once (:meth:`CostCounter.read_inputs`); and one class per kernel whose
  work is reckoned from its shapes (``rwkv6_chunk``, through
  ``core.cost_hook``);
* **collective payload bytes per device**, by kind, as the mesh
  collectives report them (``distributed.mesh``), with ``repro``'s wire
  factors: all-reduce x2, all-gather x(n - 1), the rest x1; each one's
  transpose reports in the backward.

Not ported: ``repro``'s ``hlo_collective_bytes``, which parses the
collectives GSPMD inserts into the compiled HLO. The port has no HLO and
inserts no implicit collective (its dense layers run whole on the home
device), so its total is the analytic total; the tensor- and data-parallel
all-gathers and reduce-scatters a partitioner would add are not counted.

``track_memory=True`` also follows the live storages (views share one;
each is freed through a weakref finalizer) for the peak of live bytes.

The counter makes the backward run on the calling thread
(``torch.autograd.set_multithreading_enabled(False)``), so that the
mode sees the backward's ops on the card too.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import cost_hook

__all__ = ["CostCounter", "KINDS", "nbytes"]

aten = torch.ops.aten

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_DOT_OPS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
            aten.mv.default, aten.dot.default, aten.convolution.default}

_INDEX_PACKETS = (
    aten.gather, aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
    aten.scatter_reduce, aten.scatter_reduce_, aten.index, aten.index_put, aten.index_put_,
    aten._index_put_impl_, aten.index_add, aten.index_add_, aten.index_copy,
    aten.index_copy_, aten.index_select, aten.embedding, aten.embedding_dense_backward,
    aten.take, aten.sort, aten.topk, aten.slice_scatter, aten.select_scatter,
    aten._unsafe_index, aten._unsafe_index_put, aten.masked_scatter, aten.masked_scatter_,
)
_INDEX_OPS = {getattr(p, o) for p in _INDEX_PACKETS for o in p.overloads()}
_SLICE_WRITES = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor}
_DECOMPOSES: dict = {}  # op -> whether it has a composite decomposition


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _dot_flops(func, args) -> tuple[float, torch.dtype]:
    """(2 * batch * m * n * k, the first operand's dtype) of one product."""
    if func is aten.convolution.default:
        x, w = args[0], args[1]
        out_elems = _conv_out_elems(args)
        # per output element: in_channels / groups * kernel taps multiply-adds
        return 2.0 * out_elems * (w.numel() // w.shape[0]), x.dtype
    if func in (aten.addmm.default, aten.baddbmm.default):
        args = args[1:]
    a, b = args[0], args[1]
    if func is aten.dot.default:
        return 2.0 * a.numel(), a.dtype
    if func is aten.mv.default:
        return 2.0 * a.numel(), a.dtype
    if a.dim() == 3:  # bmm: [batch, m, k] @ [batch, k, n]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], a.dtype
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1], a.dtype


def _conv_out_elems(args) -> int:
    x, w, _, stride, padding, dilation, transposed, output_padding, groups = args[:9]
    if transposed:
        raise NotImplementedError("transposed convolutions are not counted")
    spatial = []
    for i, size in enumerate(x.shape[2:]):
        k = w.shape[2 + i]
        spatial.append((size + 2 * padding[i] - dilation[i] * (k - 1) - 1) // stride[i] + 1)
    n = x.shape[0] * w.shape[0]
    for s in spatial:
        n *= s
    return n


class CostCounter(TorchDispatchMode):
    """Counts the ops run in its context (see the module docstring).

    ``n_devices`` is the mesh's size, for the collectives' bytes per
    device. Read ``flops`` ({dtype name: FLOPs}), ``bytes`` ({class:
    bytes}), ``collective_bytes`` ({kind: bytes per device}) and, with
    ``track_memory``, ``peak_bytes`` (live bytes at their peak, the
    storages registered by :meth:`read_inputs` included)."""

    def __init__(self, n_devices: int = 1, track_memory: bool = False):
        super().__init__()
        self.n_devices = n_devices
        self.track_memory = track_memory
        self.flops: dict[str, float] = collections.defaultdict(float)
        self.bytes: dict[str, float] = collections.defaultdict(float)
        self.collective_bytes: dict[str, float] = collections.defaultdict(float)
        self._scale = 1
        self._weight = 1  # live bytes of a new storage count this many times
        self._suppressed = 0
        self._live: dict[int, tuple] = {}
        self._unread: set[int] = set()
        self._token = itertools.count()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._stack = contextlib.ExitStack()
        self._depth = 0

    # -- totals ------------------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())

    def summary(self) -> dict:
        coll = {k: self.collective_bytes[k] for k in KINDS if k in self.collective_bytes}
        coll["total"] = sum(coll.values())
        return {"flops": dict(self.flops), "bytes": dict(self.bytes), "collective": coll}

    # -- the mode ------------------------------------------------------------------
    def __enter__(self):
        if self._depth == 0:
            if cost_hook.observer is not None:
                raise RuntimeError("a CostCounter is already counting")
            self._stack.enter_context(torch.autograd.set_multithreading_enabled(False))
            cost_hook.observer = self
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                cost_hook.observer = None
                self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        decomposes = _DECOMPOSES.get(func)
        if decomposes is None:
            decomposes = _DECOMPOSES[func] = func._can_decompose()
        if decomposes:
            # under inference_mode composite ops (matmul, einsum) reach the
            # mode whole: run their decomposition through it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._suppressed:
            if func in _DOT_OPS:
                flops, dtype = _dot_flops(func, args)
                self.flops[str(dtype).removeprefix("torch.")] += self._scale * flops
                self.bytes["dot"] += self._scale * self._io_bytes(args, kwargs, out)
            elif func in _INDEX_OPS:
                self.bytes["index"] += self._scale * self._io_bytes(args, kwargs, out)
            elif func in _SLICE_WRITES and _is_slice(args[0]):
                # a slice update: the region read in and written out, whether
                # a device writes a scalar (fill_) or a tensor of it (copy_)
                self.bytes["index"] += self._scale * 2 * nbytes(args[0])
        if self.track_memory:
            if self._unread:
                for t in _tensors((args, kwargs)):
                    self._unread.discard(t.untyped_storage()._cdata)
            for t in _tensors(out):
                self._track(t.untyped_storage(), self._weight)
        return out

    @staticmethod
    def _io_bytes(args, kwargs, out) -> int:
        return sum(nbytes(t) for t in _tensors((args, kwargs))) + sum(
            nbytes(t) for t in _tensors(out))

    # -- what the hook reports -----------------------------------------------------------
    def collective(self, kind: str, payload: int, factor: float) -> None:
        """One collective over a group whose cells send ``payload`` bytes
        together; counted per device of the mesh."""
        if not self._suppressed:
            self.collective_bytes[kind] += self._scale * factor * payload / self.n_devices

    @contextlib.contextmanager
    def scaled(self, n: int, memory: bool = True):
        """Count the work in this context ``n`` times; with ``memory``, its
        new storages too (``n`` cells at once, not ``n`` runs in turn)."""
        weight = n if memory else 1
        self._scale *= n
        self._weight *= weight
        try:
            yield
        finally:
            self._scale //= n
            self._weight //= weight

    def live_mark(self) -> int:
        """A mark for :meth:`live_since`."""
        return next(self._token)

    def live_since(self, mark: int) -> int:
        """Live bytes of the storages that appeared after ``mark``."""
        return sum(size for _, size, token in self._live.values() if token > mark)

    def hold(self, n_bytes: int) -> None:
        """Count ``n_bytes`` more as live (negative: release them)."""
        self.live_bytes += n_bytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    @contextlib.contextmanager
    def suspended(self):
        self._suppressed += 1
        try:
            yield
        finally:
            self._suppressed -= 1

    @contextlib.contextmanager
    def reckoned(self, name: str, flops: dict, nbytes_: int):
        if not self._suppressed:
            for dtype, f in flops.items():
                self.flops[str(dtype).removeprefix("torch.")] += self._scale * f
            self.bytes[name] += self._scale * nbytes_
        with self.suspended():
            yield

    def read_inputs(self, tree) -> None:
        """The step's inputs, read once (class ``inputs``); with
        ``track_memory`` their storages are live from here on, and
        :meth:`was_read` tells which of them an op took."""
        for t in _tensors(tree):
            self.bytes["inputs"] += nbytes(t)
            if self.track_memory:
                self._track(t.untyped_storage(), 1)
                self._unread.add(t.untyped_storage()._cdata)

    def reads(self, tensors) -> None:
        """Mark inputs as read (see ``core.cost_hook.reads``)."""
        for t in _tensors(tensors):
            self._unread.discard(t.untyped_storage()._cdata)

    def was_read(self, t: torch.Tensor) -> bool:
        """Whether an op took an input's storage (``jax.jit`` drops the
        arguments a step never reads)."""
        return t.untyped_storage()._cdata not in self._unread

    # -- live storages -----------------------------------------------------------------
    def _track(self, storage, weight: int) -> None:
        key = storage._cdata
        seen = self._live.get(key)
        if seen is not None and seen[0]() is storage:
            return
        if seen is not None:  # a freed storage's address, taken again
            self.live_bytes -= seen[1]
        size = storage.nbytes() * weight
        token = next(self._token)
        self._live[key] = (weakref.ref(storage), size, token)
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._freed, key, token)

    def _freed(self, key: int, token: int) -> None:
        seen = self._live.get(key)
        if seen is not None and seen[2] == token:
            del self._live[key]
            self.live_bytes -= seen[1]


def _is_slice(t: torch.Tensor) -> bool:
    """A copy into part of a larger storage: a slice update."""
    return nbytes(t) < t.untyped_storage().nbytes()
