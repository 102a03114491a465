"""The hook through which work that a dispatch mode cannot see is counted.

``launch.costs.CostCounter`` counts a step's products and major bytes op
by op, as ``torch`` dispatches them. Three kinds of work escape it, and
report here while a counter is set (``observer`` is None otherwise, and
each call site pays one None check):

* the mesh collectives (``distributed.mesh``), compositions of ``narrow``,
  ``cat`` and ``+`` that no op tells apart from others: each reports its
  kind and payload, in the forward and as its transpose in the backward;
* a kernel reckoned as a whole (``kernels.rwkv6.ops``): its products and
  bytes from its shapes, whichever version runs, with the plain version's
  op-by-op count suppressed under it;
* work run once for all on the meta device, where identical work is the
  same shapes alone: a mesh's cells (``DeviceMesh.map_cells``) and a
  stack's scanned periods (:func:`stand_in`, the counterpart of ``repro``'s
  scan body times its trip count), counted once per cell or period; what
  the skipped runs would have read is marked read (:func:`reads_as`).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["observer", "reads_as", "reckoned", "scaled", "stand_in", "suspended"]

observer = None  # the active launch.costs.CostCounter, or None


def scaled(n: int, memory: bool = True):
    """Count the work in this context ``n`` times; with ``memory``, its new
    storages too (``n`` cells at once, not ``n`` runs one after another)."""
    return observer.scaled(n, memory) if observer is not None else contextlib.nullcontext()


def suspended():
    """Count nothing in this context."""
    return observer.suspended() if observer is not None else contextlib.nullcontext()


def reckoned(name: str, flops: dict, nbytes: int):
    """Count ``flops`` (by operand dtype) and ``nbytes`` (in the class
    ``name``) once for the work in this context, and none of its ops."""
    if observer is None:
        return contextlib.nullcontext()
    return observer.reckoned(name, flops, nbytes)


def reads_as(ran: list, stood_in: list) -> None:
    """Mark each tensor of ``stood_in`` as read where its counterpart in
    ``ran`` was: the inputs of the runs a :func:`stand_in` stood for."""
    if observer is not None:
        observer.reads([b for a, b in zip(ran, stood_in, strict=True) if observer.was_read(a)])


def stand_in(fn, n: int, inputs: list, params: list) -> tuple:
    """``fn(*inputs)`` (a tuple of tensors or None) run once and counted
    ``n`` times, forward and backward: ``params`` are the parameters ``fn``
    reads, which take its gradients. The backward runs ``fn``'s own graph
    (a checkpoint inside it recomputes as it would), counted ``n`` times.
    The ``n`` runs come one after another: what one run allocates and frees
    counts once toward the live bytes, what it keeps for the backward ``n``
    times."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (*inputs, *params))):
        with scaled(n, memory=False):
            return fn(*inputs)
    keep = [i for i, t in enumerate(params) if t.requires_grad]
    got = _StandIn.apply(fn, n, len(inputs), *inputs, *(params[i] for i in keep))
    return tuple(got[:-1])


class _StandIn(torch.autograd.Function):
    """:func:`stand_in`: the forward keeps ``fn``'s graph and hands back its
    outputs; the backward differentiates that graph, counted ``n`` times."""

    @staticmethod
    def forward(ctx, fn, n, n_in, *tensors):
        ctx.set_materialize_grads(False)
        ins = [t.detach().requires_grad_(t.requires_grad) for t in tensors[:n_in]]
        mark = observer.live_mark() if observer is not None else 0
        with torch.enable_grad(), scaled(n, memory=False):
            outs = tuple(fn(*ins))
        # the other n - 1 runs keep as much for their backward
        ctx.held = (n - 1) * observer.live_since(mark) if observer is not None else 0
        if ctx.held:
            observer.hold(ctx.held)
        ctx.n, ctx.graph = n, (ins, tensors[n_in:], outs)
        # a trailing None keeps the output count fixed whatever ``fn`` returns
        return (*(None if o is None else o.detach() for o in outs), None)

    @staticmethod
    def backward(ctx, *grads):
        ins, params, outs = ctx.graph
        del ctx.graph
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if o is not None and o.requires_grad and g is not None]
        wanted = [t for t in (*ins, *params) if t.requires_grad]
        found = {}
        if pairs and wanted:
            with scaled(ctx.n, memory=False):
                got = torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                          allow_unused=True)
            found = {id(t): g for t, g in zip(wanted, got)}
        if ctx.held and observer is not None:
            observer.hold(-ctx.held)
        return (None, None, None, *(found.get(id(t)) for t in (*ins, *params)))
