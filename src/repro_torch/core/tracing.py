"""Profiler spans inside the event engine's step.

Spans exist only while a torch profiler runs (``torch.profiler.profile``):
:func:`span` then opens a ``torch.profiler.record_function``, which puts the
span on the profiler's host timeline, on the clock of its device trace.
Otherwise it hands back one shared no-op context, at the cost of reading the
profiler's own flag. No option and no environment variable turns them on.

The spans (parents by nesting on the host thread), where each sits, and
what ``perfbench/spans.py`` reads from it: the device time of the
operations launched while it was open, per engine step, under the name its
``split`` gives it:

* ``repro_torch.run``: ``EventEngine.run``, the step loop and the stacking
  of spikes and ``DeliveryStats``;
* ``repro_torch.step``: ``EventEngine.step``, input conversion, delivery and
  the neuron step; it labels the idle gaps that open inside the engine;
* ``repro_torch.deliver``: the delivery call of ``EventEngine.step`` on
  every path, its kernel included: less the delivery kernels, the delivery
  glue (``delivery_glue_ms_per_step``);
* ``repro_torch.deliver.queue``: inside the delivery, the AER queue:
  ``core/two_stage.py`` ``compact_events`` (every caller), and
  ``kernels/fabric_deliver/ops.py`` ``fabric_deliver_ring``'s queue
  admission and link arbitration (``queue_ms_per_step``);
* ``repro_torch.neuron``: ``neuron_step`` in ``EventEngine.step``, the
  AdExp/DPI update (``neuron_ms_per_step``).

The profiler mirrors each span onto the device's timeline under its name;
:func:`device_ops` leaves those ranges out of a trace's device operations.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` named ``name`` while a torch profiler runs,
    else the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def device_ops(events) -> list:
    """The device's operations among a profiler's ``events``: its kernels,
    copies and fills, without the device-side mirrors of host spans (those
    carry a host event's name and are not operations)."""
    host = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in host]
