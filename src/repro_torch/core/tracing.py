"""Profiler spans inside the event engine's step and the LM's layers.

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

In the language models, read by ``perfbench/drivers/lm_prefill.py`` per
prefill batch:

* ``repro_torch.mla``: ``models/mla.py`` ``mla_layer``, every MLA layer's
  projections, rope, attention and output projection
  (``mla_ms_per_prefill``);
* ``repro_torch.moe``: ``backbone.Block``'s MoE FFN, the shared experts
  included, on every dispatch path;
* ``repro_torch.moe.dispatch``: inside it, ``models/moe.py``
  ``moe_local`` / ``moe_dropless``'s router, top-k, ``dispatch_slots``,
  gathers and scatters, and the combine (``moe_dispatch_ms_per_prefill``);
* ``repro_torch.moe.experts``: inside it, the routed experts' gated FFN
  (``expert_ffn_ms_per_prefill``, ``expert_ffn_roofline``).

The MoE's counters are not spans: each period's assignments per expert
(``moe_load_periods`` ``[n_periods, E]``; DeepSeek-V2-Lite's period is one
MoE layer) and, dropless, each MoE layer's assignments dropped (0 by
construction) and its tokens' expert choices (``moe_dropped`` ``[n_moe]``,
``moe_choices``) come back in the forward's ``aux``
(``Model.prefill(..., return_aux=True)``), on the device, for the caller's
one wait (``expert_load_max_over_mean`` and ``correct``'s
``dropped_assignments``).

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
