"""Event-driven SNN engine: two-stage routing + neuron dynamics, PyTorch.

Counterpart of ``repro.core.event_engine`` for the queued, non-fabric path:

  spikes[t] --AER queue--> stage1 --> tag activity A[c, k] --stage2/CAM-->
           drive[N, 4] --AdExp/DPI--> spikes[t+1]

External stimulation enters as tag activity (events addressed to (cluster,
tag)). The carry and inputs may bear a leading batch dimension ``B``: B
independent event streams stepped against one set of routing tables.
Delivery goes through a dispatch backend (``reference``, ``cuda`` or
``fused``; core/dispatch.py).

``EventEngine.reset_slots(carry, mask)`` restores masked slots to fresh
state so a session pool can admit and evict tenants independently.

``dense_reference_step`` is the oracle: the same network as one dense
``[N, N, 4]`` connectivity tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import neuron as neuron_mod
from repro_torch.core.dispatch import DeliveryStats, DispatchBackend, get_backend
from repro_torch.core.neuron import NeuronParams, NeuronState
from repro_torch.core.tags import RoutingTables
from repro_torch.core.two_stage import N_SYN_TYPES, precompute_syn_onehot

__all__ = [
    "EventEngine",
    "DeliveryStats",
    "reset_slots",
    "dense_weights_from_tables",
    "dense_reference_step",
]


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class _Tables:
    src_tag: torch.Tensor
    src_dest: torch.Tensor
    cam_tag: torch.Tensor
    cam_syn: torch.Tensor
    # per-table constant [N, S, 4]: one-hot synapse types, precomputed once
    cam_syn_onehot: torch.Tensor


class EventEngine:
    """Executable DYNAPs fabric for a compiled network (queued, non-fabric).

    ``queue_capacity=Q`` compacts each step's spikes into a fixed-capacity
    AER queue before stage 1, and ``step``/``run`` then also return a
    :class:`DeliveryStats`. The engine runs on ``device`` (CUDA unless the
    caller asks for the CPU).
    """

    def __init__(
        self,
        tables: RoutingTables,
        params: NeuronParams | None = None,
        backend: str | DispatchBackend = "reference",
        queue_capacity: int | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = resolve_device(device)
        self.params = params or NeuronParams()
        self.cluster_size = tables.cluster_size
        self.k_tags = tables.k_tags
        self.n_neurons = tables.n_neurons
        self.n_clusters = tables.n_clusters
        if queue_capacity is not None and queue_capacity <= 0:
            raise ValueError(f"queue_capacity must be positive, got {queue_capacity}")
        self.queue_capacity = queue_capacity
        self.backend = get_backend(backend)

        def table(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=self.device)

        cam_syn = table(tables.cam_syn)
        self.tables = _Tables(
            src_tag=table(tables.src_tag),
            src_dest=table(tables.src_dest),
            cam_tag=table(tables.cam_tag),
            cam_syn=cam_syn,
            cam_syn_onehot=precompute_syn_onehot(cam_syn),
        )

    def init_state(
        self, batch: int | tuple[int, ...] | None = None
    ) -> tuple[NeuronState, torch.Tensor]:
        """(neuron state, previous-step spikes); batched when ``batch`` set."""
        lead = () if batch is None else (batch,) if isinstance(batch, int) else tuple(batch)
        return (
            neuron_mod.init_state(self.n_neurons, self.params, batch=batch, device=self.device),
            torch.zeros((*lead, self.n_neurons), dtype=torch.float32, device=self.device),
        )

    def _as_input(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def step(self, carry, input_activity, i_ext=None):
        """One fabric timestep.

        ``input_activity [..., n_clusters, K]`` (numpy or tensor) is this
        step's external tag activity. Returns ``(carry, spikes)``, or
        ``(carry, (spikes, DeliveryStats))`` when the engine was built with
        ``queue_capacity``.

        The returned carry holds new tensors; the carry passed in is never
        updated in place and stays readable (``repro``'s ``donate_carry``
        has no counterpart here).
        """
        state, prev_spikes = carry
        dtype = prev_spikes.dtype
        input_activity = self._as_input(input_activity, dtype)
        if i_ext is not None:
            i_ext = self._as_input(i_ext, dtype)
        t = self.tables
        drive, stats = self.backend.deliver(
            prev_spikes,
            t.src_tag,
            t.src_dest,
            t.cam_tag,
            t.cam_syn,
            self.cluster_size,
            self.k_tags,
            external_activity=input_activity,
            queue_capacity=self.queue_capacity,
            syn_onehot=t.cam_syn_onehot,
            with_stats=True,
        )
        state, spikes = neuron_mod.neuron_step(state, drive, self.params, i_ext)
        out = spikes if self.queue_capacity is None else (spikes, stats)
        return (state, spikes), out

    def reset_slots(self, carry, mask):
        """Per-slot state surgery for multi-tenant serving.

        ``mask`` is a boolean array over the carry's leading batch dims
        (``True`` = wipe that slot). Masked slots go back to the fresh state
        of :meth:`init_state` (neuron state at rest, previous-step spikes
        cleared); unmasked slots are untouched, bit for bit.
        """
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=self.device)
        if mask.ndim < 1:
            raise ValueError("reset_slots needs a batched carry (mask per slot)")
        lead = tuple(carry[1].shape[: mask.ndim])
        if tuple(mask.shape) != lead:
            raise ValueError(
                f"reset mask shape {tuple(mask.shape)} does not match the "
                f"carry's slot dims {lead} — a mis-sized mask must raise, "
                "not broadcast (it would wipe the wrong tenants)"
            )
        fresh = self.init_state(batch=tuple(mask.shape))
        return reset_slots(carry, mask, fresh)

    def run(self, carry, input_events, i_ext=None):
        """Step T times; returns ``(final carry, spikes [T, ..., N])`` — with
        ``queue_capacity`` set, ``(final carry, (spikes [T, ..., N],
        DeliveryStats stacked over T))``.

        ``i_ext`` may be time-varying: a ``[T, ..., N]`` current (one more
        leading axis than the spike state, first axis of length ``T``) is
        stepped alongside ``input_events``. Anything of the spike state's
        rank or below is a per-step constant.
        """
        t_steps = input_events.shape[0]
        i_shape = () if i_ext is None else tuple(np.shape(i_ext))
        time_varying = len(i_shape) == carry[1].ndim + 1 and i_shape[0] == t_steps
        outs = []
        for t in range(t_steps):
            carry, out = self.step(
                carry, input_events[t], i_ext[t] if time_varying else i_ext
            )
            outs.append(out)
        if self.queue_capacity is None:
            return carry, torch.stack(outs)
        spikes = torch.stack([s for s, _ in outs])
        dropped = torch.stack([st.dropped for _, st in outs])
        return carry, (spikes, DeliveryStats(dropped=dropped))


def reset_slots(carry, mask: torch.Tensor, fresh):
    """Replace masked slots of ``carry`` with the matching slots of ``fresh``.

    ``carry`` and ``fresh`` are tuples of tensors and :class:`NeuronState`s
    of identical shapes whose leading dims start with ``mask``'s shape. Kept
    standalone so custom serving loops can splice any per-slot state.
    """

    def sel(cur, new):
        if cur.ndim < mask.ndim:
            return cur
        if tuple(cur.shape[: mask.ndim]) != tuple(mask.shape):
            raise ValueError(
                f"mask shape {tuple(mask.shape)} does not match carry leaf "
                f"slot dims {tuple(cur.shape[: mask.ndim])} — refusing to "
                "broadcast a mis-sized mask across slots"
            )
        m = mask.reshape(mask.shape + (1,) * (cur.ndim - mask.ndim))
        return torch.where(m, new.to(cur.dtype), cur)

    def leaf(cur, new):
        if isinstance(cur, NeuronState):
            return NeuronState(
                **{f.name: sel(getattr(cur, f.name), getattr(new, f.name))
                   for f in dataclasses.fields(NeuronState)}
            )
        return sel(cur, new)

    return tuple(leaf(c, f) for c, f in zip(carry, fresh, strict=True))


def dense_weights_from_tables(tables: RoutingTables) -> np.ndarray:
    """[N, N, 4] dense fan-in counts implied by the routing tables."""
    n = tables.n_neurons
    w = np.zeros((n, n, N_SYN_TYPES), dtype=np.float32)
    for src, dst, syn in tables.dense_equivalent():
        w[dst, src, syn] += 1.0
    return w


def dense_reference_step(
    dense_w: torch.Tensor,  # [N, N, 4]
    prev_spikes: torch.Tensor,  # [..., N]
    state: NeuronState,
    params: NeuronParams,
    external_drive: torch.Tensor | None = None,  # [..., N, 4]
    i_ext: torch.Tensor | None = None,
):
    """Oracle step: dense matmul delivery instead of two-stage routing."""
    drive = torch.einsum("dst,...s->...dt", dense_w, prev_spikes)
    if external_drive is not None:
        drive = drive + external_drive
    return neuron_mod.neuron_step(state, drive, params, i_ext)
