"""The comparison that decides ``correct``.

The program's answers for the checked batches (each stream's output spike
counts and route counts, and its neuron state after the stream's steps) are
held to the reference's on the same activity. Each number has a limit, set
in the cell's file; a number above its limit makes the run not correct:

* ``count_gap``: the output spikes the program puts on a different
  (stream, neuron) than the reference, ``sum |p - r| / sum r``;
* ``state_gap``: per state leaf (``v``, ``w``, ``refrac``, ``i_syn``),
  ``rms(p - r) / rms(r)`` over every checked stream and neuron, the largest
  leaf's;
* ``route_gap`` (on a board): the link drops, the SRAM entries routed and
  their mesh hops that differ, ``sum |p - r|`` over the reference's entries
  and hops;
* ``queue_drops``: events the program's AER queue dropped, which the
  configuration's lossless queue never does;
* ``ref_overflow``: events a queue or link of the reference would have
  lost; the reference does not model which, so none may be.
"""

from __future__ import annotations

import dataclasses

import torch

from perfbench.reference.simulate import ROUTE_COLUMNS, Outcome

STATE_LEAVES = ("v", "w", "refrac", "i_syn")


@dataclasses.dataclass
class Answer:
    """The program's result for one batch: ``counts [B, n_out]`` and
    ``route [B, 4]`` (``ROUTE_COLUMNS``) on the host, and its final state's
    leaves (``STATE_LEAVES``) on the device."""

    counts: torch.Tensor
    route: torch.Tensor
    state: dict[str, torch.Tensor]


def numbers(answers: list[Answer], outcomes: list[Outcome],
            board: bool) -> tuple[dict[str, float], int]:
    """The numbers, and how many checked streams have an answer (counts or
    route counts) that differs from the reference's."""
    cnt_gap = cnt_ref = 0.0
    differ = 0
    route_gap = route_ref = 0.0
    drops = overflow = 0.0
    sq_gap = {k: 0.0 for k in STATE_LEAVES}
    sq_ref = {k: 0.0 for k in STATE_LEAVES}
    for ans, ref in zip(answers, outcomes):
        rc = ref.counts.double().cpu()
        cnt_gap += float((ans.counts.double() - rc).abs().sum())
        cnt_ref += float(rc.sum())
        rr = ref.route.double().cpu()
        pr = ans.route.double()
        wrong = (ans.counts.double() != rc).any(-1)
        if board:
            wrong |= (pr != rr).any(-1)
        differ += int(wrong.sum())
        drops += float(pr[:, ROUTE_COLUMNS.index("queue_dropped")].sum())
        overflow += float(rr[:, :2].sum())
        if board:
            route_gap += float((pr[:, 1:] - rr[:, 1:]).abs().sum())
            route_ref += float(rr[:, 2:].sum())
        for k in STATE_LEAVES:
            r = getattr(ref.state, k).double()
            p = ans.state[k].to(r.device).double()
            sq_gap[k] += float(((p - r) ** 2).sum())
            sq_ref[k] += float((r**2).sum())
    out = {
        "count_gap": cnt_gap / max(cnt_ref, 1.0),
        "state_gap": max((sq_gap[k] / sq_ref[k]) ** 0.5 if sq_ref[k] > 0 else
                         (0.0 if sq_gap[k] == 0 else float("inf")) for k in STATE_LEAVES),
    }
    if board:
        out["route_gap"] = route_gap / max(route_ref, 1.0)
    out["queue_drops"] = drops
    out["ref_overflow"] = overflow
    return out, differ


def verdict(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[str]]:
    """Whether every number keeps to its limit, and a line per number:
    its plain name, its value and its limit."""
    lines, ok = [], True
    for name, value in values.items():
        limit = limits[name]
        held = value <= limit
        ok = ok and held
        lines.append(f"{name} {value!r} limit {limit!r}{'' if held else ' FAILED'}")
    return ok, lines
