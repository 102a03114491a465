"""The comparison that decides ``correct`` in a language-model prefill cell.

The program's answers for the checked batches are held to the plain
reference's (``reference/deepseek_v2_lite.py``) on the same prompts and the
same weights. Each number has a limit in the cell's file; a number above
its limit makes the run not correct:

* ``logits_gap``: the last position's logits, ``rms(p - r) / rms(r)`` over
  every checked prompt: what a user of the prefill receives;
* ``route_gap``: the share of routed assignments (token, MoE layer, expert)
  whose expert is not among the reference's ``k`` for that token and layer:
  a router that reads other numbers sends tokens elsewhere. Two experts of
  near-equal probability that swap ranks inside the chosen ``k`` move the
  layer's output by little and count nothing; an expert swapped in for
  another counts once;
* ``cache_gap``: the last layer's latent ``c_kv`` and rotated rope key
  ``k_rope``, the larger of the two ``rms(p - r) / rms(r)``: what decoding
  would read from the cache;
* ``dropped_assignments``: assignments the program's expert dispatch did
  not deliver, which a dropless configuration never has.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class LmAnswer:
    """One batch's result: ``logits [B, V]`` float32, the MoE counters
    ``load [n_moe, E]`` and ``dropped [n_moe]`` on the host, and
    ``choices [n_moe, B * S, k]``, the last layer's ``c_kv [B, S, kv_lora]``
    and ``k_rope [B, S, rope]`` where the program left them."""

    logits: torch.Tensor
    load: torch.Tensor
    dropped: torch.Tensor
    choices: torch.Tensor
    c_kv: torch.Tensor
    k_rope: torch.Tensor


def _sq(p: torch.Tensor, r: torch.Tensor) -> tuple[float, float]:
    r = r.double().cpu()
    return float(((p.double().cpu() - r) ** 2).sum()), float((r**2).sum())


def missed(choices: torch.Tensor, ref_choices: torch.Tensor) -> torch.Tensor:
    """Per MoE layer, the routed assignments ``choices [n_moe, T, k]`` whose
    expert is not among ``ref_choices [n_moe, T, k]`` for the same token:
    int64 ``[n_moe]``."""
    hit = (choices[..., :, None] == ref_choices[..., None, :]).any(-1)
    return (~hit).sum((1, 2))


def numbers(answers: list[LmAnswer], refs: list[dict]) -> tuple[dict[str, float], int]:
    """The numbers, and how many checked prompts failed outright: a logit
    that is not finite, or a dropped assignment in their batch. (Rounding
    moves every prompt's logits a little, so a gap alone fails none.)"""
    gap = {k: [0.0, 0.0] for k in ("logits", "c_kv", "k_rope")}
    differ = total = 0
    dropped = 0.0
    failed = 0
    for ans, ref in zip(answers, refs):
        for key in gap:
            g, n = _sq(getattr(ans, key), ref[key])
            gap[key][0] += g
            gap[key][1] += n
        rc = ref["choices"].to(ans.choices.device)
        differ += int(missed(ans.choices, rc).sum())
        total += rc.numel()
        dropped += float(ans.dropped.sum())
        broken = ~torch.isfinite(ans.logits).all(-1)
        failed += len(broken) if float(ans.dropped.sum()) else int(broken.sum())

    def rel(key):
        g, n = gap[key]
        return (g / n) ** 0.5 if n > 0 else (0.0 if g == 0 else float("inf"))

    return {
        "logits_gap": rel("logits"),
        "route_gap": differ / max(total, 1),
        "cache_gap": max(rel("c_kv"), rel("k_rope")),
        "dropped_assignments": dropped,
    }, failed
