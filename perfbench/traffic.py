"""The general generator of traffic: batches of synthetic DVS streams, made
on the device from a traffic mix's parameters and the seed.

A stream is ``steps`` engine steps in which a poker suit is flashed to a
32x32 DVS sensor: ``events_per_step`` events a step while the symbol is
on, for ``on_steps`` consecutive steps from an onset drawn in ``[0,
onset_max]``, and none otherwise. The suit's event cloud follows the
reproduction's synthetic DVS source: a vertical or horizontal bar of
jittered events, or an upward or downward chevron. Batch ``index`` of seed
``seed`` draws its suits, onsets and events from a generator seeded with
(seed, index) alone, so a batch can be made again after the window.

Events become external tag activity as the CNN's input encoding has it:
the pixel id ``y * input_hw + x`` is the tag, and the row of each conv core
(``input_clusters``, a range ``[start, stop)``) counts the events of its
tag, times the input ``drive``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WARM_UP = -1  # the index of the batch set-up runs, outside the window's


def generator(seed: int, index: int, device) -> torch.Generator:
    entropy = [int(seed) % 2**64, 0 if index == WARM_UP else 1, max(index, 0)]
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


@functools.lru_cache(maxsize=None)
def _suit_table(suits: tuple[int, ...], device: str) -> torch.Tensor:
    """The mix's suits on the device, made once (not a copy per batch)."""
    return torch.tensor(suits, device=device)


def _event_pixels(mix: dict, hw: int, suits: torch.Tensor, shape, gen, device):
    """``(y, x)`` pixel rows ``[T, B, E]`` of each stream's suit."""
    s = hw / 32.0  # the geometry scales with the sensor
    jitter = mix["jitter"]
    along = torch.randint(int(6 * s), int(26 * s), shape, generator=gen, device=device).float()
    noise = torch.randn(shape, generator=gen, device=device) * jitter
    t = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
    suit = suits.view(1, -1, 1)
    bar = 15 * s + noise
    chevron_x = 16 * s + t * 10 * s + noise
    ys = torch.where(suit == 0, along, torch.where(
        suit == 1, bar, torch.where(suit == 2, 8 * s + t.abs() * 14 * s, 24 * s - t.abs() * 14 * s)))
    xs = torch.where(suit == 0, bar, torch.where(suit == 1, along, chevron_x))
    hi = hw - 1
    return ys.clamp(0, hi).long(), xs.clamp(0, hi).long()


def activity(mix: dict, encoding: dict, batch: int, seed: int, index: int,
             device) -> torch.Tensor:
    """Tag activity ``[steps, batch, n_clusters, K]`` float32 of one batch."""
    gen = generator(seed, index, device)
    steps, per_step = mix["steps"], mix["events_per_step"]
    hw = encoding["input_hw"]
    suits = _suit_table(tuple(mix["suits"]), str(device))[
        torch.randint(len(mix["suits"]), (batch,), generator=gen, device=device)]
    onset = torch.randint(mix["onset_max"] + 1, (batch,), generator=gen, device=device)
    shape = (steps, batch, per_step)
    ys, xs = _event_pixels(mix, hw, suits, shape, gen, device)
    t = torch.arange(steps, device=device).view(-1, 1)
    on = ((t >= onset) & (t < onset + mix["on_steps"])).float()  # [T, B]
    counts = torch.zeros((steps, batch, hw * hw), device=device)
    counts.scatter_add_(2, ys * hw + xs, on[..., None].expand(shape).contiguous())
    act = torch.zeros((steps, batch, encoding["n_clusters"], encoding["k_tags"]), device=device)
    c0, c1 = encoding["input_clusters"]
    act[:, :, c0:c1, :hw * hw] = (counts * encoding["drive"])[:, :, None, :]
    return act
