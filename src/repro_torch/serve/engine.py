"""Batched LM serving engine: prefill + decode over per-layer caches.

The port of ``repro.serve.engine``: one prefill over the prompts, then one
single-token decode step per new token over a fixed batch; greedy or
temperature sampling. Tokens stay on the model's device: greedy decoding
never waits for the host between tokens.

Temperature sampling is Gumbel-max, ``argmax(logits / T + Gumbel noise)``,
the form ``jax.random.categorical`` uses, with the noise drawn from a
``torch.Generator`` seeded from ``ServeConfig.seed`` on the model's device.
The two frameworks draw different numbers from one seed, so parity with
``repro`` is held on greedy decoding.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Engine", "ServeConfig"]


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0  # 0 = greedy
    seed: int = 0


class Engine:
    def __init__(self, model, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg

    @torch.inference_mode()
    def generate(self, tokens, max_new: int, batch_extras: dict | None = None) -> torch.Tensor:
        """tokens: [B, S_prompt] integers (a tensor or an array; right-aligned,
        no padding). ``batch_extras`` goes to the prefill: the frontends'
        ``frames`` (audio) or ``prefix_embeddings`` (vision). Returns
        [B, max_new] int64 on the model's device."""
        dev = self.model.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, s = tokens.shape
        if max_new <= 0:
            return torch.zeros((b, 0), dtype=torch.long, device=dev)
        if s + max_new > self.cfg.max_len:
            # repro's engine keeps ring-buffer KV caches of max_len; the same
            # bound holds here so both refuse the same requests
            raise ValueError(
                f"prompt ({s}) + max_new ({max_new}) exceeds max_len "
                f"({self.cfg.max_len}): decode would run off the KV cache"
            )
        caches = self.model.init_caches(b, self.cfg.max_len)
        logits, caches = self.model.prefill(tokens, caches, batch_extras)
        gen = None
        if self.cfg.temperature > 0.0:
            gen = torch.Generator(device=dev).manual_seed(self.cfg.seed)
        cur = self._sample(logits[:, -1], gen)
        out = [cur]
        # max_new - 1 decode steps: the last output token needs no forward pass
        for t in range(max_new - 1):
            pos = torch.full((b, 1), s + t, dtype=torch.long, device=dev)
            logits, caches = self.model.decode_step(cur[:, None], pos, caches)
            cur = self._sample(logits[:, 0], gen)
            out.append(cur)
        return torch.stack(out, dim=1)

    def _sample(self, logits: torch.Tensor, gen: torch.Generator | None) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        uniform = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(uniform.clamp_min(torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits / self.cfg.temperature + gumbel, dim=-1)
