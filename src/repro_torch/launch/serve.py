"""Serving entry point: initialise a model at random and serve batched generations.

The port of ``repro.launch.serve``; the default architecture is
``gemma3-1b``, as there. On the CPU, with the smoke config:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

On the GPU (the default device), the full deepseek-moe-16b, rwkv6-3b or
zamba2-2.7b (every arch of ``repro_torch.configs.ARCHS`` and ``PORT_ARCHS``
serves, deepseek-v2-lite too; the full deepseek-v3-671b does not fit one
card):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b --batch 8 \
      --prompt-len 512 --max-new 32 --max-len 544

Prompts are drawn from ``np.random.default_rng(seed)``. An audio model
(whisper-base) gets zero frames of its encoder's length, as ``repro``'s
server passes them. With ``--ckpt-dir``
the model's parameters come from the directory's latest checkpoint when it
has one; otherwise the freshly initialised parameters are saved there as
step 0, so a later run serves the same weights.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig


def load_or_save_params(model: torch.nn.Module, ckpt_dir: str) -> int | None:
    """Load ``model``'s parameters from the latest checkpoint under
    ``ckpt_dir`` and return its step; with no checkpoint there, save the
    current parameters as step 0 and return ``None``."""
    ckpt = Checkpointer(ckpt_dir)
    step = ckpt.latest_step()
    if step is None:
        ckpt.save(0, {"params": model.state_dict()}, blocking=True)
        return None
    model.load_state_dict(ckpt.restore(step, {"params": model.state_dict()})["params"])
    return step


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device, seed=args.seed)
    if args.ckpt_dir:
        step = load_or_save_params(model, args.ckpt_dir)
        print(f"saved checkpoint step 0 to {args.ckpt_dir}" if step is None
              else f"loaded checkpoint step {step}")
    engine = Engine(model, ServeConfig(max_len=args.max_len, temperature=args.temperature,
                                       seed=args.seed))
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int64
    )
    extras = None
    if cfg.frontend == "audio_stub":
        extras = {"frames": torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                                        device=model.device)}
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.max_new, extras)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {out.device} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print(out[:2].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
