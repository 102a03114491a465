"""Serving entry point: initialise a model at random and serve batched generations.

The port of ``repro.launch.serve``. On the CPU, with the smoke config:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu

On the GPU (the default device), the full rwkv6-3b:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --batch 8 \
      --prompt-len 512 --max-new 32 --max-len 544

Prompts are drawn from ``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv: list[str] | None = None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
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
    if args.ckpt_dir:
        raise NotImplementedError(
            "--ckpt-dir: checkpoints are not ported to repro_torch yet "
            "(ROADMAP queue 1, 'Faults and recovery')"
        )

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device, seed=args.seed)
    engine = Engine(model, ServeConfig(max_len=args.max_len, temperature=args.temperature,
                                       seed=args.seed))
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int64
    )
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.max_new)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {out.device} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print(out[:2].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
