"""Fault-tolerant training launcher (checkpoint/restart supervisor).

The port of ``repro.launch.train``, with its flags, defaults and printed
protocol, plus ``--device`` (the card unless ``--device cpu``; no fallback
to the CPU):

  - a deterministic token source keyed by step (restart-safe),
  - the train step of ``repro_torch.train.loop``,
  - async checkpoints every ``--ckpt-every`` steps (``checkpoint.checkpointer``),
  - a SUPERVISOR loop: any exception in the step loop (device loss, an
    injected ``--fail-at`` failure, a NaN loss) restores the latest
    checkpoint and resumes (``[supervisor] resumed from step N``);
    ``--max-failures`` bounds restart storms. An async save still being
    written when the failure hit is finished first, so the resume point
    does not depend on how fast the disk is (a failed write counts as one
    more failure),
  - preemption: touching ``<ckpt_dir>/PREEMPT`` makes the loop checkpoint
    and exit 42 at the next step boundary.

RWKV-6 models train on the plain chunked core (``rwkv_kernel=False``): the
``rwkv6_chunk`` kernel has no backward, as ``repro``'s Pallas kernel has
none and ``repro`` trains on its plain core too.

On the CPU, with the smoke config:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --smoke \\
      --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models.model import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import OptConfig

__all__ = ["build_parser", "main", "run"]


def run(args, history: list | None = None) -> int:
    """Train as ``args`` say; 0 when done, 42 on preemption. With
    ``history``, each completed step appends ``(step, loss, grad_norm)``
    (Python floats)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=device, rwkv_kernel=False, seed=args.seed)
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=min(20, args.steps // 10 + 1))
    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    data = make_source(
        DataConfig(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq, seed=args.seed)
    )
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)

    failures = 0
    while True:
        try:
            # ---- (re)initialize or restore -------------------------------
            ckpt.wait()  # a save in flight when a failure hit completes first
            start = ckpt.latest_step()
            state = init_train_state(model, opt_cfg)
            if start is not None:
                state = ckpt.restore(start, state)
                print(f"[supervisor] resumed from step {start}")
            step0 = start or 0

            t_last = time.time()
            for step in range(step0, args.steps):
                if os.path.exists(os.path.join(args.ckpt_dir, "PREEMPT")):
                    print("[supervisor] preemption requested; checkpointing")
                    ckpt.save(step, state, blocking=True)
                    return 42
                batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(step).items()}
                if args.fail_at is not None and step == args.fail_at and failures == 0:
                    raise RuntimeError("injected failure (test)")
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                if loss != loss:
                    raise FloatingPointError(f"loss NaN at step {step}")
                if history is not None:
                    history.append((step, loss, float(metrics["grad_norm"])))
                if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
                    ckpt.save(step + 1, state)
                if (step + 1) % args.log_every == 0:
                    dt = time.time() - t_last
                    t_last = time.time()
                    print(
                        f"step {step + 1}: loss={loss:.4f} "
                        f"gnorm={float(metrics['grad_norm']):.3f} "
                        f"lr={float(metrics['lr']):.2e} ({dt / args.log_every:.2f}s/step)"
                    )
            ckpt.wait()
            print("[supervisor] training complete")
            return 0
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # noqa: BLE001 — the supervisor's whole job
            failures += 1
            print(f"[supervisor] failure #{failures}: {type(e).__name__}: {e}")
            if failures > args.max_failures:
                print("[supervisor] failure budget exhausted")
                raise
            time.sleep(args.restart_delay)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-failures", type=int, default=3)
    ap.add_argument("--restart-delay", type=float, default=0.5)
    ap.add_argument("--fail-at", type=int, default=None, help="inject a failure (testing)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: list[str] | None = None):
    raise SystemExit(run(build_parser().parse_args(argv)))


if __name__ == "__main__":
    main()
