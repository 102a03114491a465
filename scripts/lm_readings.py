#!/usr/bin/env python3
"""Readings that a language-model cell's ``correct`` limits are set from, on
one NVIDIA GPU.

    python3 scripts/lm_readings.py --workload deepseek-v2-lite.prefill4k \\
        --seeds 1,2,3 --control-seeds 4,5 --witness-seeds 6,7 \\
        [--control-dtype float8_e4m3fn] [--router-layers 0,12,25] \\
        [--out build/lm_readings.jsonl]

For each of ``--seeds``: the program's answers on the checked batches of a
run with that seed (the timed path, at the cell's sizes), held to the
float32 reference: the lower readings. For each of ``--control-seeds``: the
reference with every matrix product's inputs rounded to
``--control-dtype`` (the precision below the configuration's bfloat16)
put in the program's place: the upper readings. For each of
``--witness-seeds``: the reference in float64 held to the float32 one, how
far float32's own rounding moves the numbers. Each reading also gives
``route_gap`` per MoE layer (``route_gap_by_layer``) and the share of (token,
layer, rank) choices that differ (``rank_gap``, ``rank_gap_by_layer``),
which also counts two chosen experts that swap ranks.

``--router-layers`` (MoE layer indices, from 0) adds, on the first of
``--seeds``, the program's router (``models.moe.route`` with the program's
weights) fed the reference's own float32 MoE inputs at those layers, as they
are and rounded to bfloat16 as the program's activations are: its choices
held to the reference's there, with no drift of the layers below.

One JSON line per reading, with the seconds the comparison took, also
appended to ``--out``. This is ``perfbench/control.py`` with the control's
precision as an option; the benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.reference import deepseek_v2_lite as reference  # noqa: E402
from perfbench.reference.compare_lm import missed, numbers  # noqa: E402


def by_layer(answers, refs) -> dict:
    """``route_gap`` and ``rank_gap`` in total and per MoE layer."""
    miss = ranks = total = 0
    for ans, ref in zip(answers, refs):
        rc = ref["choices"].to(ans.choices.device)
        miss = miss + missed(ans.choices, rc).cpu()
        ranks = ranks + (ans.choices != rc).sum((1, 2)).cpu()
        total += rc[0].numel()
    return {"rank_gap": float(ranks.sum()) / (total * len(ranks)),
            "route_gap_by_layer": (miss / total).tolist(),
            "rank_gap_by_layer": (ranks / total).tolist()}


def router_on_reference(system, seed: int, index: int, layers) -> list[dict]:
    """The program's router on the reference's float32 MoE inputs of batch
    ``index`` at MoE ``layers``, as they are and rounded to bfloat16."""
    from repro_torch.models import moe

    kept, calls, plain_moe = {}, [0], reference._moe

    def keep(m, cfg, x, w):
        y, top_i = plain_moe(m, cfg, x, w)
        if calls[0] in layers:
            kept[calls[0]] = (x, top_i)
        calls[0] += 1
        return y, top_i

    reference._moe = keep
    try:
        system._reference(seed, [index])
    finally:
        reference._moe = plain_moe
    cfg = system.model.cfg
    n_pre = len(cfg.prefix_layers)
    out = []
    for j, (x, ref_i) in sorted(kept.items()):
        params = system.model.stack[n_pre + j].ffn
        for fed, inp in (("float32", x), ("bfloat16", x.to(torch.bfloat16))):
            with torch.inference_mode():
                got = moe.route(params, inp, cfg)[0]
            out.append({"moe_layer": j, "fed": fed,
                        "route_gap": float(missed(got[None], ref_i[None]).sum()) / got.numel(),
                        "rank_gap": float((got != ref_i).sum()) / got.numel()})
    return out


def readings(cell, seeds, control_seeds, witness_seeds, control_dtype, device,
             router_layers=()):
    driver = cell.driver()
    system = driver.System(cell.config, cell.mix, cell.spec, device)
    system.build()
    for kind, dtype, seed_list in (("program", None, seeds),
                                   (f"{control_dtype}_control".replace("torch.", ""),
                                    control_dtype, control_seeds),
                                   ("float64_witness", torch.float64, witness_seeds)):
        for seed in seed_list:
            picks = driver.checked_batches(seed, cell.spec)
            t0 = time.perf_counter()
            if dtype is None:
                system.warm_up(seed)
                answers = {i: system.run_batch(seed, i, keep_answer=True).answer for i in picks}
            else:
                answers = system.reference_answers(seed, picks, dtype)
            t1 = time.perf_counter()
            refs = system._reference(seed, picks)
            values, failed = numbers(list(answers.values()), refs)
            line = {"workload": cell.name, "kind": kind, "seed": seed, "batches": picks,
                    "prompts": len(picks) * system.batch, "prompts_failed": failed,
                    "values": values, **by_layer(list(answers.values()), refs),
                    "answer_s": t1 - t0, "check_s": time.perf_counter() - t1}
            if dtype is None and router_layers and seed == seeds[0]:
                line["router_on_reference"] = router_on_reference(system, seed, picks[0],
                                                                  router_layers)
            yield line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--control-dtype", default="float8_e4m3fn")
    ap.add_argument("--router-layers", default="")
    ap.add_argument("--out", default="build/lm_readings.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_readings.py reads the card's readings; no CUDA device", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    cell = harness.Cell(ROOT, args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for r in readings(cell, ints(args.seeds), ints(args.control_seeds),
                          ints(args.witness_seeds), getattr(torch, args.control_dtype),
                          torch.device("cuda", 0), set(ints(args.router_layers))):
            line = json.dumps(dict(r, card=card))
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
