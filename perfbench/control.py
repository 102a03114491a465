"""Readings that the comparison's limits are set from, on the card.

    python3 perfbench/control.py --workload NAME --seeds 1,2,3 \\
        --control-seeds 4,5,6 --witness-seeds 7,8 --out FILE

For each of ``--seeds``, the program's answers on the checked batches of a
run with that seed (the timed path, at the cell's sizes), held to the
reference: the lower readings. For each of ``--control-seeds``, the
reference computed in bfloat16, the precision below the configuration's
float32, put in the program's place: the upper readings. For each of
``--witness-seeds``, the reference in float64 held to the float32 one:
how far float32's own rounding moves the numbers. One JSON line per
reading, also written to ``--out``. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def readings(cell: harness.Cell, seeds, control_seeds, witness_seeds, device, batch=None):
    driver = cell.driver()
    system = driver.System(cell.config, cell.mix, cell.spec, device, batch=batch)
    system.build()
    system.warm_up(0)
    for kind, dtype, seed_list in (("program", None, seeds), ("bf16_control", torch.bfloat16,
                                                              control_seeds),
                                   ("float64_witness", torch.float64, witness_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            picks = driver.checked_batches(seed, cell.spec)
            if dtype is None:
                answers = {i: system.run_batch(seed, i, keep_answer=True).answer for i in picks}
            else:
                answers = system.reference_answers(seed, picks, dtype)
            values, differ = system.check(seed, answers)
            yield {"workload": cell.name, "kind": kind, "seed": seed, "batches": picks,
                   "streams": len(picks) * system.batch, "streams_differing": differ,
                   "values": values, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control.py reads the card's readings; no CUDA device", file=sys.stderr)
        return 2

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    cell = harness.Cell(ROOT, args.workload)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for r in readings(cell, ints(args.seeds), ints(args.control_seeds),
                          ints(args.witness_seeds), torch.device("cuda", 0)):
            line = json.dumps(r)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
