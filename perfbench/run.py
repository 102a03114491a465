"""The benchmark of ``repro_torch`` on one NVIDIA GPU.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout. Exits non-zero, printing no result, when
CUDA is missing or has fewer devices than the cell asks for.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed places inside the checkout; the
# program builds its own CUDA libraries under build/kernels there
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
