#!/usr/bin/env python3
"""Time the ``cam_match`` wrapper on one NVIDIA GPU at the Table-V serving shape.

Random-float activity [32, 6, 1024] and the Table-V CAM tables (1536 x 64
words): per call, the median CUDA-event time of 60 repeats of 20
back-to-back calls; on the device, the kernel's mean time over 50 calls
(torch.profiler). ``--src`` names the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so that two checkouts
can be timed in turns on one card (A, B, B, A). Prints one JSON line:

    python3 scripts/time_cam_match.py [--src path/to/src]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src")
    args = parser.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cnn import compile_poker_cnn
    from repro_torch.kernels.cam_match import ops as cam_ops

    if not torch.cuda.is_available():
        sys.exit("time_cam_match: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = compile_poker_cnn().tables
    cam_tag, cam_syn = (torch.as_tensor(x, device=dev) for x in (t.cam_tag, t.cam_syn))
    gen = torch.Generator(device=dev).manual_seed(7)
    act = torch.rand((32, t.n_clusters, t.k_tags), generator=gen, device=dev)

    def call():
        return cam_ops.cam_match(act, cam_tag, cam_syn, t.cluster_size)

    torch.testing.assert_close(call(), cam_ops.cam_match_ref(act, cam_tag, cam_syn,
                                                             t.cluster_size),
                               rtol=1e-6, atol=1e-6)
    for _ in range(10):
        call()
    torch.cuda.synchronize()
    samples = []
    for _ in range(60):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            call()
        torch.cuda.synchronize()
    kernel_us = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "cam_match_kernel" in e.name]
    print(json.dumps({
        "src": str(args.src), "card": torch.cuda.get_device_name(0),
        "per_call_ms": statistics.median(samples),
        "device_ms": sum(kernel_us) / len(kernel_us) / 1e3,
        "kernel_launches_profiled": len(kernel_us),
    }), flush=True)


if __name__ == "__main__":
    main()
