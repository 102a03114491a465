#!/usr/bin/env python3
"""Sweep the work split of the three stage-2 kernels on one NVIDIA GPU.

At the Table-V serving shape (B = 32 slots, N = 1536 neurons in 6 clusters
of 256, K = 1024, S = 64, E = 16; for ``fabric_deliver`` the default 3x3
fabric's M = 1280 entries and a ring of D1 = 2), each kernel is run at every
batch tile of 1, 2, 4 and 8 and 32, 64 or 128 neurons per block, checked
against its plain version (bit-exact on integer-valued inputs; ``cam_match``
also allclose(rtol=1e-6, atol=1e-6) on random floats), and timed on the
device with torch.profiler (the kernel's mean time over 50 calls).
``cam_match`` is timed on integer-valued and on random-float activity;
``fused_deliver`` at 0%, 10% and 100% of the neurons spiking and at 100%
into a queue of 64 slots; ``fabric_deliver`` with 10% of the entries
carrying weight. ``kernels/_split.py`` holds the split chosen from this
sweep. Prints one JSON object; run from the repository root:

    python3 scripts/tune_delivery_split.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.core.cnn import compile_poker_cnn  # noqa: E402
from repro_torch.core.dispatch import FabricBackend  # noqa: E402
from repro_torch.core.two_stage import compact_events  # noqa: E402
from repro_torch.kernels import _build, _split  # noqa: E402
from repro_torch.kernels.cam_match import ops as cam_ops  # noqa: E402
from repro_torch.kernels.fabric_deliver import ops as fabric_ops  # noqa: E402
from repro_torch.kernels.fused_deliver import ops as fused_ops  # noqa: E402

TILES = (1, 2, 4, 8)
NEURONS_PER_BLOCK = (32, 64, 128)
B = 32


def _with_split(tile: int, neurons: int):
    _split.BATCH_TILE, _split.NEURONS_PER_BLOCK = tile, neurons
    _split.CAM_MATCH_BATCH_TILE, _split.CAM_MATCH_NEURONS_PER_BLOCK = tile, neurons
    for ops in (cam_ops, fused_ops, fabric_ops):
        ops.work_split.cache_clear()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tune_delivery_split: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain stage 2 is a float32 matmul
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all()
    t = compile_poker_cnn().tables
    tabs = [torch.as_tensor(getattr(t, k), device=dev)
            for k in ("src_tag", "src_dest", "cam_tag", "cam_syn")]
    nc, k, cs = t.n_clusters, t.k_tags, t.cluster_size
    gen = torch.Generator(device=dev).manual_seed(7)
    ext = torch.randint(0, 3, (B, nc, k), generator=gen, device=dev).float() * 8.0
    queues = {}
    for act, cap in ((0.0, t.n_neurons), (0.1, t.n_neurons), (1.0, t.n_neurons), (1.0, 64)):
        active = torch.rand((B, t.n_neurons), generator=gen, device=dev) < act
        queues[f"{act:.0%} activity, queue of {cap}"] = compact_events(active.float(), cap)
    be = FabricBackend()
    entries = be.build_entries(t.src_tag, t.src_dest, cs, k, device=dev)
    d1 = be.model_for(nc).max_delay + 1
    m = entries.dstk.shape[0]
    w = (torch.rand((B, m), generator=gen, device=dev) < 0.1).float()
    ring = torch.randint(0, 3, (B, d1, nc, k), generator=gen, device=dev).float()
    cur = torch.tensor(0, dtype=torch.int32, device=dev)
    fargs = (entries.dstk, entries.delay, w, ring, cur, ext, tabs[2], tabs[3], cs, k)
    ranges = {"cluster_start": entries.cluster_start, "cluster_order": entries.cluster_order}
    plain_fabric = fabric_ops.fabric_deliver_ref(*fargs)
    activity = {
        "integer": torch.randint(0, 17, (B, nc, k), generator=gen, device=dev).float() * 8.0,
        "random floats": torch.rand((B, nc, k), generator=gen, device=dev),
    }
    plain_cam = {name: cam_ops.cam_match_ref(a, *tabs[2:], cs) for name, a in activity.items()}

    sweep = []
    for tile in TILES:
        for neurons in NEURONS_PER_BLOCK:
            _with_split(tile, neurons)
            row = {"batch_tile": tile, "neurons_per_block": neurons,
                   "parts": _split.parts_for(cs), "cam_device_ms": {}, "fused_device_ms": {}}
            for name, a in activity.items():
                def cam_call(a=a):
                    return cam_ops.cam_match(a, tabs[2], tabs[3], cs)

                got = cam_call()
                if name == "integer" and not torch.equal(got, plain_cam[name]):
                    raise AssertionError(f"cam_match differs from plain at {row}, {name}")
                torch.testing.assert_close(got, plain_cam[name], rtol=1e-6, atol=1e-6)
                row["cam_device_ms"][name] = chip_smoke.device_ms(cam_call, "cam_match_kernel")
            for name, q in queues.items():
                def fn(q=q):
                    return fused_ops.fused_deliver(q, *tabs, cs, k, external_activity=ext)

                if not torch.equal(fn(), fused_ops.fused_deliver_ref(q, *tabs, cs, k,
                                                                    external_activity=ext)):
                    raise AssertionError(f"fused_deliver differs from plain at {row}, {name}")
                row["fused_device_ms"][name] = chip_smoke.device_ms(fn, "fused_deliver_kernel")
            def fabric_call():
                return fabric_ops.fabric_deliver(*fargs, **ranges)

            drive, new_ring = fabric_call()
            if not (torch.equal(drive, plain_fabric[0]) and torch.equal(new_ring, plain_fabric[1])):
                raise AssertionError(f"fabric_deliver differs from plain at {row}")
            row["fabric_device_ms"] = chip_smoke.device_ms(fabric_call, "fabric_deliver_kernel")
            sweep.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "shape": f"B {B}, N {t.n_neurons}, K {k}, M {m}, D1 {d1}",
                      "sweep": sweep}), flush=True)


if __name__ == "__main__":
    main()
