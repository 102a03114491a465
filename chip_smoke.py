#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

Phases, each of which fails the run on any error:
  1. the card (nvidia-smi name and power limit), the versions, and the build
     of every ``src/repro_torch/kernels/*/csrc/*.cu`` with nvcc for sm_90a;
  2. each kernel's wrapper at the Table-V serving shape (B = 32 slots,
     N = 1536 neurons in 6 cores, K = 1024, S = 64, E = 16; for
     ``fabric_deliver`` the default 3x3 fabric's M = 1280 static entries and
     a ring of D1 = 2 slots), held against its plain PyTorch version:
     bit-exact on integer-valued inputs, allclose(rtol=1e-6, atol=1e-6) on
     random floats (atomics and per-type sums add in another order); then
     timed with CUDA events (median of 60 repeats of 20 calls, after
     warm-up) beside the plain version, with the kernel's own device time
     from torch.profiler. ``cam_match`` is also held at B = 1 and 33, at
     K = 16384 and at S = 5 (tags past K - 1 and types outside [0, 4)), and
     timed beside its library yardstick, one ``torch.bmm`` of the activity
     with the CAM count matrix (``cam_counts``), held to the same
     tolerances. ``fused_deliver`` is also held at 0% and 100% activity and
     at 100% into a queue of 64 slots (drops). One call of either must run
     exactly one device operation. ``fabric_deliver`` is held at 0%, 10%
     and 100% of its entries carrying weight, at both cursors, and carried
     over 2*(max_delay+1)+1 steps on a geometry with max_delay = 2 and link
     capacity 2, where the kernel and plain legs must carry equal rings. The
     registers, spills, shared bytes and blocks per SM of the three stage-2
     kernels are logged;
  3. the serving path: the offline-Hebbian calibration run, then a pool of
     32 slots serving 64 poker-DVS sessions (seed 7, 16 events per step)
     once per backend (fused, cuda, reference, and the fabric with its
     kernel and with ``kernel=False``); the queued backends must agree on
     every session, the two fabric legs must agree on every session (link
     drops included), every run must reach accuracy >= 0.95, and each
     kernel must have been launched once per engine step of its backend's
     run; a short fabric pool with link capacity 8 holds the kernel leg
     against the plain one where links drop; a small network is held
     against the dense oracle on the card; one profiled window of serving
     steps per kernel backend says where the device time goes;
  3b. the compiler path (routing compiler v2, the traffic feedback loop and
     the dispatch autotuner), each part with the launch counts set to 0
     just before it and read just after: Table-V under the reuse allocator
     (the default readout's tables equal v1's; the Hebbian readout's v2
     tables serve the 64 sessions on fused and cuda identically to the v1
     legs); the feedback loop (a 32-slot pool on the 3x3 fabric at link
     capacity 2 with per-link stats from the corners-first placement, 16
     steps, optimize_placement on its measured profile, 16 steps on the
     re-placed tables; kernel and plain legs equal, and the JAX package's
     2219 -> 374 link drops and placement [4, 5, 4, 4, 4, 1]; host ms per
     step beside the pool without a profile and without per-link stats);
     the Table-IV shuffle network (4x4 tiles of 4 cores, clusters of 8,
     K = 64: v2 tags and SRAM bits against v1, one all-spiking step at link
     capacity 1, 904 -> 154 link drops, kernel and plain legs equal;
     two_stage_deliver on the v2 tables against the dense oracle; retarget
     to 2x2 tiles of 4 cores of 32, saved under build/, loaded, entry_table
     against the engine's, 4 steps against the delay-aware dense oracle);
     the autotuned pool (backend="auto" at activity 0.1, B = 32, built
     twice to the same decision: every candidate's microseconds, 64
     sessions equal to the fixed legs', launching the winner's kernel,
     cam_match or fused_deliver, once per step);
  4. LM serving: rwkv6-3b at full width and depth (32 layers, bfloat16
     weights initialised on the card from seed 7) serves 8 prompts of 512
     tokens with 32 new greedy tokens through ``Engine.generate``, which must
     launch ``rwkv6_chunk`` exactly 32 * ceil(512/64) = 256 times (once per
     chunk per layer, prefill only); prefill and decode are timed, and one
     prefill and 31 decode steps are profiled. The kernel leg is held against the
     ``rwkv_kernel=False`` leg layer by layer (each block on the same input:
     prefill, then 31 teacher-forced decode steps with the kernel leg's
     tokens; logits and every layer's ``wkv`` state), and at float32 with 2
     layers of full width the chunked prefill on the kernel is held against
     the sequential oracle. ``rwkv6_chunk`` itself is held against its plain
     version in phase 2 at B = 8, T = 64, H = 40, P = 64, on deep (log_w =
     -e) and extreme (down to -90 per token) decays, on a chunk ending in
     the chunked core's padding, and on tail chunks of T = 8, 17 and 37;
     its registers, spills, shared bytes and blocks per SM are logged.

Prints a ``{"kernels": [...]}`` JSON line (``launches`` from the serving
and LM paths, ``launches_compiler_phase`` from phase 3b), then as the last line
``{"ok": true, "device": {...}}``. TF32 is off throughout (the plain stage 2
contracts a one-hot with a float32 matmul). Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cnn import compile_poker_cnn  # noqa: E402
from repro_torch.core.compiler import (  # noqa: E402
    CompiledArtifact,
    Geometry,
    compile_network_v2,
    optimize_placement,
    retarget,
)
from repro_torch.core.dispatch import FabricBackend  # noqa: E402
from repro_torch.core.event_engine import (  # noqa: E402
    EventEngine,
    dense_reference_step,
    dense_weights_from_tables,
)
from repro_torch.core.neuron import neuron_step  # noqa: E402
from repro_torch.core.routing import ChipConstants, Fabric  # noqa: E402
from repro_torch.core.tags import NetworkSpec, compile_network  # noqa: E402
from repro_torch.core.two_stage import (  # noqa: E402
    compact_events,
    stage2_cam_match,
    two_stage_deliver,
)
from repro_torch.data.pipeline import DvsStreamConfig, DvsStreamSource  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cam_match import ops as cam_ops  # noqa: E402
from repro_torch.kernels.cam_match.ref import cam_counts  # noqa: E402
from repro_torch.kernels.fabric_deliver import ops as fabric_ops  # noqa: E402
from repro_torch.kernels.fused_deliver import ops as fused_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as rwkv_ops  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.aer import (  # noqa: E402
    AerServeConfig,
    AerSessionPool,
    DvsSession,
    build_poker_engine,
    tune_poker_readout,
)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
POOL, SESSIONS, SEED, EVENTS_PER_STEP = 32, 64, 7, 16
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 32  # rwkv6-3b serving: prompts, prompt length, new tokens
OUT_DIR = ROOT / "build" / "chip_smoke"  # long results; build/ is not committed


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: card, versions, build
# ---------------------------------------------------------------------------
def phase_card_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    report = _build.build_all()
    parts = [f"{name} built={r['built']} {r['seconds']:.2f}s" for name, r in report.items()]
    log(f"build/kernels: {time.perf_counter() - t0:.2f} s wall for {len(report)} sources "
        f"({', '.join(parts)})")
    for name, r in report.items():
        for line in r["ptxas"].splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(fn, repeats: int = 60, inner: int = 20) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``inner`` calls, per call."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_ms(fn, kernel_name: str | None, calls: int = 50) -> float | None:
    """Mean device time of the kernel named ``kernel_name`` per call, from
    torch.profiler; None when the trace shows no such kernel. With
    ``kernel_name`` None: every device operation of a call, summed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA and (
                kernel_name is None or kernel_name in evt.name):
            total_us += evt.time_range.elapsed_us()
            count += 1
    per = calls if kernel_name is None else count
    return None if count == 0 else total_us / per / 1e3


def _bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_kernels(dev: torch.device) -> dict[str, dict]:
    cc = compile_poker_cnn()
    t = cc.tables
    src_tag, src_dest, cam_tag, cam_syn = (
        torch.as_tensor(getattr(t, k), device=dev)
        for k in ("src_tag", "src_dest", "cam_tag", "cam_syn")
    )
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out: dict[str, dict] = {}
    out["cam_match"] = cam_kernel_entry(dev, t, cam_tag, cam_syn, gen)
    out["fused_deliver"] = fused_kernel_entry(dev, t, (src_tag, src_dest, cam_tag, cam_syn), gen)
    out["fabric_deliver"] = fabric_kernel_entry(dev, t, cam_tag, cam_syn, gen)
    check_fabric_wrap(dev)
    for v in out.values():
        log(f"{v['name']}: bit-exact on integer inputs; max_abs_err {v['max_abs_err']:.3g} on "
            f"random floats, within allclose(rtol=1e-6, atol=1e-6); "
            f"{v['ms'] * 1e3:.2f} us/call (kernel on the device {v['device_ms']} ms), plain "
            f"{v['plain_ms'] * 1e3:.2f} us, bound {v['bound_ms'] * 1e3:.3f} us ({v['bound_by']})")
    out["rwkv6_chunk"] = rwkv_kernel_entry(dev)
    return out


def _device_ops_per_call(fn, tries: int = 3) -> list[str]:
    """The names of the device operations one call of ``fn`` runs
    (torch.profiler). A trace that recorded no device event at all is taken
    again, up to ``tries`` times: the profiler has been seen to record none
    for a call that launched a kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    return ops


def _log_kernel_info(name: str, info: dict, split) -> None:
    if info["shared_bytes"] != split.shared_bytes:
        raise AssertionError(f"{name}: the library gives a block {info['shared_bytes']} shared "
                             f"bytes, the wrapper counts {split.shared_bytes}")
    log(f"{name}: {info['registers']} registers, {info['local_bytes']} local (spill) bytes per "
        f"thread, {info['shared_bytes']} shared bytes and {info['blocks_per_sm']} blocks per SM "
        f"at the serving split {split}")


# cam_match cases beside the serving shape: (name, batch, random tables or
# None for Table-V's: (n_clusters, cluster_size, K, S))
CAM_CASES = (
    ("B = 1", 1, None),
    ("B = 33, a ragged last tile", 33, None),
    ("K = 16384, shared-memory opt-in", 5, (2, 64, 16384, 64)),
    ("S = 5, clusters of 13", 3, (3, 13, 32, 5)),
)


def _cam_case(dev, gen, b, shape, tabs):
    """Integer and float activity for one case, and its CAM tables (random
    ones draw tags past K - 1 and types outside [0, 4))."""
    if shape is None:
        cam_tag, cam_syn, nc, cs, k = tabs
    else:
        nc, cs, k, s = shape
        cam_tag = torch.randint(-1, k + 4, (nc * cs, s), generator=gen, device=dev,
                                dtype=torch.int32)
        cam_syn = torch.randint(-1, 5, (nc * cs, s), generator=gen, device=dev, dtype=torch.int32)
    act_int = torch.randint(0, 17, (b, nc, k), generator=gen, device=dev).float() * 8.0
    act_flt = torch.rand((b, nc, k), generator=gen, device=dev)
    return act_int, act_flt, cam_tag, cam_syn, cs


def _hold_cam(what, got_int, ref_int, got_flt, ref_flt) -> None:
    if not torch.equal(got_int, ref_int):
        raise AssertionError(f"{what} not bit-exact on integer inputs: max err "
                             f"{(got_int - ref_int).abs().max()}")
    torch.testing.assert_close(got_flt, ref_flt, rtol=1e-6, atol=1e-6)


def cam_kernel_entry(dev, t, cam_tag, cam_syn, gen) -> dict:
    """``cam_match`` at the serving shape, activity [B, nc, K] -> drive
    [B, N, 4], held against the plain version (and at B = 1, 33, K = 16384
    and S = 5); one call must be one device operation. Beside it the library
    yardstick: one ``torch.bmm`` of the activity with the per-cluster count
    matrix of ``cam_counts`` (TF32 off), held to the same tolerances."""
    nc, k, cs, n = t.n_clusters, t.k_tags, t.cluster_size, t.n_neurons
    tabs = (cam_tag, cam_syn, nc, cs, k)
    cases = {}
    for name, b, shape in CAM_CASES:
        a_int, a_flt, tag, syn, c = _cam_case(dev, gen, b, shape, tabs)
        got_int = cam_ops.cam_match(a_int, tag, syn, c)
        got_flt = cam_ops.cam_match(a_flt, tag, syn, c)
        torch.cuda.synchronize()
        ref_flt = cam_ops.cam_match_ref(a_flt, tag, syn, c)
        _hold_cam(f"cam_match at {name}", got_int, cam_ops.cam_match_ref(a_int, tag, syn, c),
                  got_flt, ref_flt)
        cases[name] = {"max_abs_err": float((got_flt - ref_flt).abs().max()),
                       "split": str(cam_ops.work_split(b, c, a_flt.shape[-1]))}
    act_int, act_flt, *_ = _cam_case(dev, gen, POOL, None, tabs)
    got_int = cam_ops.cam_match(act_int, cam_tag, cam_syn, cs)
    got_flt = cam_ops.cam_match(act_flt, cam_tag, cam_syn, cs)
    torch.cuda.synchronize()
    ref_int = cam_ops.cam_match_ref(act_int, cam_tag, cam_syn, cs)
    ref_flt = cam_ops.cam_match_ref(act_flt, cam_tag, cam_syn, cs)
    _hold_cam("cam_match", got_int, ref_int, got_flt, ref_flt)
    call = lambda: cam_ops.cam_match(act_flt, cam_tag, cam_syn, cs)  # noqa: E731
    ops = _device_ops_per_call(call)
    if len(ops) != 1 or "cam_match_kernel" not in ops[0]:
        raise AssertionError(f"one cam_match call ran {len(ops)} device operations: {ops}")
    split = cam_ops.work_split(POOL, cs, k)
    info = cam_ops.kernel_info(split, k)
    _log_kernel_info("cam_match", info, split)

    # the library yardstick: drive = bmm(A^T, C), clusters first
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = cam_counts(cam_tag, cam_syn, nc, k)
    bmm = lambda a: torch.bmm(a.transpose(0, 1), counts)  # noqa: E731
    as_drive = lambda d: d.transpose(0, 1).reshape(POOL, n, 4)  # noqa: E731
    lib_int, lib_flt = as_drive(bmm(act_int)), as_drive(bmm(act_flt))
    _hold_cam("torch.bmm with the CAM counts", lib_int, ref_int, lib_flt, ref_flt)
    library_device_ms = device_ms(lambda: bmm(act_flt), None)
    log(f"cam_match: library yardstick torch.bmm [{nc},{POOL},{k}] x [{nc},{k},{cs * 4}] "
        f"(TF32 off) holds to the plain version; device ops "
        f"{_device_ops_per_call(lambda: bmm(act_flt))}, {library_device_ms} ms on the device")
    log("cam_match: " + "; ".join(f"{name}: max_abs_err {c['max_abs_err']:.3g} at {c['split']}"
                                  for name, c in cases.items()))

    n_bytes = _nbytes(act_flt, cam_tag, cam_syn, got_flt)
    bound_ms, bound_by = _bound(n_bytes, POOL * int((cam_tag >= 0).sum()))
    return {
        "name": "cam_match",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cam_match/csrc/cam_match.cu",
        "replaces": "src/repro/kernels/cam_match/cam_match.py:39",
        "max_abs_err": float((got_flt - ref_flt).abs().max()),
        "max_abs_err_integer_inputs": float((got_int - ref_int).abs().max()),
        "ms": time_ms(call),
        "plain_ms": time_ms(lambda: cam_ops.cam_match_ref(act_flt, cam_tag, cam_syn, cs)),
        "device_ms": device_ms(call, "cam_match_kernel"),
        "device_ops_per_call": len(ops),
        "cases": cases,
        **{f"kernel_{key}": v for key, v in info.items()},
        "split": str(split),
        "bytes": n_bytes,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": time_ms(lambda: bmm(act_flt)),
        "library_device_ms": library_device_ms,
        "library_max_abs_err": float((lib_flt - ref_flt).abs().max()),
        "library_call": f"torch.bmm(activity.transpose(0, 1), cam_counts(...)), counts "
                        f"[{nc},{k},{cs * 4}] f32, TF32 off",
        "shape": f"activity [{POOL},{nc},{k}] f32, cam [{n},{cam_tag.shape[1]}] i32",
    }


def fused_kernel_entry(dev, t, tabs, gen) -> dict:
    """``fused_deliver`` at the serving shape: queue [B, N] (capacity N, as
    the pool sizes it) + ext [B, nc, K] -> drive [B, N, 4], with 10% of the
    neurons spiking (the timed case), and at 0% and 100% activity and 100%
    into a queue of 64 slots (drops); each held against the plain version
    with and without ext. One call must put exactly one operation on the
    device: the SRAM gather is inside the kernel."""
    nc, k, cs, n = t.n_clusters, t.k_tags, t.cluster_size, t.n_neurons
    src_tag, _, cam_tag, _ = tabs
    valid_words = int((cam_tag >= 0).sum())
    cases = {}
    for name, act, cap in (("10% activity", 0.1, n), ("0% activity", 0.0, n),
                           ("100% activity", 1.0, n), ("100% activity, queue of 64", 1.0, 64)):
        active = torch.rand((POOL, n), generator=gen, device=dev) < act
        spikes_int = active.float()
        spikes_flt = active * torch.rand((POOL, n), generator=gen, device=dev)
        ext_int = torch.randint(0, 3, (POOL, nc, k), generator=gen, device=dev).float() * 8.0
        ext_flt = torch.rand((POOL, nc, k), generator=gen, device=dev)
        q_int, q_flt = compact_events(spikes_int, cap), compact_events(spikes_flt, cap)
        errs = []
        for q, ext, integer in ((q_int, ext_int, True), (q_flt, ext_flt, False)):
            for e in (ext, None):
                got = fused_ops.fused_deliver(q, *tabs, cs, k, external_activity=e)
                torch.cuda.synchronize()
                ref = fused_ops.fused_deliver_ref(q, *tabs, cs, k, external_activity=e)
                if integer and not torch.equal(got, ref):
                    raise AssertionError(f"fused_deliver not bit-exact on integer inputs at "
                                         f"{name}: max err {(got - ref).abs().max()}")
                torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
                errs.append(float((got - ref).abs().max()))
        cases[name] = {
            "max_abs_err": max(errs[2:]), "max_abs_err_integer_inputs": max(errs[:2]),
            "dropped": int(q_int.dropped.sum()),
            "device_ms": device_ms(lambda: fused_ops.fused_deliver(
                q_flt, *tabs, cs, k, external_activity=ext_flt), "fused_deliver_kernel"),
        }
        if name == "10% activity":
            q10, ext10, drive10 = q_flt, ext_flt, got
    if cases["100% activity, queue of 64"]["dropped"] == 0:
        raise AssertionError("fused_deliver: the queue of 64 slots dropped no event")
    q, ext = q10, ext10
    call = lambda: fused_ops.fused_deliver(q, *tabs, cs, k, external_activity=ext)  # noqa: E731
    ops = _device_ops_per_call(call)
    if len(ops) != 1 or "fused_deliver_kernel" not in ops[0]:
        raise AssertionError(f"one fused_deliver call ran {len(ops)} device operations: {ops}")
    split = fused_ops.work_split(POOL, n, cs, k)
    info = fused_ops.kernel_info(split, k)
    _log_kernel_info("fused_deliver", info, split)
    live = q.src >= 0
    rows = src_tag[q.src.clamp(min=0).long()]  # [B, Q, E] SRAM rows of the queued events
    entries = int(((rows >= 0) & live[..., None]).sum())
    n_bytes = _nbytes(q.src, q.weight, *tabs, ext, drive10)
    bound_ms, bound_by = _bound(n_bytes, entries + POOL * valid_words)
    log("fused_deliver: " + "; ".join(
        f"{name}: device {c['device_ms']} ms, max_abs_err {c['max_abs_err']:.3g}"
        + (f", {c['dropped']} dropped" if c["dropped"] else "") for name, c in cases.items()))
    return {
        "name": "fused_deliver",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_deliver/csrc/fused_deliver.cu",
        "replaces": "src/repro/kernels/fused_deliver/fused_deliver.py:42",
        "max_abs_err": cases["10% activity"]["max_abs_err"],
        "max_abs_err_integer_inputs": max(c["max_abs_err_integer_inputs"] for c in cases.values()),
        "ms": time_ms(call),
        "plain_ms": time_ms(lambda: fused_ops.fused_deliver_ref(q, *tabs, cs, k,
                                                                external_activity=ext)),
        "device_ms": cases["10% activity"]["device_ms"],
        "device_ops_per_call": len(ops),
        "cases": cases,
        **{f"kernel_{key}": v for key, v in info.items()},
        "split": str(split),
        "bytes": n_bytes,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes queue -> drive
        "shape": f"queue [{POOL},{n}] (i32 src, f32 w), SRAM [{n},{src_tag.shape[1]}] i32 x2, "
                 f"ext [{POOL},{nc},{k}] f32, cam [{n},{cam_tag.shape[1]}] i32 x2",
    }


def fabric_kernel_entry(dev, t, cam_tag, cam_syn, gen) -> dict:
    """``fabric_deliver`` at the serving shape: the Table-V network's static
    entry table on the default 3x3 fabric (M = 1280, D1 = 2), B = 32, 10%
    of the entries carrying a spike, the ring holding the previous step's
    late arrivals."""
    nc, k, cs = t.n_clusters, t.k_tags, t.cluster_size
    be = FabricBackend()
    entries = be.build_entries(t.src_tag, t.src_dest, cs, k, device=dev)
    d1 = be.model_for(nc).max_delay + 1
    m = entries.dstk.shape[0]
    if (m, d1) != (1280, 2):
        raise AssertionError(f"Table-V fabric entries {m} x ring slots {d1}, expected 1280 x 2")
    ranges = {"cluster_start": entries.cluster_start, "cluster_order": entries.cluster_order}
    ring_int = torch.randint(0, 3, (POOL, d1, nc, k), generator=gen, device=dev).float()
    ring_flt = torch.rand((POOL, d1, nc, k), generator=gen, device=dev)
    ext_int = torch.randint(0, 3, (POOL, nc, k), generator=gen, device=dev).float() * 8.0
    ext_flt = torch.rand((POOL, nc, k), generator=gen, device=dev)
    errs_int, errs_flt = [], []
    for share in (0.1, 0.0, 1.0):  # entries carrying weight: the timed case first
        carries = (torch.rand((POOL, m), generator=gen, device=dev) < share).float()
        w_int = carries
        w_flt = carries * torch.rand((POOL, m), generator=gen, device=dev)
        if share == 0.1:
            w_timed = w_flt
        for cursor in range(d1):
            cur = torch.tensor(cursor, dtype=torch.int32, device=dev)
            for w, ring, ext, errs in ((w_int, ring_int, ext_int, errs_int),
                                       (w_flt, ring_flt, ext_flt, errs_flt)):
                args = (entries.dstk, entries.delay, w, ring, cur, ext, cam_tag, cam_syn, cs, k)
                drive, new_ring = fabric_ops.fabric_deliver(*args, **ranges)
                torch.cuda.synchronize()
                p_drive, p_ring = fabric_ops.fabric_deliver_ref(*args)
                errs.append(max(float((drive - p_drive).abs().max()),
                                float((new_ring - p_ring).abs().max())))
                if w is w_int and not (torch.equal(drive, p_drive)
                                       and torch.equal(new_ring, p_ring)):
                    raise AssertionError(
                        f"fabric_deliver not bit-exact on integer inputs: {errs[-1]}")
                torch.testing.assert_close(drive, p_drive, rtol=1e-6, atol=1e-6)
                torch.testing.assert_close(new_ring, p_ring, rtol=1e-6, atol=1e-6)
    cur = torch.tensor(0, dtype=torch.int32, device=dev)
    w_flt = w_timed
    args = (entries.dstk, entries.delay, w_flt, ring_flt, cur, ext_flt, cam_tag, cam_syn, cs, k)
    drive, new_ring = fabric_ops.fabric_deliver(*args, **ranges)
    split = fabric_ops.work_split(POOL, cs, k, d1)
    info = fabric_ops.kernel_info(split, k, d1)
    _log_kernel_info("fabric_deliver", info, split)
    valid_words = int((cam_tag >= 0).sum())
    n_bytes = _nbytes(entries.dstk, entries.delay, entries.cluster_start, entries.cluster_order,
                      w_flt, ring_flt, cur, ext_flt, cam_tag, cam_syn, drive, new_ring)
    # one add per entry carrying weight, per arrival cell (+ ext), per valid CAM word
    n_ops = int((w_flt != 0).sum()) + POOL * nc * k + POOL * valid_words
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return {
        "name": "fabric_deliver",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fabric_deliver/csrc/fabric_deliver.cu",
        "replaces": "src/repro/kernels/fabric_deliver/fabric_deliver.py:52",
        "max_abs_err": max(errs_flt),
        "max_abs_err_integer_inputs": max(errs_int),
        "ms": time_ms(lambda: fabric_ops.fabric_deliver(*args, **ranges)),
        "plain_ms": time_ms(lambda: fabric_ops.fabric_deliver_ref(*args)),
        "device_ms": device_ms(lambda: fabric_ops.fabric_deliver(*args, **ranges),
                               "fabric_deliver_kernel"),
        **{f"kernel_{key}": v for key, v in info.items()},
        "split": str(split),
        "bytes": n_bytes,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes ring update + pop + CAM match
        "shape": f"entries [{m}] i32 x2, w [{POOL},{m}] f32, ring [{POOL},{d1},{nc},{k}] f32, "
                 f"ext [{POOL},{nc},{k}] f32, cam [{t.n_neurons},{t.cam_tag.shape[1]}] i32 x2",
    }


def check_fabric_wrap(dev: torch.device) -> None:
    """The ring step carried over 2*(max_delay+1)+1 steps on a geometry with
    max_delay = 2 and link capacity 2, kernel against plain: equal rings,
    drives, cursors and integer stats at every step, links dropping."""
    rng = np.random.default_rng(SEED)
    fab = Fabric(grid_x=2, grid_y=1, cores_per_tile=2,
                 constants=ChipConstants(latency_across_chip_s=2e-3))
    nc, cs, k = fab.n_cores, 64, 256
    n = nc * cs
    src_tag = rng.integers(-1, k, (n, 8)).astype(np.int32)
    src_dest = rng.integers(0, nc, (n, 8)).astype(np.int32)
    cam_tag = torch.as_tensor(rng.integers(-1, k, (n, 16)).astype(np.int32), device=dev)
    cam_syn = torch.as_tensor(rng.integers(0, 4, (n, 16)).astype(np.int32), device=dev)
    legs = {kernel: FabricBackend(fabric=fab, link_capacity=2, kernel=kernel)
            for kernel in (True, False)}
    entries = legs[True].build_entries(src_tag, src_dest, cs, k, device=dev)
    max_delay = legs[True].model_for(nc).max_delay
    if max_delay != 2:
        raise AssertionError(f"wrap geometry has max_delay {max_delay}, expected 2")
    carry = {kernel: be.init_ring(nc, k, batch=4, device=dev) for kernel, be in legs.items()}
    steps, link_dropped = 2 * (max_delay + 1) + 1, 0
    for step in range(steps):
        spikes = torch.as_tensor((rng.random((4, n)) < 0.3).astype(np.float32), device=dev)
        ext = torch.as_tensor((rng.integers(0, 3, (4, nc, k)) * 8.0).astype(np.float32), device=dev)
        outs = {}
        for kernel, be in legs.items():
            drive, ring, cur, stats = be.deliver_fabric_ring(
                spikes, entries, cam_tag, cam_syn, cs, k, *carry[kernel],
                external_activity=ext, queue_capacity=n // 2)
            carry[kernel] = (ring, cur)
            outs[kernel] = (drive, ring, cur, stats)
        torch.cuda.synchronize()
        for a, b in zip(outs[True][:3], outs[False][:3]):
            if not torch.equal(a, b):
                raise AssertionError(f"fabric_deliver: kernel and plain legs differ at step {step}")
        for f in ("dropped", "link_dropped", "delivered", "hops"):
            if not torch.equal(getattr(outs[True][3], f), getattr(outs[False][3], f)):
                raise AssertionError(f"fabric_deliver: {f} differs at step {step}")
        link_dropped += int(outs[True][3].link_dropped.sum())
    if link_dropped == 0:
        raise AssertionError("wrap geometry dropped no link events")
    log(f"fabric_deliver: kernel and plain legs carry equal rings over {steps} steps at "
        f"max_delay {max_delay}, link capacity 2 ({link_dropped} link drops)")


def _chunk_work(b: int, t: int, h: int, p: int) -> tuple[int, int]:
    """(float32 add/sub/mul count, exp count) of one rwkv6_chunk call, as the
    kernel computes it per (batch, head) on sub-chunks of 16 tokens: the
    cumulative decay (2TP); the diagonal blocks' pairs i < t (4 ops and one
    exp per channel) and bonus diagonal (3TP); the decay vectors (15P exps)
    and folding the decays into r and k (2TP ops and exps); the off-diagonal
    blocks of a (2 P per entry, plus the e scaling), a v over the
    block-lower triangle, r' s0 and k'^T v (2TP^2 each, plus the g and f
    scaling), and the s0 decay (2P^2). A product counts its multiply-adds
    once, whatever passes the tensor cores make."""
    sub = 16
    sizes = [min(sub, t - j0) for j0 in range(0, t, sub)]
    diag_pairs = sum(n * (n - 1) // 2 for n in sizes)
    off = sum(sizes[j] * sizes[i] for j in range(len(sizes)) for i in range(j))
    lower = sum(sizes[j] * sum(sizes[:j + 1]) for j in range(len(sizes)))
    flops = (2 * t * p + 4 * diag_pairs * p + 3 * t * p + 2 * t * p
             + 2 * off * p + off * p + 2 * lower * p
             + 4 * t * p * p + 2 * t * p + 2 * p * p)
    exps = diag_pairs * p + 15 * p + 2 * t * p
    return b * h * flops, b * h * exps


def _sass_counts(name: str) -> dict[str, int] | None:
    """Tensor-core (HMMA, HGMMA) and MUFU.EX2 instructions in the SASS of the
    built kernel library ``name`` (``cuobjdump -sass``), by mnemonic; None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    lib = _build.library_path(name)
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return dict(collections.Counter(re.findall(r"\b(?:HMMA|HGMMA)\.[\w.]+|\bMUFU\.EX2\b", sass)))


def rwkv_kernel_entry(dev: torch.device) -> dict:
    """``rwkv6_chunk`` at rwkv6-3b's prefill shape (B = 8, T = ssm_chunk = 64,
    H = 40, P = 64) on inputs drawn as repro's kernel test draws them, on a
    deep-decay input (log_w = -e everywhere: cum reaches -174), an extreme
    one (log_w = -exp(U[-20, 4.5]), down to -90 per token), a chunk whose
    last 21 tokens are the chunked core's padding (log_w = 0, r = k = v = 0),
    and on tail chunks of T = 8, 17 and 37 (ragged sub-chunks of 16), each
    held against the plain version with allclose(rtol=1e-4, atol=1e-5),
    repro's own tolerance for its Pallas kernel (tests/test_kernels.py);
    then timed at the prefill shape."""
    cfg = get_config("rwkv6-3b")
    h, p = cfg.n_heads, cfg.d_model // cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(t, decay="uniform"):
        shape = (LM_BATCH, t, h, p)
        r, k, v = (torch.randn(shape, generator=gen, device=dev) * 0.5 for _ in range(3))
        if decay == "deep":
            lw = torch.full(shape, -math.e, device=dev)
        elif decay == "extreme":
            lw = -torch.exp(torch.rand(shape, generator=gen, device=dev) * 24.5 - 20.0)
        else:
            lw = -(torch.rand(shape, generator=gen, device=dev) * 0.99 + 0.01)
        if decay == "padded":
            for x in (r, k, v, lw):
                x[:, -21:] = 0.0
        u = torch.randn((h, p), generator=gen, device=dev) * 0.1
        s0 = torch.randn((LM_BATCH, h, p, p), generator=gen, device=dev) * 0.2
        return r, k, v, lw, u, s0

    cases = {"prefill shape": inputs(cfg.ssm_chunk), "deep decay": inputs(cfg.ssm_chunk, "deep"),
             "extreme decay": inputs(cfg.ssm_chunk, "extreme"),
             "padded tail": inputs(cfg.ssm_chunk, "padded"),
             "tail chunk T=8": inputs(8), "ragged T=17": inputs(17), "ragged T=37": inputs(37)}
    errs = {}
    for name, args in cases.items():
        y, s1 = rwkv_ops.rwkv6_chunk(*args)
        torch.cuda.synchronize()
        y_ref, s1_ref = rwkv_ops.rwkv6_chunk_ref(*args)
        if not (torch.isfinite(y).all() and torch.isfinite(s1).all()):
            raise AssertionError(f"rwkv6_chunk: non-finite output on the {name} input")
        torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(s1, s1_ref, rtol=1e-4, atol=1e-5)
        errs[name] = max(float((y - y_ref).abs().max()), float((s1 - s1_ref).abs().max()))
    info = rwkv_ops.kernel_info()
    sass = _sass_counts("rwkv6_chunk")
    args = cases["prefill shape"]
    y, s1 = rwkv_ops.rwkv6_chunk(*args)
    n_bytes = _nbytes(*args, y, s1)
    flops, exps = _chunk_work(LM_BATCH, cfg.ssm_chunk, h, p)
    bound_ms, bound_by = _bound(n_bytes, flops + exps)
    entry = {
        "name": "rwkv6_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6/csrc/rwkv6_chunk.cu",
        "replaces": "src/repro/kernels/rwkv6/rwkv6.py:23",
        "max_abs_err": errs["prefill shape"],
        "max_abs_err_cases": errs,
        **{f"kernel_{k}": v for k, v in info.items()},
        "sass_counts": sass,
        "ms": time_ms(lambda: rwkv_ops.rwkv6_chunk(*args)),
        "plain_ms": time_ms(lambda: rwkv_ops.rwkv6_chunk_ref(*args), repeats=10, inner=5),
        "device_ms": device_ms(lambda: rwkv_ops.rwkv6_chunk(*args), "rwkv6_chunk_kernel"),
        "bytes": n_bytes,
        "flops": flops,
        "exps": exps,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes a WKV chunk
        "shape": f"r/k/v/log_w [{LM_BATCH},{cfg.ssm_chunk},{h},{p}] f32, u [{h},{p}], "
                 f"s0 [{LM_BATCH},{h},{p},{p}] f32",
    }
    cases_txt = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
    log(f"rwkv6_chunk: {info['registers']} registers, {info['local_bytes']} local (spill) bytes "
        f"per thread, {info['shared_bytes']} shared bytes and {info['blocks_per_sm']} blocks per SM; "
        f"SASS {sass}")
    log(f"rwkv6_chunk: within allclose(rtol=1e-4, atol=1e-5) of the plain version; max_abs_err "
        f"{cases_txt}; {entry['ms'] * 1e3:.2f} us/call (kernel on the "
        f"device {entry['device_ms']} ms), plain {entry['plain_ms'] * 1e3:.2f} us, bound "
        f"{bound_ms * 1e3:.3f} us ({bound_by}; {n_bytes} bytes, {flops} flops + {exps} exp)")
    return entry


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------
def _sessions(suits, seed: int = SEED) -> list[DvsSession]:
    return [
        DvsSession(
            i,
            DvsStreamSource(
                DvsStreamConfig(symbol=int(suits[i]), events_per_step=EVENTS_PER_STEP, seed=seed),
                session_id=i,
            ),
            label=int(suits[i]),
        )
        for i in range(len(suits))
    ]


KERNEL_WRAPPERS = {
    "cam_match": cam_ops.cam_match,
    "fused_deliver": fused_ops.fused_deliver,
    "fabric_deliver": fabric_ops.fabric_deliver,
    "rwkv6_chunk": rwkv_ops.rwkv6_chunk,
}
# serving legs: (label, backend, fabric_options, the kernel it must launch once per step)
LEGS = (
    ("fused", "fused", None, "fused_deliver"),
    ("cuda", "cuda", None, "cam_match"),
    ("reference", "reference", None, None),
    ("fabric", "fabric", {}, "fabric_deliver"),
    ("fabric_plain", "fabric", {"kernel": False}, None),
)


def _reset_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def _read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def check_dense_oracle(dev: torch.device) -> None:
    """A small random network on the card: the kernel backends' spikes and
    state equal the dense oracle's, step by step."""
    rng = np.random.default_rng(SEED)
    spec = NetworkSpec(n_neurons=96, cluster_size=32, k_tags=64, max_cam_words=32)
    for _ in range(150):
        spec.connect(int(rng.integers(96)), int(rng.integers(96)), int(rng.integers(4)))
    tables = compile_network(spec)
    dense = torch.as_tensor(dense_weights_from_tables(tables), device=dev)
    inp = torch.as_tensor(
        (rng.integers(0, 3, (10, 4, 3, 64)) * (rng.random((10, 4, 3, 64)) < 0.2) * 8.0)
        .astype(np.float32), device=dev,
    )
    for backend in ("cuda", "fused"):
        eng = EventEngine(tables, backend=backend, queue_capacity=96, device=dev)
        carry = eng.init_state(batch=4)
        oracle = carry
        for step in range(inp.shape[0]):
            carry, (spikes, _) = eng.step(carry, inp[step])
            ext_drive = cam_ops.cam_match_ref(inp[step], eng.tables.cam_tag, eng.tables.cam_syn, 32)
            state, ospikes = dense_reference_step(dense, oracle[1], oracle[0], eng.params, ext_drive)
            oracle = (state, ospikes)
            if spikes.shape != (4, 96) or not torch.equal(spikes, ospikes):
                raise AssertionError(f"{backend}: spikes differ from the dense oracle at step {step}")
            torch.testing.assert_close(carry[0].v, state.v, rtol=1e-5, atol=1e-7)
        if not oracle[1].numel() or not torch.isfinite(carry[0].v).all():
            raise AssertionError(f"{backend}: non-finite state")
    log("dense oracle: cuda and fused backends equal it over 10 steps of a 96-neuron network")


def profile_serving(pool: AerSessionPool, suits) -> dict:
    """Where a loaded pool's step goes: 20 steps timed part by part on the
    host clock (input building, engine launch, wait for the device, readout
    bookkeeping), then 20 steps under torch.profiler for the device-busy
    time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    for sess in _sessions(suits)[:POOL]:
        pool.admit(sess)
    for _ in range(3):
        pool.step()
    torch.cuda.synchronize()
    steps = 20
    parts = {"inputs": 0.0, "launch": 0.0, "device_wait": 0.0, "readout": 0.0}
    t_start = time.perf_counter()
    for _ in range(steps):
        t0 = time.perf_counter()
        inp = pool.gather_inputs()
        t1 = time.perf_counter()
        pool.carry, out = pool.engine.step(pool.carry, inp)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pool.finish_step(out)
        t4 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[key] += dt * 1e3 / steps
    wall_ms = (time.perf_counter() - t_start) * 1e3 / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            pool.step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_kernel: dict[str, float] = {}
    launches = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            launches += 1
    busy = sum(by_kernel.values()) / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms,
        "host_ms_per_step": parts,
        "profiled_wall_ms_per_step": prof_wall_ms,
        "device_busy_ms_per_step": busy,
        "device_ops_per_step": launches / steps,
        "device_idle_share": None if busy == 0 else max(0.0, 1.0 - busy / prof_wall_ms),
        "top_device_ms_per_step": {name: ms / steps for name, ms in top},
    }


def _serve_leg(cc, dev, backend, fabric_options, suits, expect_kernel, pool_size=POOL,
               engine=None):
    """Serve ``suits``' sessions on one leg (on ``engine`` when given, else
    on a new one for ``backend``): warm up, then reset the launch counts,
    serve, read the counts and check them against one launch of
    ``expect_kernel`` per engine step (and none of the others)."""
    if engine is None:
        engine = build_poker_engine(cc.tables, backend=backend, device=dev,
                                    fabric_options=fabric_options)
    warm = AerSessionPool(cc, engine, AerServeConfig(pool_size=pool_size))
    warm.serve(_sessions(suits)[:2])  # first-use allocations and library loads
    pool = AerSessionPool(cc, engine, AerServeConfig(pool_size=pool_size))
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    results = pool.serve(_sessions(suits))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    want = {name: (pool.n_steps if name == expect_kernel else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{backend} {fabric_options}: launches {counts}, expected {want}")
    if not all(torch.isfinite(x).all() for x in (pool.carry[0].v, pool.carry[0].i_syn)):
        raise AssertionError(f"{backend}: non-finite neuron state after serving")
    by_id = sorted(results, key=lambda r: r.session_id)
    lat = np.array([r.latency_steps for r in by_id], dtype=np.float64)
    return {
        "results": [(r.session_id, r.prediction, r.decided, r.latency_steps,
                     r.counts.tolist(), r.dropped, r.link_dropped, r.error) for r in by_id],
        "accuracy": float(np.mean([r.correct for r in by_id])),
        "latency_p50_steps": float(np.percentile(lat, 50)),
        "latency_p99_steps": float(np.percentile(lat, 99)),
        "sessions_per_s": len(results) / wall,
        "steps_per_s": pool.n_steps / wall,
        "engine_steps": pool.n_steps,
        "link_dropped": sum(r.link_dropped for r in by_id),
        "wall_s": wall,
        "launches": counts,
    }


def phase_serving(dev: torch.device) -> dict[str, int]:
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    fc_select = tune_poker_readout(dev, rng)
    torch.cuda.synchronize()
    log(f"calibration run (12 streams x 40 steps, reference backend): "
        f"{time.perf_counter() - t0:.2f} s")
    cc = compile_poker_cnn(fc_select=fc_select)
    suits = rng.integers(0, 4, SESSIONS)
    runs: dict[str, dict] = {}
    launches: dict[str, int] = {}
    for label, backend, options, kernel in LEGS:
        r = runs[label] = _serve_leg(cc, dev, backend, options, suits, kernel)
        if kernel is not None:
            launches[kernel] = r["launches"][kernel]
        log(f"serve[{label}]: {SESSIONS} sessions, accuracy {r['accuracy']:.4f}, latency p50 "
            f"{r['latency_p50_steps']:.1f} / p99 {r['latency_p99_steps']:.1f} steps, "
            f"{r['sessions_per_s']:.2f} sessions/s, {r['steps_per_s']:.2f} steps/s "
            f"({r['engine_steps']} steps, {r['wall_s']:.3f} s), link drops {r['link_dropped']}, "
            f"launches {r['launches']}")
        if r["accuracy"] < 0.95:
            raise AssertionError(f"{label}: accuracy {r['accuracy']} < 0.95")
    for group in (("fused", "cuda", "reference"), ("fabric", "fabric_plain")):
        for label in group[1:]:
            if runs[label]["results"] != runs[group[0]]["results"]:
                raise AssertionError(f"{label} sessions differ from {group[0]}'s")
    log("serve: fused, cuda and reference agree on every session, and so do the fabric's "
        "kernel and plain legs (prediction, decided, latency, counts, drops, link drops)")
    # links that really drop: the fabric legs at link capacity 8 on 32 sessions
    capped = {
        kernel: _serve_leg(cc, dev, "fabric", {"link_capacity": 8, "kernel": kernel},
                           suits[:POOL], "fabric_deliver" if kernel else None)
        for kernel in (True, False)
    }
    if capped[True]["results"] != capped[False]["results"] or capped[True]["link_dropped"] == 0:
        raise AssertionError("fabric at link capacity 8: kernel and plain legs differ, or no drops")
    runs["fabric_cap8"] = capped[True]
    log(f"serve[fabric, link capacity 8]: {POOL} sessions, kernel and plain legs agree, "
        f"{capped[True]['link_dropped']} link drops, accuracy {capped[True]['accuracy']:.4f}, "
        f"{capped[True]['engine_steps']} steps")
    check_dense_oracle(dev)

    prof = {}
    for backend, options in (("fused", None), ("cuda", None), ("fabric", {})):
        engine = build_poker_engine(cc.tables, backend=backend, device=dev, fabric_options=options)
        prof[backend] = profile_serving(AerSessionPool(cc, engine, AerServeConfig(pool_size=POOL)), suits)
        p = prof[backend]
        host = ", ".join(f"{k} {v:.3f}" for k, v in p["host_ms_per_step"].items())
        log(f"profile[{backend}]: {p['wall_ms_per_step']:.3f} ms/step wall ({host} ms); "
            f"device busy {p['device_busy_ms_per_step']:.3f} ms/step over "
            f"{p['device_ops_per_step']:.1f} device ops, idle share {p['device_idle_share']}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    summary = {k: {kk: vv for kk, vv in v.items() if kk != "results"} for k, v in runs.items()}
    (OUT_DIR / "chip_smoke_serving.json").write_text(
        json.dumps({"serving": summary, "profile": prof}, indent=1)
    )
    v1 = {"cc": cc, "fc_select": fc_select, "suits": suits,
          "results": {k: runs[k]["results"] for k in ("fused", "cuda")}}
    return launches, v1


# ---------------------------------------------------------------------------
# phase 3b: compiler v2, the traffic feedback loop and the dispatch autotuner
# ---------------------------------------------------------------------------
# What the JAX package gives for this phase's workloads (integer counts and
# a placement from its CPU run; the port must reproduce them on the card):
# the feedback loop of benchmarks/serving.py (a 32-slot Table-V pool on the
# 3x3 fabric at link capacity 2 with the corners-first placement, sessions
# of seed 23, 16 steps) and the Table-IV shuffle network of
# benchmarks/routing_throughput.py (4x4 tiles of 4 cores, clusters of 8,
# K = 64, rng seed 17; one all-spiking step at link capacity 1).
STALE_PLACEMENT = np.array([0, 8, 2, 6, 4, 5], np.int32)
LOOP_SEED, LOOP_STEPS = 23, 16
LOOP_DROPS = {"before": 2219, "after": 374}
LOOP_PLACEMENT = [4, 5, 4, 4, 4, 1]
SHUFFLE_DROPS = {"v1_default": 904, "v2_optimized": 154}
COMPILER_PATH_KERNELS = ("cam_match", "fused_deliver", "fabric_deliver")


def _counted(fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: ``(result, counts)``."""
    torch.cuda.synchronize()
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, _read_counts()


def _expect_launches(counts: dict, want: dict, what: str) -> None:
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, expected {full}")


def check_table_v_v2(dev, v1, launched) -> dict:
    """Table-V compiled by v2 (the reuse allocator, with its report). With
    the default readout no two allocation units share a source set, so the
    tables' fingerprint equals v1's. The serving phase's Hebbian readout
    selects some pool neurons for several classes, whose units v2 merges:
    its tables differ from v1's but realize the same dense connectivity,
    and the 64 sessions on the fused and cuda legs must equal the serving
    phase's v1 legs, session for session."""
    default_v1 = compile_poker_cnn()
    default_v2 = compile_poker_cnn(allocator="reuse", with_report=True)
    if default_v2.tables.fingerprint() != default_v1.tables.fingerprint():
        raise AssertionError("default Table-V under allocator='reuse' differs from v1's tables")
    cc1 = v1["cc"]
    cc2 = compile_poker_cnn(fc_select=v1["fc_select"], allocator="reuse", with_report=True)
    if not np.array_equal(cc2.tables.dense_equivalent(), cc1.tables.dense_equivalent()):
        raise AssertionError("Hebbian Table-V: v2's dense connectivity differs from v1's")
    reports = {"default": default_v2.report, "hebbian": cc2.report}
    for name, rep in reports.items():
        for line in rep.summary().splitlines():
            log(f"compiler v2, Table-V ({name} readout): {line}")
    legs = {}
    for label, kernel in (("fused", "fused_deliver"), ("cuda", "cam_match")):
        r = _serve_leg(cc2, dev, label, None, v1["suits"], kernel)
        launched.update(r["launches"])
        if r["results"] != v1["results"][label]:
            raise AssertionError(f"v2 Table-V on {label}: sessions differ from the v1 leg's")
        legs[label] = {k: r[k] for k in ("accuracy", "latency_p50_steps", "sessions_per_s",
                                          "engine_steps", "launches")}
    log(f"compiler v2, Table-V: the default readout's tables equal v1's (fingerprint "
        f"{default_v2.tables.fingerprint()[:16]}); on the Hebbian readout's v2 tables "
        f"({int(cc2.report.tags_used.sum())} tags against v1's {int(cc2.report.tags_v1.sum())}) "
        f"{SESSIONS} sessions on fused and cuda equal the v1 legs (prediction, decided, latency, "
        f"counts, drops)")
    return {
        "default_fingerprint": default_v2.tables.fingerprint(),
        "hebbian_fingerprints": {"v1": cc1.tables.fingerprint(), "v2": cc2.tables.fingerprint()},
        **{f"{name}_report": {"tags_v2": int(rep.tags_used.sum()), "tags_v1": int(rep.tags_v1.sum()),
                              "sram_bits": rep.sram_bits, "cam_bits": rep.cam_bits,
                              "measured_bits_per_neuron": rep.measured_bits_per_neuron,
                              "eq2_bits_per_neuron": rep.eq2_bits_per_neuron}
           for name, rep in reports.items()},
        "legs": legs,
    }


def _profile_record(profile) -> dict:
    return {"pair_delivered": profile.pair_delivered.tolist(),
            "link_dropped": profile.link_dropped.tolist(), "dropped": profile.dropped,
            "steps": profile.steps, "total_link_dropped": profile.total_link_dropped}


def check_feedback_loop(dev, launched) -> dict:
    """Measure -> optimize -> recompile on the card: the stale-placement
    pool serves LOOP_STEPS steps with per-link stats through
    ``fabric_deliver`` (and on the ``kernel=False`` leg), its measured
    profile is re-placed by ``optimize_placement``, and a pool on the
    re-placed tables serves the same cohort. Both legs must give the same
    profiles and placement, and the JAX package's drops and placement. Then
    the host time per step of the profiled pool beside an unprofiled one."""
    cc = compile_poker_cnn()
    suits = np.random.default_rng(LOOP_SEED).integers(0, 4, POOL)
    cfg = AerServeConfig(pool_size=POOL, max_steps=10**6)

    def pool_on(placement, kernel=True, per_link_stats=True):
        tables = dataclasses.replace(cc.tables, tile_of_cluster=placement)
        opts = {"link_capacity": 2, "per_link_stats": per_link_stats, "kernel": kernel}
        engine = build_poker_engine(tables, "fabric", device=dev, fabric_options=opts)
        pool = AerSessionPool(dataclasses.replace(cc, tables=tables), engine, cfg)
        for sess in _sessions(suits, seed=LOOP_SEED):
            pool.admit(sess)
        return pool

    def serve(pool):
        for _ in range(LOOP_STEPS):
            pool.step()
        return pool

    legs = {}
    for kernel in (True, False):
        want = {"fabric_deliver": LOOP_STEPS} if kernel else {}
        before, counts = _counted(lambda: serve(pool_on(STALE_PLACEMENT, kernel)))
        _expect_launches(counts, want, f"feedback loop before, kernel={kernel}")
        launched.update(counts)
        placement, info = optimize_placement(before.profile.matrix(), Fabric(),
                                             init=STALE_PLACEMENT, seed=0)
        after, counts = _counted(lambda: serve(pool_on(placement, kernel)))
        _expect_launches(counts, want, f"feedback loop after, kernel={kernel}")
        launched.update(counts)
        legs[kernel] = {"before": _profile_record(before.profile),
                        "after": _profile_record(after.profile),
                        "placement": placement.tolist(), "info": info,
                        "fingerprint_before": before.fingerprint(),
                        "fingerprint_after": after.fingerprint()}
    if legs[True] != legs[False]:
        raise AssertionError("feedback loop: the kernel and plain legs differ (profile, "
                             "placement or fingerprints)")
    got = legs[True]
    drops = {k: int(got[k]["total_link_dropped"]) for k in ("before", "after")}
    if drops != LOOP_DROPS or got["placement"] != LOOP_PLACEMENT:
        raise AssertionError(f"feedback loop: drops {drops} and placement {got['placement']}, "
                             f"the JAX package gives {LOOP_DROPS} and {LOOP_PLACEMENT}")
    if got["fingerprint_before"] == got["fingerprint_after"]:
        raise AssertionError("feedback loop: the re-placed pool has the stale pool's fingerprint")

    # host time per step, in turns: the profiled pool; the same engine's
    # per-link stats without the profile folded (the profile's own cost);
    # an engine without per-link stats
    timed = {"profiled": pool_on(STALE_PLACEMENT), "per_link_stats_only": pool_on(STALE_PLACEMENT),
             "unprofiled": pool_on(STALE_PLACEMENT, per_link_stats=False)}
    timed["per_link_stats_only"].profile = None
    ms = {name: [] for name in timed}
    for pool in timed.values():
        for _ in range(3):
            pool.step()
    for _ in range(3):
        for name, pool in timed.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(pool)
            ms[name].append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
    log(f"feedback loop ({POOL} slots, link capacity 2, {LOOP_STEPS} steps; kernel and plain "
        f"legs equal): link drops {drops['before']} at {STALE_PLACEMENT.tolist()} -> "
        f"{drops['after']} at {got['placement']}; predicted mean hops "
        f"{got['info']['mean_hops_init']:.3f} -> {got['info']['mean_hops_final']:.3f}; "
        f"pool fingerprints {got['fingerprint_before'][:16]} -> {got['fingerprint_after'][:16]}")
    log("feedback loop: host ms per step, " + "; ".join(
        f"{name} {[round(x, 3) for x in v]}" for name, v in ms.items()))
    return {"drops": drops, "placement": got["placement"], "info": got["info"],
            "fingerprints": [got["fingerprint_before"], got["fingerprint_after"]],
            "profile_before": got["before"], "profile_after": got["after"],
            "host_ms_per_step": ms}


def shuffle_spec(fab: Fabric, cluster: int, k: int) -> NetworkSpec:
    """The Table-IV shuffle network of benchmarks/routing_throughput.py:
    cluster c fans into cluster perm(c) through two connect-groups per
    source (rng seed 17)."""
    nc = fab.n_cores
    rng = np.random.default_rng(17)
    perm = rng.permutation(nc)
    spec = NetworkSpec(n_neurons=nc * cluster, cluster_size=cluster, k_tags=k)
    fan = min(4, cluster)
    for s in range(spec.n_neurons):
        dst_cl = int(perm[s // cluster])
        for syn in (0, int(1 + rng.integers(3))):
            dsts = dst_cl * cluster + rng.choice(cluster, size=fan, replace=False)
            spec.connect_one_to_many(s, [int(d) for d in dsts], syn)
    return spec


def _shuffle_step(tables, fab, dev, kernel):
    """One all-spiking fabric step at link capacity 1 (batch 1)."""
    eng = EventEngine(tables, fabric=fab, fabric_options={"link_capacity": 1, "kernel": kernel},
                      device=dev)
    state, spikes, ring, cursor = eng.init_state(batch=1)
    carry = (state, torch.ones_like(spikes), ring, cursor)
    zero = torch.zeros((1, tables.n_clusters, tables.k_tags), device=dev)
    (carry, (spikes, stats)), counts = _counted(lambda: eng.step(carry, zero))
    _expect_launches(counts, {"fabric_deliver": 1} if kernel else {}, "shuffle step")
    return (spikes, *carry[2:]), stats, counts


def _delayed_dense_weights(tables, model, dev) -> list[torch.Tensor]:
    """The dense oracle's ``[N, N, 4]`` weights split by the fabric arrival
    delay of each connection's cluster pair: ``w[d]`` arrives ``d`` steps
    late."""
    dense = torch.as_tensor(dense_weights_from_tables(tables), device=dev)
    cl = torch.arange(tables.n_neurons, device=dev) // tables.cluster_size
    delay = torch.as_tensor(np.asarray(model.delay_steps), device=dev)[cl[:, None], cl[None, :]]
    return [dense * (delay == d)[..., None] for d in range(model.max_delay + 1)]


def check_retargeted(spec, dev, launched) -> dict:
    """``retarget`` to 2x2 tiles of 4 cores of 32 neurons, ``save`` under
    build/, ``load`` with an equal fingerprint, ``entry_table(dev)`` equal to
    the engine's own entries, and 4 steps of 4 streams through
    ``fabric_deliver`` equal to the delayed dense oracle, spikes step for
    step."""
    geo = Geometry(grid_x=2, grid_y=2, cores_per_tile=4, neurons_per_core=32, k_tags=64)
    art = retarget(spec, geo)
    fz = art.feasibility
    if not fz.feasible or fz.binding != "cores" or fz.utilization["cores"] != 1.0:
        raise AssertionError(f"retarget to 2x2: {fz.asdict()}")
    back = CompiledArtifact.load(art.save(str(OUT_DIR / "artifact_2x2")))
    if back.fingerprint() != art.fingerprint():
        raise AssertionError("the saved 2x2 artifact loads with another fingerprint")
    t = back.tables
    eng = EventEngine(t, fabric=back.geometry.fabric(), queue_capacity=t.n_neurons, device=dev)
    entries = back.entry_table(dev)
    for f in dataclasses.fields(entries):
        if not torch.equal(getattr(entries, f.name), getattr(eng._fabric_entries, f.name)):
            raise AssertionError(f"entry_table({dev}).{f.name} differs from the engine's entries")
    w = _delayed_dense_weights(t, eng.fabric_model, dev)
    rng = np.random.default_rng(SEED)
    batch, steps = 4, 4
    state, _, ring, cursor = eng.init_state(batch=batch)
    spikes = torch.as_tensor((rng.random((batch, t.n_neurons)) < 0.5).astype(np.float32),
                             device=dev)
    carry = (state, spikes, ring, cursor)
    history = [spikes] + [torch.zeros_like(spikes)] * (len(w) - 1)  # newest first
    o_state, total_spikes = state, 0

    def run():
        nonlocal carry, history, o_state, total_spikes
        for step in range(steps):
            ext = torch.as_tensor((rng.integers(0, 3, (batch, t.n_clusters, t.k_tags)) * 8.0)
                                  .astype(np.float32), device=dev)
            carry, (got, stats) = eng.step(carry, ext)
            drive = stage2_cam_match(ext, eng.tables.cam_tag, eng.tables.cam_syn, t.cluster_size)
            for d, wd in enumerate(w):
                drive = drive + torch.einsum("dst,bs->bdt", wd, history[d])
            o_state, o_spikes = neuron_step(o_state, drive, eng.params)
            if int(stats.link_dropped.sum()) != 0 or not torch.equal(got, o_spikes):
                raise AssertionError(f"2x2 artifact: spikes differ from the dense oracle at "
                                     f"step {step}")
            torch.testing.assert_close(carry[0].v, o_state.v, rtol=1e-5, atol=1e-7)
            history = [o_spikes] + history[:-1]
            total_spikes += int(got.sum())

    _, counts = _counted(run)
    _expect_launches(counts, {"fabric_deliver": steps}, "2x2 artifact")
    launched.update(counts)
    log(f"retarget to 2x2 x 4 cores of 32: feasible, binding {fz.binding} at "
        f"{fz.utilization['cores']:.0%}; saved and loaded under build/ with fingerprint "
        f"{back.fingerprint()[:16]}; entry_table({dev}) equals the engine's; {steps} steps of "
        f"{batch} streams through fabric_deliver equal the dense oracle ({total_spikes} spikes, "
        f"max_delay {eng.fabric_model.max_delay})")
    return {"fingerprint": back.fingerprint(), "feasibility": fz.asdict(),
            "oracle_steps": steps, "spikes": total_spikes}


def check_shuffle_network(dev, launched) -> dict:
    """Compiler v2 on the Table-IV shuffle network: tags and SRAM bits
    against v1, the all-spiking step at link capacity 1 under v1's default
    placement and v2's optimized one (kernel leg against plain leg),
    ``two_stage_deliver`` on the v2 tables against the dense oracle, and the
    retargeted 2x2 artifact."""
    fab = Fabric(grid_x=4, grid_y=4, cores_per_tile=4)
    cluster, k = 8, 64
    spec = shuffle_spec(fab, cluster, k)
    t_def = compile_network(spec, fabric=fab)
    res = compile_network_v2(spec, fabric=fab, seed=0)
    rep = res.report
    sizes = {"tags_v2": int(rep.tags_used.sum()), "tags_v1": int(rep.tags_v1.sum()),
             "sram_bits_v2": res.tables.sram_bits(), "sram_bits_v1": t_def.sram_bits()}
    if sizes != {"tags_v2": 512, "tags_v1": 1024, "sram_bits_v2": 6144, "sram_bits_v1": 12288}:
        raise AssertionError(f"shuffle network: {sizes}")
    steps = {}
    for label, tables in (("v1_default", t_def), ("v2_optimized", res.tables)):
        legs = {kernel: _shuffle_step(tables, fab, dev, kernel) for kernel in (True, False)}
        (kt, ks, kc), (pt, ps, _) = legs[True], legs[False]
        launched.update(kc)
        if not all(torch.equal(a, b) for a, b in zip(kt, pt)):
            raise AssertionError(f"shuffle {label}: kernel and plain legs differ (spikes, ring)")
        for f in ("dropped", "link_dropped", "delivered", "hops"):
            if not torch.equal(getattr(ks, f), getattr(ps, f)):
                raise AssertionError(f"shuffle {label}: {f} differs between the legs")
        steps[label] = {"link_dropped": int(ks.link_dropped.sum()),
                        "delivered": float(ks.delivered.sum()), "hops": float(ks.hops.sum())}
        steps[label]["hops_per_event"] = steps[label]["hops"] / steps[label]["delivered"]
    drops = {label: v["link_dropped"] for label, v in steps.items()}
    if drops != SHUFFLE_DROPS:
        raise AssertionError(f"shuffle network link drops {drops}, the JAX package gives "
                             f"{SHUFFLE_DROPS}")
    log(f"shuffle network (4x4 x 4 cores, clusters of 8, K = 64): v2 {sizes['tags_v2']} tags and "
        f"{sizes['sram_bits_v2']} SRAM bits against v1's {sizes['tags_v1']} and "
        f"{sizes['sram_bits_v1']}; all-spiking step at link capacity 1, kernel and plain legs "
        f"equal: " + "; ".join(f"{label} {v['link_dropped']} link drops, {v['delivered']:.0f} "
                               f"delivered, {v['hops_per_event']:.3f} hops/event"
                               for label, v in steps.items()))

    # two_stage_deliver on the v2 tables against the dense oracle
    t = res.tables
    tabs = [torch.as_tensor(getattr(t, f), device=dev)
            for f in ("src_tag", "src_dest", "cam_tag", "cam_syn")]
    rng = np.random.default_rng(SEED)
    spikes = torch.as_tensor((rng.random((POOL, t.n_neurons)) < 0.3).astype(np.float32),
                             device=dev)
    dense = torch.as_tensor(dense_weights_from_tables(t), device=dev)
    oracle = torch.einsum("dst,bs->bdt", dense, spikes)
    for backend, kernel in (("cuda", "cam_match"), ("fused", "fused_deliver"),
                            ("reference", None)):
        drive, counts = _counted(lambda: two_stage_deliver(spikes, *tabs, cluster, k,
                                                           backend=backend))
        _expect_launches(counts, {kernel: 1} if kernel else {}, f"two_stage_deliver {backend}")
        launched.update(counts)
        if not torch.equal(drive, oracle):
            raise AssertionError(f"two_stage_deliver on {backend}: drive differs from the dense "
                                 f"oracle by {(drive - oracle).abs().max()}")
    log(f"two_stage_deliver on the v2 shuffle tables ({POOL} streams, 30% spiking): cuda, "
        f"fused and reference equal the dense oracle, bit for bit")
    return {"sizes": sizes, "steps": steps, "report_mean_hops": rep.mean_hops,
            "retarget": check_retargeted(spec, dev, launched)}


AUTOTUNE_KERNEL = {"cuda": "cam_match", "fused": "fused_deliver"}  # served backend -> kernel


def check_autotuned_pool(dev, v1, launched) -> dict:
    """``build_poker_engine(backend="auto")`` at activity 0.1 and B = 32,
    built twice to the same decision: every candidate's µs, then the 64
    sessions on the first, equal to the fixed legs', launching the winner's
    kernel once per step whichever candidate wins (``cam_match`` for
    ``dense`` and ``queued``, ``fused_deliver`` for ``fused``)."""
    cc = v1["cc"]
    engines = [build_poker_engine(cc.tables, backend="auto", device=dev,
                                  autotune={"activity": 0.1, "batch": POOL})
               for _ in range(2)]
    engine = engines[0]
    d = engine.autotune_decision
    if engines[1].autotune_decision.token() != d.token():
        raise AssertionError(f"autotune decided {d.token()}, then "
                             f"{engines[1].autotune_decision.token()} on a rebuild")
    kernel = AUTOTUNE_KERNEL.get(engine.backend.name)
    if kernel is None:
        raise AssertionError(f"autotuned pool ({d.winner}) serves on backend "
                             f"{engine.backend.name!r}, which launches no kernel")
    r = _serve_leg(cc, dev, "auto", None, v1["suits"], kernel, engine=engine)
    launched.update(r["launches"])
    if r["results"] != v1["results"]["fused"]:
        raise AssertionError(f"autotuned pool ({d.winner}): sessions differ from the fixed legs'")
    pool = AerSessionPool(cc, engine, AerServeConfig(pool_size=POOL))
    for i, e in enumerate(engines):
        de = e.autotune_decision
        log(f"autotune build {i + 1} (activity 0.1, B = {POOL}): winner {de.winner} (backend "
            f"{e.backend.name}, dense {de.dense}), "
            + ", ".join(f"{c} {us:.1f} us" for c, us in de.measurements))
    log(f"autotune: {SESSIONS} sessions on build 1 equal the fixed legs', accuracy "
        f"{r['accuracy']:.4f}, launches {r['launches']}; pool fingerprint "
        f"{pool.fingerprint()[:16]} ({d.token()})")
    return {"winner": d.winner, "backend": engine.backend.name, "dense": d.dense,
            "token": d.token(), "measurements_us": dict(d.measurements),
            "rebuild": {"token": engines[1].autotune_decision.token(),
                        "measurements_us": dict(engines[1].autotune_decision.measurements)},
            "fingerprint": pool.fingerprint(),
            **{k: r[k] for k in ("accuracy", "latency_p50_steps", "sessions_per_s",
                                 "engine_steps", "launches")}}


def phase_compiler(dev, v1) -> dict[str, int]:
    """The compiler path: compiler v2 on Table-V, the feedback loop, the
    shuffle network with its retargeted artifact, and the autotuned pool.
    Each part sets the launch counts to 0 just before it and reads them just
    after; their sum must launch every kernel of the path."""
    launched: collections.Counter = collections.Counter()
    out = {"table_v": check_table_v_v2(dev, v1, launched),
           "feedback_loop": check_feedback_loop(dev, launched),
           "shuffle": check_shuffle_network(dev, launched),
           "autotune": check_autotuned_pool(dev, v1, launched)}
    missing = [name for name in COMPILER_PATH_KERNELS if launched[name] == 0]
    if missing:
        raise AssertionError(f"compiler phase: {missing} never launched")
    out["launches"] = dict(launched)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_compiler.json").write_text(json.dumps(out, indent=1))
    log(f"compiler phase: launches {dict(launched)}")
    return dict(launched)


# ---------------------------------------------------------------------------
# phase 4: LM serving (rwkv6-3b)
# ---------------------------------------------------------------------------
STREAM_TOL = 2.0**-5  # bfloat16 residual stream: 4 ulps at its largest element


def _stream_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Largest difference over the largest magnitude of ``want``; fails past
    STREAM_TOL. A chunk output that rounds to the next bfloat16 value moves
    the block's output by an ulp or two at the stream's scale."""
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    if not err <= STREAM_TOL:
        raise AssertionError(f"{what}: kernel and plain legs differ by {err:.3g} of the "
                             f"largest value, past {STREAM_TOL}")
    return err


def check_lm_layers(model, prompts: torch.Tensor, new_tokens: torch.Tensor) -> dict:
    """Each layer of the kernel leg against the ``rwkv_kernel=False`` leg on
    the same input: the prefill, then teacher-forced decode steps feeding the
    kernel leg's tokens. Both legs carry their own caches; the input to every
    block is the kernel leg's stream. Block outputs and logits within
    STREAM_TOL of their largest value, ``wkv`` states allclose(rtol=1e-4,
    atol=1e-3) (float32 sums in two orders, states of order 100), ``x_prev``
    equal.

    Layer by layer, because end to end the comparison says nothing: the
    randomly initialised 32-layer stack amplifies a one-ulp bfloat16
    difference in one layer's output into different logits a few layers on,
    for any two correct float32 orders of the chunk's sums (the end-to-end
    numbers are reported beside).
    """
    cfg = model.cfg
    b = prompts.shape[0]
    caches = {kernel: model.init_caches(b, LM_PROMPT + LM_NEW)["stack"] for kernel in (True, False)}
    worst = {"stream": 0.0, "logits": 0.0, "wkv": 0.0}

    def step(tokens, what):
        x = lm_layers.embed(model.embedding.table, tokens, cfg.scale_embeddings, cfg.d_model)
        x = x.to(lm_layers.dt(cfg.compute_dtype))
        for i, block in enumerate(model.stack):
            outs = {kernel: block(x, caches[kernel][i], use_kernel=kernel) for kernel in (True, False)}
            (xk, ck), (xp, cp) = outs[True], outs[False]
            worst["stream"] = max(worst["stream"], _stream_err(xk, xp, f"{what}, layer {i}"))
            torch.testing.assert_close(ck["wkv"], cp["wkv"], rtol=1e-4, atol=1e-3)
            worst["wkv"] = max(worst["wkv"], float((ck["wkv"] - cp["wkv"]).abs().max()))
            if not torch.equal(ck["x_prev"], cp["x_prev"]):
                raise AssertionError(f"{what}, layer {i}: x_prev differs")
            caches[True][i], caches[False][i] = ck, cp
            x = xk
        logits = {k: model._unembed(model.final_norm(o[0])[:, -1:]) for k, o in outs.items()}
        worst["logits"] = max(worst["logits"],
                              _stream_err(logits[True], logits[False], f"{what}, logits"))

    with torch.inference_mode():
        step(prompts, "prefill")
        for t in range(new_tokens.shape[1] - 1):
            step(new_tokens[:, t:t + 1], f"decode step {t}")
    return {"max_rel_err_stream": worst["stream"], "max_rel_err_logits": worst["logits"],
            "max_abs_err_wkv": worst["wkv"], "decode_steps": new_tokens.shape[1] - 1}


def _timed(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_lm(fn, per: int = 1) -> dict:
    """One call of ``fn`` under torch.profiler, reported per ``per`` steps:
    wall ms, device busy ms, device ops, the rwkv6_chunk kernel's device ms,
    the device idle share of the wall time and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode(), profile(activities=activities) as prof:
        _, wall_ms = _timed(fn)
    by_kernel: dict[str, float] = {}
    n_ops = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
            n_ops += 1
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {
        "steps": per,
        "wall_ms": wall_ms / per,
        "device_busy_ms": busy / per,
        "device_ops": n_ops / per,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "rwkv6_chunk_device_ms": sum(ms for name, ms in by_kernel.items()
                                     if "rwkv6_chunk_kernel" in name) / per,
        "top_device_ms": {name[:100]: ms / per for name, ms in top},
    }


def phase_lm(dev: torch.device) -> dict[str, int]:
    cfg = get_config("rwkv6-3b")
    per_prefill = cfg.n_layers * math.ceil(LM_PROMPT / cfg.ssm_chunk)
    model, init_ms = _timed(lambda: build_model(cfg, device=dev, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"rwkv6-3b: {n_params} parameters, {cfg.n_layers} layers, {cfg.param_dtype}, initialised "
        f"on the card in {init_ms:.0f} ms; memory allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    prompts_np = np.random.default_rng(SEED).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    prompts = torch.as_tensor(prompts_np, device=dev)
    engine = Engine(model, ServeConfig(max_len=LM_PROMPT + LM_NEW))

    def fresh():
        return model.init_caches(LM_BATCH, LM_PROMPT + LM_NEW)

    engine.generate(prompts[:, :96], 2)  # first-use allocations, cuBLAS handles, library load

    # the main path: Engine.generate, counts reset just before and read just after
    torch.cuda.synchronize()
    _reset_counts()
    tokens, gen_ms = _timed(lambda: engine.generate(prompts_np, LM_NEW))
    counts = _read_counts()
    want = {name: (per_prefill if name == "rwkv6_chunk" else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"rwkv6-3b generate: launches {counts}, expected {want}")
    if tokens.shape != (LM_BATCH, LM_NEW) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"rwkv6-3b generate: tokens of shape {tuple(tokens.shape)} "
                             f"in [{int(tokens.min())}, {int(tokens.max())}]")
    lm = {"generate_ms": gen_ms, "generate_tokens_per_s": LM_BATCH * LM_NEW / gen_ms * 1e3,
          "launches": counts}

    # prefill and decode timed apart (median of 3 prefills; 31 decode steps)
    with torch.inference_mode():
        prefill_ms, repeats = [], []
        for _ in range(3):
            before = rwkv_ops.rwkv6_chunk.launches
            (logits, caches), ms = _timed(lambda: model.prefill(prompts, fresh()))
            if rwkv_ops.rwkv6_chunk.launches - before != per_prefill:
                raise AssertionError("a prefill did not launch rwkv6_chunk once per chunk per layer")
            prefill_ms.append(ms)
            repeats.append(logits)
        if not torch.isfinite(logits).all() or logits.shape != (LM_BATCH, 1, cfg.vocab):
            raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, or not finite")

        def decode():
            c = caches
            for t in range(LM_NEW - 1):
                pos = torch.full((LM_BATCH, 1), LM_PROMPT + t, device=dev)
                lg, c = model.decode_step(tokens[:, t:t + 1], pos, c)
            return lg

        last, decode_ms = _timed(decode)
        if not torch.isfinite(last).all():
            raise AssertionError("decode logits are not finite")
    pf = statistics.median(prefill_ms)
    per_token = decode_ms / (LM_NEW - 1)
    lm.update(prefill_ms=pf, prefill_ms_runs=prefill_ms,
              prefill_tokens_per_s=LM_BATCH * LM_PROMPT / pf * 1e3,
              decode_ms_per_step=per_token, decode_tokens_per_s=LM_BATCH / per_token * 1e3)
    lm["prefill_bitwise_repeatable"] = all(torch.equal(x, repeats[0]) for x in repeats)
    lm["profile_prefill"] = prof = profile_lm(lambda: model.prefill(prompts, fresh()))
    lm["profile_decode"] = dprof = profile_lm(decode, per=LM_NEW - 1)
    log(f"rwkv6-3b serve (B = {LM_BATCH}, prompt {LM_PROMPT}, {LM_NEW} new, greedy): generate "
        f"{gen_ms:.1f} ms ({lm['generate_tokens_per_s']:.1f} new tokens/s), rwkv6_chunk launched "
        f"{counts['rwkv6_chunk']} times (= {cfg.n_layers} layers x {per_prefill // cfg.n_layers} "
        f"chunks); prefill {pf:.2f} ms ({lm['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{per_token:.2f} ms/step ({lm['decode_tokens_per_s']:.1f} tokens/s); three prefills "
        f"bitwise equal: {lm['prefill_bitwise_repeatable']}")
    for what, pr in (("prefill", prof), ("decode step", dprof)):
        log(f"  profiled {what}: wall {pr['wall_ms']:.2f} ms, device busy {pr['device_busy_ms']:.2f} "
            f"ms over {pr['device_ops']:.0f} device ops, idle share {pr['device_idle_share']:.3f}, "
            f"rwkv6_chunk {pr['rwkv6_chunk_device_ms']:.3f} ms")

    # the kernel leg against the rwkv_kernel=False leg, layer by layer
    lm["layers"] = check_lm_layers(model, prompts, tokens)
    log(f"rwkv6-3b kernel vs plain leg, layer by layer (prefill + {LM_NEW - 1} teacher-forced decode "
        f"steps): block outputs within {lm['layers']['max_rel_err_stream']:.3g} and logits within "
        f"{lm['layers']['max_rel_err_logits']:.3g} of their largest value (limit {STREAM_TOL}); wkv "
        f"max abs err {lm['layers']['max_abs_err_wkv']:.3g}, allclose(rtol=1e-4, atol=1e-3)")
    # end to end, for the record: the plain leg's own prefill and tokens
    model.rwkv_kernel = False
    with torch.inference_mode():
        (plain_logits, _), plain_ms = _timed(lambda: model.prefill(prompts, fresh()))
    plain_tokens = engine.generate(prompts_np, LM_NEW)
    model.rwkv_kernel = True
    lm["plain_leg"] = {
        "prefill_ms": plain_ms,
        "end_to_end_prefill_logits_max_abs_diff": float((plain_logits - logits).abs().max()),
        "prefill_logits_max_abs": float(logits.abs().max()),
        "greedy_tokens_equal_share": float((plain_tokens == tokens).float().mean()),
        "first_token_equal_share": float((plain_tokens[:, 0] == tokens[:, 0]).float().mean()),
    }
    log(f"rwkv6-3b plain leg end to end: prefill {plain_ms:.1f} ms; prefill logits max abs diff "
        f"{lm['plain_leg']['end_to_end_prefill_logits_max_abs_diff']:.3g} (logits up to "
        f"{lm['plain_leg']['prefill_logits_max_abs']:.3g}); greedy tokens equal "
        f"{lm['plain_leg']['greedy_tokens_equal_share']:.3f} (first token "
        f"{lm['plain_leg']['first_token_equal_share']:.3f})")
    del model, engine, caches, logits, plain_logits
    torch.cuda.empty_cache()
    lm["fp32_two_layers"] = check_fp32_sequential(dev, cfg, prompts)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_lm.json").write_text(json.dumps(lm, indent=1))
    return {"rwkv6_chunk": counts["rwkv6_chunk"]}


def check_fp32_sequential(dev: torch.device, cfg, prompts: torch.Tensor) -> dict:
    """rwkv6-3b at full width, 2 layers, float32: the chunked prefill on the
    kernel against the sequential oracle (repro's rwkv6_sequential_core).
    Logits allclose(rtol=1e-3, atol=1e-4); states allclose(rtol=1e-3,
    atol=1e-3): float32 sums over 512 tokens in two orders, states of order
    100. With 2 layers and no bfloat16 rounding the two stay close end to end."""
    cfg32 = dataclasses.replace(cfg, n_periods=2, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED)
    b = prompts.shape[0]
    max_len = LM_PROMPT + LM_NEW
    with torch.inference_mode():
        before = rwkv_ops.rwkv6_chunk.launches
        (logits, caches), chunked_ms = _timed(
            lambda: model.prefill(prompts, model.init_caches(b, max_len)))
        launched = rwkv_ops.rwkv6_chunk.launches - before
        (seq_logits, seq_caches), seq_ms = _timed(
            lambda: model.prefill(prompts, model.init_caches(b, max_len), sequential=True))
    want = cfg32.n_layers * math.ceil(prompts.shape[1] / cfg.ssm_chunk)
    if launched != want or rwkv_ops.rwkv6_chunk.launches - before != want:
        raise AssertionError(f"fp32 chunked prefill launched rwkv6_chunk {launched} times, not {want}")
    torch.testing.assert_close(logits, seq_logits, rtol=1e-3, atol=1e-4)
    for got, ref in zip(caches["stack"], seq_caches["stack"]):
        torch.testing.assert_close(got["wkv"], ref["wkv"], rtol=1e-3, atol=1e-3)
    out = {
        "logits_max_abs_err": float((logits - seq_logits).abs().max()),
        "wkv_max_abs_err": max(float((g["wkv"] - r["wkv"]).abs().max())
                               for g, r in zip(caches["stack"], seq_caches["stack"])),
        "chunked_ms": chunked_ms, "sequential_ms": seq_ms,
    }
    log(f"rwkv6-3b fp32, 2 layers at full width: chunked prefill on the kernel equals the sequential "
        f"oracle (logits max abs err {out['logits_max_abs_err']:.3g}, wkv {out['wkv_max_abs_err']:.3g}); "
        f"{chunked_ms:.1f} ms chunked, {seq_ms:.1f} ms sequential")
    del model
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_card_and_build()
    kernels = phase_kernels(dev)
    launches, v1 = phase_serving(dev)
    compiler_launches = phase_compiler(dev, v1)
    launches.update(phase_lm(dev))
    if set(launches) != set(kernels):
        raise AssertionError(f"serving legs launched {sorted(launches)}, kernels {sorted(kernels)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the serving path")
        kernels[name]["launches"] = n
        kernels[name]["launches_compiler_phase"] = compiler_launches.get(name, 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = [{**{k: v[k] for k in keys}, "kernel_ms": v["ms"],
             **{k: v[k] for k in v if k not in keys}} for v in kernels.values()]
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
