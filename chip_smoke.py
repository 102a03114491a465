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
     from torch.profiler. ``fabric_deliver`` is also carried over
     2*(max_delay+1)+1 steps on a geometry with max_delay = 2 and link
     capacity 2, where the kernel and plain legs must carry equal rings;
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
     steps per kernel backend says where the device time goes.

Prints a ``{"kernels": [...]}`` JSON line, then as the last line
``{"ok": true, "device": {...}}``. TF32 is off throughout (the plain stage 2
contracts a one-hot with a float32 matmul). Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.cnn import compile_poker_cnn  # noqa: E402
from repro_torch.core.dispatch import FabricBackend  # noqa: E402
from repro_torch.core.event_engine import (  # noqa: E402
    EventEngine,
    dense_reference_step,
    dense_weights_from_tables,
)
from repro_torch.core.routing import ChipConstants, Fabric  # noqa: E402
from repro_torch.core.tags import NetworkSpec, compile_network  # noqa: E402
from repro_torch.core.two_stage import compact_events  # noqa: E402
from repro_torch.data.pipeline import DvsStreamConfig, DvsStreamSource  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cam_match import ops as cam_ops  # noqa: E402
from repro_torch.kernels.fabric_deliver import ops as fabric_ops  # noqa: E402
from repro_torch.kernels.fused_deliver import ops as fused_ops  # noqa: E402
from repro_torch.serve.aer import (  # noqa: E402
    AerServeConfig,
    AerSessionPool,
    DvsSession,
    build_poker_engine,
    tune_poker_readout,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
POOL, SESSIONS, SEED, EVENTS_PER_STEP = 32, 64, 7, 16
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


def device_ms(fn, kernel_name: str, calls: int = 50) -> float | None:
    """Mean device time of the kernel named ``kernel_name`` per call, from
    torch.profiler; None when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.events():
        if kernel_name in evt.name and evt.device_type == torch.autograd.DeviceType.CUDA:
            total_us += evt.time_range.elapsed_us()
            count += 1
    return None if count == 0 else total_us / count / 1e3


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
    nc, k, cs = t.n_clusters, t.k_tags, t.cluster_size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    valid_words = int((cam_tag >= 0).sum())
    out: dict[str, dict] = {}

    # -- cam_match: [B, nc, K] activity -> [B, N, 4] drive ----------------
    act_int = torch.randint(0, 17, (POOL, nc, k), generator=gen, device=dev).float() * 8.0
    act_flt = torch.rand((POOL, nc, k), generator=gen, device=dev)
    got_int = cam_ops.cam_match(act_int, cam_tag, cam_syn, cs)
    got_flt = cam_ops.cam_match(act_flt, cam_tag, cam_syn, cs)
    torch.cuda.synchronize()
    ref_int = cam_ops.cam_match_ref(act_int, cam_tag, cam_syn, cs)
    ref_flt = cam_ops.cam_match_ref(act_flt, cam_tag, cam_syn, cs)
    if not torch.equal(got_int, ref_int):
        raise AssertionError(
            f"cam_match not bit-exact on integer inputs: max err {(got_int - ref_int).abs().max()}"
        )
    torch.testing.assert_close(got_flt, ref_flt, rtol=1e-6, atol=1e-6)
    n_bytes = _nbytes(act_flt, cam_tag, cam_syn, got_flt)
    bound_ms, bound_by = _bound(n_bytes, POOL * valid_words)
    out["cam_match"] = {
        "name": "cam_match",
        "route": "cuda",
        "source": "src/repro_torch/kernels/cam_match/csrc/cam_match.cu",
        "replaces": "src/repro/kernels/cam_match/cam_match.py:39",
        "max_abs_err": float((got_flt - ref_flt).abs().max()),
        "max_abs_err_integer_inputs": float((got_int - ref_int).abs().max()),
        "ms": time_ms(lambda: cam_ops.cam_match(act_flt, cam_tag, cam_syn, cs)),
        "plain_ms": time_ms(lambda: cam_ops.cam_match_ref(act_flt, cam_tag, cam_syn, cs)),
        "device_ms": device_ms(lambda: cam_ops.cam_match(act_flt, cam_tag, cam_syn, cs),
                               "cam_match_kernel"),
        "bytes": n_bytes,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the CAM match
        "shape": f"activity [{POOL},{nc},{k}] f32, cam [{t.n_neurons},{t.cam_tag.shape[1]}] i32",
    }

    # -- fused_deliver: queue + ext [B, nc, K] -> [B, N, 4] drive ---------
    # 10% of neurons spiking: the queue (capacity N, as the pool sizes it)
    # holds every active source, so Q*E = 1536*16 entries per slot reach
    # the kernel
    active = torch.rand((POOL, t.n_neurons), generator=gen, device=dev) < 0.1
    spikes_int = active.float()
    spikes_flt = active * torch.rand((POOL, t.n_neurons), generator=gen, device=dev)
    ext_int = torch.randint(0, 3, (POOL, nc, k), generator=gen, device=dev).float() * 8.0
    ext_flt = torch.rand((POOL, nc, k), generator=gen, device=dev)
    q_int = compact_events(spikes_int, t.n_neurons)
    q_flt = compact_events(spikes_flt, t.n_neurons)
    tabs = (src_tag, src_dest, cam_tag, cam_syn)
    got_int = fused_ops.fused_deliver(q_int, *tabs, cs, k, external_activity=ext_int)
    got_flt = fused_ops.fused_deliver(q_flt, *tabs, cs, k, external_activity=ext_flt)
    torch.cuda.synchronize()
    ref_int = fused_ops.fused_deliver_ref(q_int, *tabs, cs, k, external_activity=ext_int)
    ref_flt = fused_ops.fused_deliver_ref(q_flt, *tabs, cs, k, external_activity=ext_flt)
    if not torch.equal(got_int, ref_int):
        raise AssertionError(
            f"fused_deliver not bit-exact on integer inputs: max err {(got_int - ref_int).abs().max()}"
        )
    torch.testing.assert_close(got_flt, ref_flt, rtol=1e-6, atol=1e-6)
    ev_flat, _ = fused_ops._event_entries_flat(q_flt, src_tag, src_dest, k)
    n_bytes = _nbytes(q_flt.src, q_flt.weight, src_tag, src_dest, ext_flt, cam_tag, cam_syn, got_flt)
    bound_ms, bound_by = _bound(n_bytes, int((ev_flat >= 0).sum()) + POOL * valid_words)
    out["fused_deliver"] = {
        "name": "fused_deliver",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_deliver/csrc/fused_deliver.cu",
        "replaces": "src/repro/kernels/fused_deliver/fused_deliver.py:42",
        "max_abs_err": float((got_flt - ref_flt).abs().max()),
        "max_abs_err_integer_inputs": float((got_int - ref_int).abs().max()),
        "ms": time_ms(lambda: fused_ops.fused_deliver(q_flt, *tabs, cs, k, external_activity=ext_flt)),
        "plain_ms": time_ms(
            lambda: fused_ops.fused_deliver_ref(q_flt, *tabs, cs, k, external_activity=ext_flt)
        ),
        "device_ms": device_ms(
            lambda: fused_ops.fused_deliver(q_flt, *tabs, cs, k, external_activity=ext_flt),
            "fused_deliver_kernel",
        ),
        "bytes": n_bytes,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes queue -> drive
        "shape": f"queue [{POOL},{t.n_neurons}] -> entries [{POOL},{ev_flat.shape[-1]}], "
                 f"ext [{POOL},{nc},{k}] f32",
    }
    out["fabric_deliver"] = fabric_kernel_entry(dev, t, cam_tag, cam_syn, gen)
    check_fabric_wrap(dev)
    for v in out.values():
        log(f"{v['name']}: bit-exact on integer inputs; max_abs_err {v['max_abs_err']:.3g} on "
            f"random floats, within allclose(rtol=1e-6, atol=1e-6); "
            f"{v['ms'] * 1e3:.2f} us/call (kernel on the device {v['device_ms']} ms), plain "
            f"{v['plain_ms'] * 1e3:.2f} us, bound {v['bound_ms'] * 1e3:.3f} us ({v['bound_by']})")
    return out


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
    w_int = (torch.rand((POOL, m), generator=gen, device=dev) < 0.1).float()
    w_flt = w_int * torch.rand((POOL, m), generator=gen, device=dev)
    ring_int = torch.randint(0, 3, (POOL, d1, nc, k), generator=gen, device=dev).float()
    ring_flt = torch.rand((POOL, d1, nc, k), generator=gen, device=dev)
    ext_int = torch.randint(0, 3, (POOL, nc, k), generator=gen, device=dev).float() * 8.0
    ext_flt = torch.rand((POOL, nc, k), generator=gen, device=dev)
    errs_int, errs_flt = [], []
    for cursor in range(d1):
        cur = torch.tensor(cursor, dtype=torch.int32, device=dev)
        for w, ring, ext, errs in ((w_int, ring_int, ext_int, errs_int),
                                   (w_flt, ring_flt, ext_flt, errs_flt)):
            args = (entries.dstk, entries.delay, w, ring, cur, ext, cam_tag, cam_syn, cs, k)
            drive, new_ring = fabric_ops.fabric_deliver(*args)
            torch.cuda.synchronize()
            p_drive, p_ring = fabric_ops.fabric_deliver_ref(*args)
            errs.append(max(float((drive - p_drive).abs().max()),
                            float((new_ring - p_ring).abs().max())))
            if w is w_int and not (torch.equal(drive, p_drive) and torch.equal(new_ring, p_ring)):
                raise AssertionError(f"fabric_deliver not bit-exact on integer inputs: {errs[-1]}")
            torch.testing.assert_close(drive, p_drive, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(new_ring, p_ring, rtol=1e-6, atol=1e-6)
    cur = torch.tensor(0, dtype=torch.int32, device=dev)
    args = (entries.dstk, entries.delay, w_flt, ring_flt, cur, ext_flt, cam_tag, cam_syn, cs, k)
    drive, new_ring = fabric_ops.fabric_deliver(*args)
    valid_words = int((cam_tag >= 0).sum())
    n_bytes = _nbytes(entries.dstk, entries.delay, w_flt, ring_flt, cur, ext_flt, cam_tag,
                      cam_syn, drive, new_ring)
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
        "ms": time_ms(lambda: fabric_ops.fabric_deliver(*args)),
        "plain_ms": time_ms(lambda: fabric_ops.fabric_deliver_ref(*args)),
        "device_ms": device_ms(lambda: fabric_ops.fabric_deliver(*args), "fabric_deliver_kernel"),
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


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------
def _sessions(suits) -> list[DvsSession]:
    return [
        DvsSession(
            i,
            DvsStreamSource(
                DvsStreamConfig(symbol=int(suits[i]), events_per_step=EVENTS_PER_STEP, seed=SEED),
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


def _serve_leg(cc, dev, backend, fabric_options, suits, expect_kernel, pool_size=POOL):
    """Serve ``suits``' sessions on one leg: warm up, then reset the launch
    counts, serve, read the counts and check them against one launch of
    ``expect_kernel`` per engine step (and none of the others)."""
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
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_card_and_build()
    kernels = phase_kernels(dev)
    launches = phase_serving(dev)
    if set(launches) != set(kernels):
        raise AssertionError(f"serving legs launched {sorted(launches)}, kernels {sorted(kernels)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the serving path")
        kernels[name]["launches"] = n
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
