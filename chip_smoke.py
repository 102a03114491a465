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
     kernels are logged. ``neuron_step`` is held bit for bit against the
     eager step (``neuron_step_eager``) at B = 32 and at the benchmark
     cells' B = 8192 (N = 1536), under the default and the Table-V neuron
     parameters, with and without an external current, must run one device
     operation a call, and is timed at B = 8192 beside the eager step and
     its bound of 76 bytes a neuron. ``mla_attention`` (which replaces no
     TPU kernel: the MLA prefill's causal attention) is held at
     DeepSeek-V2-Lite's prefill shape (B = 4, S = 4096, H = 16, q and k 192
     wide, v 128, bf16) against float32 ``attend_dense`` on the same inputs
     (allclose(rtol=2**-7, atol=2**-7): bf16 probabilities and output), must
     run one device operation a call, and is timed beside the plain
     ``attention_core`` (``attend_chunked``), its bf16 bound and the library
     yardstick ``scaled_dot_product_attention``, with its registers, spills
     and blocks per SM;
  3. the serving path: the offline-Hebbian calibration run, then a pool of
     32 slots serving 64 poker-DVS sessions (seed 7, 16 events per step)
     once per backend (fused, cuda, reference, and the fabric with its
     kernel and with ``kernel=False``); the queued backends must agree on
     every session, the two fabric legs must agree on every session (link
     drops included), every run must reach accuracy >= 0.95, and each
     delivery kernel must have been launched once per engine step of its
     backend's run, ``neuron_step`` once per engine step of every run; a
     short fabric pool with link capacity 8 holds the kernel leg against
     the plain one where links drop; a small network is held against the
     dense oracle (its neuron step the eager one) on the card; one profiled window of serving
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
  3c. faults and recovery, on the serving phase's readout and sessions,
     each part with the launch counts set to 0 just before it and read just
     after, every count against the JAX package's CPU counts pinned at the
     top of the phase (tests/faults_phase_reference.py): ``fabric_deliver``
     on the healthy and the 25%-dead-link entry tables against its plain
     version (severed entries carry weight 0) with its device time on each;
     the placement repaired around the dead links, and the pool served
     healthy, over the dead links and on the repaired placement, kernel
     and plain legs equal; ring against roll under a dead link, a lossy
     mesh and a stuck cluster; the watchdog's mid-flight migration onto the
     repaired engine (extract and splice timed); a checkpoint at step 5
     under build/chip_smoke/ckpt/, the pool and engine dropped, rebuilt,
     restored and resumed on fused and on the fabric, bit-exact against
     the uninterrupted run (save and restore timed); 64 CAM and 64 SRAM bit
     flips served on cuda and fused, equal to the reference leg;
  3d. multi-model residency, on the serving phase's readout and sessions,
     each serving part with the launch counts set to 0 just before it and
     read just after, every count against the JAX package's CPU counts
     pinned at the top of the phase (tests/multimodel_phase_reference.py):
     a 32-slot pool with two resident Table-V networks (3072 neurons in 12
     clusters) serving the 64 sessions alternating between them, on fused,
     cuda and reference (each session equal to its backend's single-model
     leg) and over the fabric ring with the entry table built slab by slab
     (kernel and plain legs equal; again at link capacity 8); the hot load
     of the second model under 32 live sessions and the unload of the first
     on fused and on the fabric (load_model timed, the first step after it
     on CUDA events, device memory back within 1 MB); the live versioned
     re-placement (ReplacementController, the sessions in flight byte-equal
     to an unswapped control, retarget and drain); a checkpoint of the
     two-model pool at step 5 restored (restore(models=)) and resumed
     bit-exactly on fused and on the fabric, the models' other order
     refused; and the three stage-2 kernels against their plain versions
     on the two residents' combined tables and on Table-V beside a network
     of K = 512, S = 32, E = 8 (padded -1 words, zero tag columns), at 0%,
     10% and 100% activity, with their device time, split and blocks per
     SM at those shapes;
  3e. multi-device, on the serving phase's readout and sessions, each
     serving part with the launch counts set to 0 just before it and read
     just after, every count against the JAX package's CPU counts (8 fake
     devices) pinned at the top of the phase
     (tests/multidevice_phase_reference.py): ShardedSessionPool fleets of
     1, 2 and 4 shards over the fabric, 64 slots in all, oversubscribed on
     the card, every session equal to the one-pool fabric leg; 2 shards of
     32 slots on the slab-retiled tables over 1x1, 1x2 and 2x2 meshes of the
     card named explicitly (``devices=[cuda:0] * k``), fabric ring and
     queued, every mesh equal to the 1x1 fleet, and devices=None refusing a
     2-cell mesh on one card; the 1x1 and 1x2 fleets at link capacity 8;
     cam_match launched once per mesh cell per fleet step and nothing else;
     the control plane (8 sessions migrated from a 1x1 onto a 1x2 shard and
     the 1x1 shard drained; a 4-shard fleet checkpointed under
     build/chip_smoke/fleet_ckpt, restored onto 2 shards, killed at a shard
     and recovered under a FleetWatchdog; the admission refusal); the
     ``sharded`` backend on a 1x2 mesh against the ``cuda`` backend. Each
     fleet is timed loaded: host ms per fleet step, and the device ms of
     one from CUDA events around replays queued behind a spin kernel;
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
     its registers, spills, shared bytes and blocks per SM are logged;
  5. attention and MoE serving, with the launch counts set to 0 just before
     it and read just after (no Pallas kernel lies on this path: repro runs
     attention and the MoE dispatch in plain jnp, the port in plain
     PyTorch, so every count must stay 0). Each model's bfloat16 weights
     are initialised on the card from seed 7 and freed before the next.
     5a: deepseek-moe-16b at full width and depth (28 layers: a dense
     prefix layer and 27 MoE layers of 64 routed experts, top-6, and 2
     shared ones) serves 8 prompts of 512 tokens + 32 greedy tokens through
     ``Engine.generate``; prefill and decode timed and profiled, the decode
     floor (every byte a step must read over 3.35 TB/s), the expert loads
     and the share of assignments dropped at capacity factor 1.25 in
     prefill and decode; one MoE layer's ``moe_local`` at capacity T * k
     against ``moe_reference`` on 512 bfloat16 tokens (within 2^-5 of the
     largest output); at float32, the prefix layer and one MoE layer at a
     capacity factor where nothing drops, prefill + 8 decode steps against
     one full forward (within 1e-4 of the largest logit). 5b: gemma3-1b at
     full width and depth (26 layers, 5:1 local(512):global + 2, qk-norm,
     head_dim 256, MQA, vocab 262144) serves 4 prompts of 4096 tokens + 32,
     timed and profiled; at that shape in float32, ``attend_chunked``
     against ``attend_dense``, global and windowed (allclose(rtol=1e-5,
     atol=2e-5)); at float32 with one period, prefill + 8 decode steps
     against the full forward (1e-4). 5c: gemma2-27b, glm4-9b, yi-34b and
     internvl2-76b cut to one period, whisper-base whole (6 + 6, 1500
     frames), at full width: 2 prompts of 300 tokens + 8, timed, and
     prefill + decode against the full forward within 2^-5 of the largest
     bfloat16 logit;
  6. the LM remainder, with the launch counts set to 0 just before it and
     read just after (no Pallas kernel lies on this path: repro computes
     MLA, the SSD scan and the shared block in plain jnp; the port's bf16
     MLA prefill launches ``mla_attention`` once a layer, a whole multiple
     of 6a's layers, and every other count must stay 0); bfloat16 weights
     from seed 7, each model freed before the next. 6a: deepseek-v3-671b
     at full width (d 7168, MLA with 128 heads, q_lora 1536, kv_lora 512,
     256 routed experts top-8 + 1 shared, aux-free router, vocab 129280,
     MTP built), cut to its 3 dense MLA
     layers + 1 of 58 MoE periods (15.1 B parameters), serves 8 prompts of
     512 tokens + 32 greedy tokens, timed and profiled as 5a, with the MLA
     ring's bytes per token and layer and the dropped share at capacity
     factor 1.25; at float32 on the 3 dense MLA layers alone, prefill + 8
     absorbed decode steps against one full (decompressed) forward (1e-4 of
     the largest logit), and ``Model.loss`` with MTP on 2 x 64 tokens
     finite and equal to the blockwise one (``loss_chunk`` 32, rtol 1e-5).
     6b: zamba2-2.7b whole (54 Mamba2 layers, 9 applications of one shared
     attention block) serves 8 x 512 + 32, timed and profiled; the shared
     block's parameters counted once and the build's device memory within
     1% of their bytes; at float32 with one period, prefill + 8 decode steps
     against the full forward (1e-4); one float32 Mamba2 layer at full
     width, B = 8 x 512: the chunked core against the sequential one, and a
     prefill of 384 + 128 decode steps against the full layer (1e-4);
  7. training, with the launch counts set to 0 just before it and read just
     after (no Pallas kernel lies on the training path: repro trains RWKV-6
     on its plain chunked core, so every count must stay 0). 7a: gemma3-1b
     whole (1.0 B parameters, bf16, float32 moments) through
     ``launch/train.run``, 8 x 512, 6 steps, a checkpoint every 3 (10 GB
     each; the disk checked first, the folder under build/ deleted after),
     a failure injected at step 4: the supervisor reports it, resumes from
     step 3 and completes; then the step timed by part with CUDA events
     (forward, backward with remat's recompute, optimizer), tokens/s, peak
     memory, the model-FLOP share of 989 TFLOP/s (6 N T + attention), one
     step profiled, and one checkpoint's host copy and write. 7b: gemma3-1b
     cut to one period, float32, 2 x 64: one step on the card against the
     CPU (loss rel 1e-5, gradient norm rel 1e-4, every gradient leaf
     allclose(1e-4, 1e-5 * its max |g|), the elements past 1e-6 counted).
     7c: deepseek-moe-16b cut to its dense prefix layer + one MoE layer
     (1.09 B), bf16, q8 moments, 2 microbatches, 3 steps of 8 x 512: step
     ms, tokens/s, peak memory, the dropped share, and the loss equal to
     cross-entropy + the switch load term. 7d: one float32 step of every
     arch's smoke config on the card against the CPU (loss rel 1e-5, norm
     rel 1e-4; deepseek-v3's router_bias moves by +-u or 0 per period, as on
     the CPU). 7e: ``rwkv6_chunk`` refuses CUDA inputs that require grad;
  8. expert parallel, with the launch counts set to 0 just before it and
     read just after (no Pallas kernel lies on this path: repro computes the
     sharded MoE and the collectives in plain jnp, so every count must stay
     0), over meshes whose cells are all ``cuda:0``. 8a: one
     deepseek-v3-671b MoE layer at full width (256 experts, top-8, bf16,
     22.5 GB of experts), EP over the (2, 4) ("data", "model") mesh, 32
     experts per cell: at capacity factor ceil(E / k) (no drops)
     ``moe_block_sharded`` against ``moe_local`` in prefill layout (2 x 512)
     and decode layout (8 x 1), y within 2^-5 of the largest output and the
     loads equal, with the buffers' bytes reckoned first; both timed at
     8 x 512 and 8 x 1 under the config's capacity factor, with their
     dropped shares. 8b: deepseek-moe-16b whole, built with
     ``moe_impl="sharded"`` on the (2, 4) mesh, serves 8 x 512 + 32; prefill
     and decode timed sharded and, on the same weights, local, with the
     dropped shares; its float32 cut (the prefix layer + one MoE layer,
     capacity factor ceil(E / k)): sharded prefill + 8 decode steps against
     its full forward and the sharded full forward against the local one
     (1e-4 of the largest logit), one train step of 2 x 512 (loss rel 1e-5,
     gradient norm rel 1e-4 against local). 8c: ``remesh_pspecs`` for the
     ten full configs (meta-device shapes) on (2, 16, 16) and (16, 16)
     meshes, every spec checked against its shape, the sharded leaves
     counted; ``reshard_state`` of gemma3-1b's whole train state onto the
     (2, 4) mesh from the card and from host memory, timed, every value
     bit-equal. 8d: ``hierarchical_all_reduce`` against ``flat_all_reduce``
     over a (2, 4) ("pod", "data") mesh, 64 MB of float32 per cell: the
     largest difference (1e-6 of the largest sum) and the ms of each.
  9. the dry run (``launch/dryrun.py``), with the launch counts set to 0
     just before it and read just after (its only kernel is
     ``rwkv6_chunk``, 256 per rwkv6-3b prefill of 9a). 9a: one step counted
     by ``launch.costs.CostCounter`` on ``cuda:0`` and on the meta device
     must give equal FLOPs by dtype, bytes by class and collective bytes by
     kind: gemma3-1b whole, a float32-moment train step at 8 x 512;
     rwkv6-3b whole, an 8 x 512 prefill on the kernel (its reckoning
     counted); deepseek-moe-16b whole with ``moe_impl="sharded"`` on the
     (2, 4) mesh of ``cuda:0``, an 8 x 512 prefill. Each step is then timed
     without the counter (CUDA events, and the host clock after
     synchronize), beside the dry run's bound (the larger of its compute
     and memory seconds at the H100 data-sheet peaks) and the card's name
     and power limit. 9b: gemma3-1b's one-cell train state: the reckoned
     argument bytes equal the card's tensors and the growth of the
     allocator's requested bytes; the temp estimate against
     ``max_memory_allocated()`` over the step, as a ratio. 9c: the meta dry
     run of every arch's decode_32k on (16, 16) and of gemma3-1b's and
     deepseek-v3-671b's train_4k on (2, 16, 16), a line per cell;
     ``build/chip_smoke/chip_smoke_dryrun.json``.

Prints a ``{"kernels": [...]}`` JSON line (``launches`` from the serving
and LM paths, for ``mla_attention`` phase 6a's bf16 deepseek-v3,
``launches_compiler_phase`` from phase 3b, ``launches_faults_phase`` from
phase 3c, ``launches_multimodel_phase`` from phase 3d,
``launches_multidevice_phase`` from phase 3e,
``launches_attention_moe_phase`` from phase 5 (0),
``launches_lm_remainder_phase`` from phase 6 (``mla_attention`` only),
``launches_train_phase`` from phase 7 (0),
``launches_expert_parallel_phase`` from phase 8 (0),
``launches_dryrun_phase`` from phase 9 (``rwkv6_chunk`` only),
``device_ms_two_table_v`` / ``device_ms_table_v_plus_k512`` from phase 3d's
part 6), then as the last line
``{"ok": true, "device": {...}}``. TF32 is off throughout (the plain stage 2
contracts a one-hot with a float32 matmul). Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
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

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, Shape, get_config  # noqa: E402
from repro_torch.core.cnn import compile_poker_cnn, poker_neuron_params  # noqa: E402
from repro_torch.core.compiler import (  # noqa: E402
    CompiledArtifact,
    Geometry,
    compile_network_v2,
    optimize_placement,
    repair_placement,
    retarget,
)
from repro_torch.core.dispatch import FabricBackend, get_backend  # noqa: E402
from repro_torch.core.event_engine import (  # noqa: E402
    EventEngine,
    ShardedEventEngine,
    dense_reference_step,
    dense_weights_from_tables,
)
from repro_torch.core.faults import FaultSpec, apply_table_faults, fault_blast_radius  # noqa: E402
from repro_torch.core import neuron as neuron_mod  # noqa: E402
from repro_torch.core.neuron import NeuronParams, NeuronState, neuron_step_eager  # noqa: E402
from repro_torch.core.routing import ChipConstants, Fabric  # noqa: E402
from repro_torch.core.tags import NetworkSpec, compile_network, concat_tables  # noqa: E402
from repro_torch.core.tracing import device_ops  # noqa: E402
from repro_torch.core.two_stage import (  # noqa: E402
    compact_events,
    stage2_cam_match,
    two_stage_deliver,
)
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig,
    DvsStreamConfig,
    DvsStreamSource,
    make_source,
)
from repro_torch.distributed import collectives as ep_coll  # noqa: E402
from repro_torch.distributed.elastic import remesh_pspecs, reshard_state  # noqa: E402
from repro_torch.distributed.mesh import NamedSharding, make_mesh, tree_map  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cam_match import ops as cam_ops  # noqa: E402
from repro_torch.kernels.cam_match.ref import cam_counts  # noqa: E402
from repro_torch.kernels.fabric_deliver import ops as fabric_ops  # noqa: E402
from repro_torch.kernels.fused_deliver import ops as fused_ops  # noqa: E402
from repro_torch.kernels.mla_attention import ops as mla_ops  # noqa: E402
from repro_torch.kernels.neuron_step import ops as neuron_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as rwkv_ops  # noqa: E402
from repro_torch.models import attention as attn_ops  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import moe as moe_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402
from repro_torch.models import ssm as ssm_ops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.aer import (  # noqa: E402
    AerServeConfig,
    AerSessionPool,
    CheckpointMismatchError,
    DvsSession,
    build_poker_engine,
    tune_poker_readout,
)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.health import (  # noqa: E402
    FleetWatchdog,
    ReplacementController,
    Watchdog,
    WatchdogConfig,
    migrate_pool,
    serve_resilient,
)
from repro_torch.serve.sharded import (  # noqa: E402
    AdmissionError,
    ShardConfig,
    ShardedSessionPool,
    build_poker_shard_engine,
    retile_for_slabs,
)
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
NEURON_OPS = 50  # float32 operations of one neuron's step (perfbench/reference/counts_step.py)
CELL_BATCH = 8192  # the benchmark cells' streams (perfbench/workloads/)
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
    for evt in device_ops(prof.events()):
        if kernel_name is None or kernel_name in evt.name:
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
    out["neuron_step"] = neuron_kernel_entry(dev, t.n_neurons, gen)
    out["rwkv6_chunk"] = rwkv_kernel_entry(dev)
    out["mla_attention"] = mla_kernel_entry(dev)
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
        ops = [e.name for e in device_ops(prof.events())]
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


def _neuron_case(dev, gen, b: int, n: int, with_ext: bool):
    """A state, a drive and maybe an external current at ``[b, n]`` that
    reach every branch of the step: one neuron in eight far below threshold
    (the exponent clamped at -20), one far above it (clamped at 20), one at
    ``v_peak``, one with exactly 1 ms of refractory time left; about a third
    refractory; shunting currents up to 20; integer event drives (8.0 an
    event) mixed with arbitrary floats."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    kind = torch.randint(0, 8, (b, n), generator=gen, device=dev)
    v = u(-0.08, 0.005, b, n)
    v = torch.where(kind == 0, u(-0.5, -0.2, b, n), v)
    v = torch.where(kind == 1, u(0.05, 0.3, b, n), v)
    v = torch.where(kind == 2, torch.zeros_like(v), v)
    refrac = torch.where(torch.rand((b, n), generator=gen, device=dev) < 0.3,
                         u(0.0, 3e-3, b, n), torch.zeros_like(v))
    refrac = torch.where(kind == 3, torch.full_like(v, 1e-3), refrac)
    i_syn = u(0.0, 2.0, b, n, 4)
    i_syn[..., 3] *= 10.0
    drive = torch.randint(0, 5, (b, n, 4), generator=gen, device=dev).float() * 8.0
    drive = torch.where(torch.rand((b, n, 4), generator=gen, device=dev) < 0.5,
                        u(0.0, 40.0, b, n, 4), drive)
    state = NeuronState(v=v, w=u(0.0, 0.05, b, n), refrac=refrac, i_syn=i_syn)
    i_ext = torch.randn((b, n), generator=gen, device=dev) * 2.0 if with_ext else None
    return state, drive, i_ext


def neuron_kernel_entry(dev, n: int, gen) -> dict:
    """``neuron_step`` at the serving pool's shape (B = 32) and the
    benchmark cells' (B = 8192), N = 1536, under the default and the
    Table-V neuron parameters, with and without an external current: the
    wrapper on card tensors equal to ``neuron_step_eager`` bit for bit
    (state, spikes), spiking and refractory neurons present; one call one
    device operation; timed at the cells' shape beside the eager step. Its
    bound is one read and one write of the state, one read of the drive and
    one write of the spikes: 76 bytes a neuron."""
    cases = {}
    for shape_name, b in (("pool", POOL), ("cells", CELL_BATCH)):
        for p_name, params in (("default", NeuronParams()), ("table_v", poker_neuron_params())):
            for with_ext in (False, True):
                state, drive, i_ext = _neuron_case(dev, gen, b, n, with_ext)
                decay, ws = neuron_mod._synapse_constants(params, torch.float32, dev)
                got = neuron_ops.neuron_step(state.v, state.w, state.refrac, state.i_syn, drive,
                                             i_ext, decay, ws, params)
                torch.cuda.synchronize()
                e_state, e_spikes = neuron_step_eager(state, drive, params, i_ext)
                want = (e_state.v, e_state.w, e_state.refrac, e_state.i_syn, e_spikes)
                name = f"{shape_name} B = {b}, {p_name} parameters" + (", i_ext" if with_ext else "")
                for leaf, x, y in zip(("v", "w", "refrac", "i_syn", "spikes"), got, want):
                    if x.shape != y.shape or not torch.equal(x, y):
                        raise AssertionError(f"neuron_step {name}: {leaf} differs from the eager "
                                             f"step in {int((x != y).sum())} of {y.numel()}")
                spiked, refractory = int(got[4].sum()), int((state.refrac > 0).sum())
                if not (0 < spiked < b * n and refractory > 0):
                    raise AssertionError(f"neuron_step {name}: {spiked} spikes, {refractory} "
                                         "refractory neurons; the case misses a branch")
                cases[name] = {"spikes": spiked, "refractory": refractory}
    params = poker_neuron_params()
    state, drive, _ = _neuron_case(dev, gen, CELL_BATCH, n, False)
    decay, ws = neuron_mod._synapse_constants(params, torch.float32, dev)
    args = (state.v, state.w, state.refrac, state.i_syn, drive, None, decay, ws, params)
    call = lambda: neuron_ops.neuron_step(*args)  # noqa: E731
    ops = _device_ops_per_call(call)
    if len(ops) != 1 or "neuron_step_kernel" not in ops[0]:
        raise AssertionError(f"one neuron_step call ran {len(ops)} device operations: {ops}")
    info = neuron_ops.kernel_info()
    n_bytes = _nbytes(*args[:5], *call())
    if n_bytes != 76 * CELL_BATCH * n:
        raise AssertionError(f"neuron_step moves {n_bytes} bytes, not 76 a neuron")
    bound_ms, bound_by = _bound(n_bytes, NEURON_OPS * CELL_BATCH * n)
    entry = {
        "name": "neuron_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/neuron_step/csrc/neuron_step.cu",
        "replaces": "src/repro/core/neuron.py:78",
        "max_abs_err": 0.0,  # every case above equal bit for bit
        "ms": time_ms(call),
        "plain_ms": time_ms(lambda: neuron_step_eager(state, drive, params)),
        "device_ms": device_ms(call, "neuron_step_kernel"),
        "device_ops_per_call": len(ops),
        "cases": cases,
        **{f"kernel_{key}": v for key, v in info.items()},
        "bytes": n_bytes,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # the eager step (plain_ms) is some forty PyTorch calls
        "shape": f"v, w, refrac [{CELL_BATCH},{n}] f32, i_syn, drive [{CELL_BATCH},{n},4] f32",
    }
    log(f"neuron_step: {info['registers']} registers, {info['local_bytes']} local (spill) bytes "
        f"per thread, {info['blocks_per_sm']} blocks per SM; bit for bit the eager step in "
        f"{len(cases)} cases ({', '.join(cases)})")
    log(f"neuron_step at B = {CELL_BATCH}, N = {n}: {entry['ms'] * 1e3:.2f} us/call (kernel on "
        f"the device {entry['device_ms']} ms, {bound_ms / entry['device_ms']:.1%} of its bound), "
        f"eager {entry['plain_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us ({bound_by}; "
        f"{n_bytes} bytes)")
    return entry


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


MLA_B, MLA_S, MLA_H = 4, 4096, 16  # DeepSeek-V2-Lite's prefill cell: prompts, tokens, heads
MLA_TOL = 2.0**-7  # bf16 output and probabilities against float32 (tests/test_torch_cuda.py)


def mla_kernel_entry(dev: torch.device) -> dict:
    """``mla_attention`` at DeepSeek-V2-Lite's prefill cell (B = 4, S =
    4096, H = 16; q, k 192 wide, v 128, bf16; positions 0..S-1 in stride-0
    rows, as the model passes them; the model's scale with YaRN's mscale
    squared) against float32 ``attend_dense`` on the same inputs, within
    allclose(rtol=2**-7, atol=2**-7); one call one device operation; timed
    beside the plain ``attention_core`` the model runs elsewhere (blocks of
    1024 through ``attend_chunked``, float32 inside), its bound (the causal
    pairs' operations at the bf16 tensor-core peak, or q, k, v and o once at
    HBM speed) and ``scaled_dot_product_attention`` on [B, H, S, D] copies,
    the library yardstick (the port never calls it)."""
    cfg = get_config("deepseek-v2-lite")
    dqk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    m = lm_layers.yarn_mscale(cfg.yarn.factor, cfg.yarn.mscale_all_dim)
    scale = dqk**-0.5 * m * m
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k = (torch.randn((MLA_B, MLA_S, MLA_H, dqk), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((MLA_B, MLA_S, MLA_H, dv), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(MLA_S, device=dev).expand(MLA_B, MLA_S)
    call = lambda: mla_ops.mla_attention(q, k, v, pos, scale)  # noqa: E731
    got = call()
    with torch.inference_mode():
        want = attn_ops.attend_dense(q.float(), k.float(), v.float(), pos, pos, causal=True,
                                     scale=scale)
    err = float((got.float() - want).abs().max())
    if not torch.allclose(got.float(), want, rtol=MLA_TOL, atol=MLA_TOL):
        raise AssertionError(f"mla_attention: max_abs_err {err} against float32 attend_dense")
    del want
    _free()
    ops = _device_ops_per_call(call)
    if len(ops) != 1 or "mla_attention_kernel" not in ops[0]:
        raise AssertionError(f"one mla_attention call ran {len(ops)} device operations: {ops}")
    info = mla_ops.kernel_info()
    pairs = MLA_B * MLA_S * (MLA_S + 1) // 2
    flops = 2 * MLA_H * pairs * (dqk + dv)
    n_bytes = _nbytes(q, k, v, got)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_PEAK_FLOPS * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    plain = lambda: attn_ops.attention_core(  # noqa: E731
        q, k, v, pos, pos, causal=True, window=None, scale=scale, softcap=None)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qh, kh, vh, is_causal=True, scale=scale)
    entry = {
        "name": "mla_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mla_attention/csrc/mla_attention.cu",
        "replaces": "none: repro's MLA prefill runs attend_chunked as jnp under jit "
                    "(src/repro/models/attention.py:101)",
        "max_abs_err": err,
        "ms": time_ms(call, repeats=20, inner=10),
        "plain_ms": time_ms(plain, repeats=3, inner=1),
        "device_ms": device_ms(call, "mla_attention_kernel", calls=20),
        "device_ops_per_call": len(ops),
        **{f"kernel_{key}": x for key, x in info.items()},
        "bytes": n_bytes,
        "flops": flops,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": time_ms(sdpa, repeats=20, inner=10),
        "library_device_ms": device_ms(sdpa, None, calls=20),
        "shape": f"q, k [{MLA_B},{MLA_S},{MLA_H},{dqk}] bf16, v [{MLA_B},{MLA_S},{MLA_H},{dv}] "
                 f"bf16, positions [{MLA_B},{MLA_S}] int64",
    }
    log(f"mla_attention: {info['registers']} registers, {info['local_bytes']} local (spill) bytes "
        f"per thread, {info['shared_bytes']} shared bytes and {info['blocks_per_sm']} blocks per SM")
    log(f"mla_attention at B = {MLA_B}, S = {MLA_S}, H = {MLA_H}: within allclose(rtol={MLA_TOL}, "
        f"atol={MLA_TOL}) of float32 attend_dense, max_abs_err {err:.3g}; {entry['ms']:.4f} ms/call "
        f"(kernel on the device {entry['device_ms']} ms, {bound_ms / entry['device_ms']:.1%} of its "
        f"bound), plain attention_core {entry['plain_ms']:.2f} ms, scaled_dot_product_attention "
        f"{entry['library_ms']:.4f} ms (device {entry['library_device_ms']}), bound "
        f"{bound_ms:.4f} ms ({bound_by}; {flops} flops, {n_bytes} bytes)")
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


def _key(results) -> list:
    """Each session's result, by session id: (id, prediction, decided,
    decision step, counts, drops, link drops, error)."""
    return [(r.session_id, r.prediction, r.decided, r.latency_steps, r.counts.tolist(),
             r.dropped, r.link_dropped, r.error)
            for r in sorted(results, key=lambda r: r.session_id)]


KERNEL_WRAPPERS = {
    "cam_match": cam_ops.cam_match,
    "fused_deliver": fused_ops.fused_deliver,
    "fabric_deliver": fabric_ops.fabric_deliver,
    "rwkv6_chunk": rwkv_ops.rwkv6_chunk,
    "neuron_step": neuron_ops.neuron_step,
    "mla_attention": mla_ops.mla_attention,
}
# serving legs: (label, backend, fabric_options, the delivery kernel it must
# launch once per step; every leg launches neuron_step once per step too)
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


def _steps(n: int, kernel: str | None = None) -> dict[str, int]:
    """The launches of ``n`` engine steps (mesh cell steps on a sharded
    engine): the neuron step once each, and the backend's delivery
    ``kernel`` (None on a plain leg) once each."""
    return {"neuron_step": n, **({kernel: n} if kernel else {})}


def check_dense_oracle(dev: torch.device) -> None:
    """A small random network on the card: the kernel backends' spikes and
    state equal the dense oracle's (dense delivery, the eager neuron step),
    step by step."""
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


def profile_serving(pool: AerSessionPool, suits, sessions=None) -> dict:
    """Where a loaded pool's step goes: 20 steps timed part by part on the
    host clock (input building, engine launch, wait for the device, readout
    bookkeeping), then 20 steps under torch.profiler for the device-busy
    time by kernel. The pool is filled from ``sessions`` (default: the
    serving phase's)."""
    from torch.profiler import ProfilerActivity, profile

    for sess in (sessions or _sessions(suits))[:POOL]:
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
    for evt in device_ops(prof.events()):
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
    ``expect_kernel`` and one of ``neuron_step`` per engine step (and none
    of the others)."""
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
    want = {name: _steps(pool.n_steps, expect_kernel).get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{backend} {fabric_options}: launches {counts}, expected {want}")
    if not all(torch.isfinite(x).all() for x in (pool.carry[0].v, pool.carry[0].i_syn)):
        raise AssertionError(f"{backend}: non-finite neuron state after serving")
    by_id = sorted(results, key=lambda r: r.session_id)
    lat = np.array([r.latency_steps for r in by_id], dtype=np.float64)
    return {
        "results": _key(results),
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
    launches["neuron_step"] = 0
    for label, backend, options, kernel in LEGS:
        r = runs[label] = _serve_leg(cc, dev, backend, options, suits, kernel)
        if kernel is not None:
            launches[kernel] = r["launches"][kernel]
        launches["neuron_step"] += r["launches"]["neuron_step"]
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
          "results": {k: runs[k]["results"] for k in ("fused", "cuda", "reference", "fabric")}}
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
COMPILER_PATH_KERNELS = ("cam_match", "fused_deliver", "fabric_deliver", "neuron_step")


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
        want = _steps(LOOP_STEPS, "fabric_deliver" if kernel else None)
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
    _expect_launches(counts, _steps(1, "fabric_deliver" if kernel else None), "shuffle step")
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
            o_state, o_spikes = neuron_step_eager(o_state, drive, eng.params)
            if int(stats.link_dropped.sum()) != 0 or not torch.equal(got, o_spikes):
                raise AssertionError(f"2x2 artifact: spikes differ from the dense oracle at "
                                     f"step {step}")
            torch.testing.assert_close(carry[0].v, o_state.v, rtol=1e-5, atol=1e-7)
            history = [o_spikes] + history[:-1]
            total_spikes += int(got.sum())

    _, counts = _counted(run)
    _expect_launches(counts, _steps(steps, "fabric_deliver"), "2x2 artifact")
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
# phase 3c: faults and recovery
# ---------------------------------------------------------------------------
# What the JAX package gives for this phase's workloads on the CPU (printed
# by tests/faults_phase_reference.py; the port must reproduce them on the
# card), on the serving phase's Hebbian readout, suits and sessions (32
# slots, 64 sessions of seed 7, 16 events per step, the default 3x3 fabric):
# the repair of the placement around tests/test_faults.py's 25% dead links,
# and the pool served healthy, over the dead links and on the repaired
# placement; one fault of each class, a full pool of the first 32 sessions
# stepped 20 times; the watchdog's mid-flight migration; 64 + 64 bit flips.
DEAD25 = ((0, 1), (1, 0), (0, 3), (3, 0), (1, 2), (2, 1))
FAULT_CLASSES = {
    "dead_link": {"dead_links": ((0, 1),)},
    "lossy": {"link_drop_rate": 0.05, "seed": 3},
    "stuck_cluster": {"stuck_clusters": (0,)},
}
CLASS_STEPS = 20
MEMORY_FAULTS = {"cam_bit_flips": 64, "sram_bit_flips": 64, "seed": 11}
REPAIRED_PLACEMENT = [5, 7, 8, 5, 7, 3]
STATE_COUNTS = {  # accuracy, link drops, engine steps
    "healthy": (1.0, 0, 43),
    "dead25": (0.21875, 40126, 120),
    "repaired": (1.0, 0, 45),
}
CLASS_COUNTS = {  # link drops, delivered events, spikes
    "dead_link": (5599, 0, 5954),
    "lossy": (262, 6052, 7220),
    "stuck_cluster": (900, 5382, 6712),
}
MIGRATION = {"results": 64, "accuracy": 1.0, "link_dropped": 42,
             "events": ["pool-degraded"], "degraded_step": 4}
BLAST_RADIUS = {"connections_before": 24576, "connections_lost": 1075,
                "connections_gained": 1453, "connections_kept": 23501}
MEMORY_COUNTS = {"accuracy": 0.984375, "latency_steps": 1183, "engine_steps": 41}
KILL_AT = 5
FAULTS_PATH_KERNELS = ("cam_match", "fused_deliver", "fabric_deliver", "neuron_step")


def _with_placement(cc, placement):
    return dataclasses.replace(cc, tables=dataclasses.replace(cc.tables,
                                                              tile_of_cluster=placement))


def _faulted_engine(tables, dev, faults, kernel=True, ring=True):
    return build_poker_engine(tables, backend="fabric", device=dev, faults=faults,
                              fabric_options={"kernel": kernel, "ring": ring})


def check_repair_states(dev, v1, launched) -> dict:
    """Healthy -> 25% dead links -> repaired: the placement, and per state
    a pool on the ring path with ``fabric_deliver`` (kernel leg) and with
    ``kernel=False``: equal session for session, and the JAX package's
    accuracy, link drops and engine steps."""
    cc, suits = v1["cc"], v1["suits"]
    fs = FaultSpec(dead_links=DEAD25)
    placement, report = repair_placement(cc.tables, Fabric(), fs, seed=0)
    if placement.tolist() != REPAIRED_PLACEMENT or not report["feasible"]:
        raise AssertionError(f"repair_placement gave {placement.tolist()} "
                             f"(feasible {report['feasible']}), expected {REPAIRED_PLACEMENT}")
    states = {"healthy": (cc, None), "dead25": (cc, fs),
              "repaired": (_with_placement(cc, placement), fs)}
    out = {"placement": placement.tolist(), "feasible": report["feasible"],
           "moved_clusters": report["moved_clusters"]}
    for name, (cc_s, faults) in states.items():
        legs = {}
        for kernel in (True, False):
            eng = _faulted_engine(cc_s.tables, dev, faults, kernel)
            legs[kernel] = _serve_leg(cc_s, dev, "fabric", None, suits,
                                      "fabric_deliver" if kernel else None, engine=eng)
        launched.update(legs[True]["launches"])
        if legs[True]["results"] != legs[False]["results"]:
            raise AssertionError(f"{name}: fabric kernel and plain legs differ")
        r = legs[True]
        got = (r["accuracy"], r["link_dropped"], r["engine_steps"])
        if got != STATE_COUNTS[name]:
            raise AssertionError(f"{name}: accuracy, link drops, steps {got}, the JAX "
                                 f"package's {STATE_COUNTS[name]}")
        d1 = eng.fabric_model.max_delay + 1
        out[name] = {"ring_slots": d1, "wall_ms_per_step": r["wall_s"] * 1e3 / r["engine_steps"],
                     **{k: r[k] for k in ("accuracy", "link_dropped", "engine_steps",
                                          "latency_p50_steps", "sessions_per_s", "launches")}}
        log(f"faults[{name}]: accuracy {r['accuracy']}, {r['link_dropped']} link drops, "
            f"{r['engine_steps']} steps ({out[name]['wall_ms_per_step']:.3f} ms/step wall), "
            f"ring of {d1} slots; kernel and plain legs equal, the JAX package's counts")
    log(f"faults: repair_placement around 25% dead links -> {placement.tolist()} "
        f"(moved clusters {report['moved_clusters']}), feasible")
    return out


def _class_counts(cc, suits, eng) -> tuple[int, int, int]:
    pool = AerSessionPool(cc, eng, AerServeConfig(pool_size=POOL))
    for s in _sessions(suits)[:POOL]:
        pool.admit(s)
    link_dropped = delivered = spikes = 0
    for _ in range(CLASS_STEPS):
        out = pool.step()
        st = pool.last_stats
        link_dropped += int(st.link_dropped.sum())
        delivered += int(st.delivered.sum())
        spikes += int(out.sum())
    return link_dropped, delivered, spikes


def check_fault_classes(dev, v1, launched) -> dict:
    """Ring against roll under a dead link, a lossy mesh and a stuck cluster
    on the Table-V fabric at the pool's batch: equal link drops, delivered
    events and spikes, the JAX package's, with ``fabric_deliver`` launched
    once per ring step."""
    cc, suits = v1["cc"], v1["suits"]
    out = {}
    for name, kw in FAULT_CLASSES.items():
        fs = FaultSpec(**kw)
        got = {}
        for ring in (True, False):
            eng = _faulted_engine(cc.tables, dev, fs, ring=ring)
            got[ring], counts = _counted(lambda: _class_counts(cc, suits, eng))
            _expect_launches(counts, _steps(CLASS_STEPS, "fabric_deliver" if ring else None),
                             f"fault class {name}, ring={ring}")
            launched.update(counts)
        if not got[True] == got[False] == CLASS_COUNTS[name]:
            raise AssertionError(f"{name}: ring {got[True]}, roll {got[False]}, the JAX "
                                 f"package's {CLASS_COUNTS[name]}")
        out[name] = dict(zip(("link_dropped", "delivered", "spikes"), got[True]))
        log(f"faults[{name}]: ring and roll equal over {CLASS_STEPS} steps of {POOL} slots: "
            f"{got[True][0]} link drops, {got[True][1]} delivered, {got[True][2]} spikes")
    return out


def check_migration(dev, v1, launched) -> dict:
    """The watchdog on the 25%-dead-link pool: one ``pool-degraded``, the
    repair, and the 32 live sessions moved mid-flight (extract, splice)
    onto the repaired engine; all 64 results, the JAX package's accuracy."""
    cc, suits = v1["cc"], v1["suits"]
    fs = FaultSpec(dead_links=DEAD25)
    pool = AerSessionPool(cc, _faulted_engine(cc.tables, dev, fs), AerServeConfig(pool_size=POOL))
    timing, pools = {}, []

    def on_degraded(old, ev):
        placement, _ = repair_placement(cc.tables, Fabric(), fs, seed=0)
        eng_r = _faulted_engine(_with_placement(cc, placement).tables, dev, fs)
        occ = old.occupied
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = old.engine.extract_slots(old.carry, occ)
        t1 = time.perf_counter()
        eng_r.splice_slots(eng_r.init_state(batch=POOL), occ, sc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        new = migrate_pool(old, eng_r)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        timing.update(extract_ms=(t1 - t0) * 1e3, splice_ms=(t2 - t1) * 1e3,
                      migrate_pool_ms=(t3 - t2) * 1e3, sessions_moved=len(occ),
                      at_step=old.n_steps, drop_rate=ev.value)
        pools.append(new)
        return new

    wd = Watchdog(WatchdogConfig(window=4, link_drop_threshold=0.2, silence_steps=30))
    (results, events), counts = _counted(lambda: serve_resilient(
        pool, _sessions(suits), watchdog=wd, on_degraded=on_degraded))
    if len(pools) != 1:
        raise AssertionError(f"migration: {len(pools)} migrations, expected 1")
    steps = pools[0].n_steps
    _expect_launches(counts, _steps(steps, "fabric_deliver"), "migration")
    launched.update(counts)
    degraded = [e for e in events if e.kind == "pool-degraded"]
    got = {"results": len(results), "accuracy": float(np.mean([r.correct for r in results])),
           "link_dropped": int(sum(r.link_dropped for r in results)),
           "events": [e.kind for e in events], "degraded_step": degraded[0].step}
    if got != MIGRATION:
        raise AssertionError(f"migration: {got}, the JAX package's {MIGRATION}")
    log(f"faults[migration]: pool-degraded at step {timing['at_step']} (drop rate "
        f"{timing['drop_rate']:.3f}), {timing['sessions_moved']} sessions moved: extract "
        f"{timing['extract_ms']:.3f} ms, splice {timing['splice_ms']:.3f} ms, migrate_pool "
        f"{timing['migrate_pool_ms']:.3f} ms; {len(results)} results, accuracy "
        f"{got['accuracy']}, {steps} steps, fabric_deliver launched {counts['fabric_deliver']}")
    return {**got, **timing, "engine_steps": steps, "launches": counts}


def _serve_killed(cc, make_engine, suits, ckpt_dir: Path) -> tuple[list, dict]:
    """Serve the 64 sessions; at engine step ``KILL_AT`` checkpoint, drop
    the pool and its engine, rebuild both and restore, then serve on."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck = Checkpointer(str(ckpt_dir))
    cfg = AerServeConfig(pool_size=POOL)
    pool = AerSessionPool(cc, make_engine(), cfg)
    pending = collections.deque(_sessions(suits))
    results, timing = [], {}
    while pending or pool.occupied:
        while pending and pool.free_slots:
            pool.admit(pending.popleft())
        pool.step()
        if pool.n_steps == KILL_AT and not timing:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.checkpoint(ck, blocking=True)
            t1 = time.perf_counter()
            del pool
            engine = make_engine()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pool = AerSessionPool.restore(cc, engine, cfg, ck)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            timing = {"save_ms": (t1 - t0) * 1e3, "restore_ms": (t3 - t2) * 1e3,
                      "checkpoint_bytes": sum(p.stat().st_size
                                              for p in (ckpt_dir / f"step_{KILL_AT}").iterdir())}
            if pool.n_steps != KILL_AT or len(pool.occupied) != POOL:
                raise AssertionError("restored pool lost its step count or sessions")
        finished = pool.finished_slots()
        if finished:
            results.extend(pool.evict_many(finished))
    timing["engine_steps"] = pool.n_steps
    return results, timing


def check_kill_restore(dev, v1, launched) -> dict:
    """Checkpoint at step 5, kill, rebuild, restore and resume, on ``fused``
    and on ``fabric``: every session equals the serving phase's
    uninterrupted run (prediction, decided, decision step, counts, drops)."""
    cc, suits = v1["cc"], v1["suits"]
    out = {}
    for label, kernel in (("fused", "fused_deliver"), ("fabric", "fabric_deliver")):
        def make_engine(label=label):
            return build_poker_engine(cc.tables, backend=label, device=dev)
        (results, timing), counts = _counted(
            lambda: _serve_killed(cc, make_engine, suits, OUT_DIR / "ckpt" / label))
        _expect_launches(counts, _steps(timing["engine_steps"], kernel), f"kill-restore {label}")
        launched.update(counts)
        got = _key(results)
        if got != v1["results"][label]:
            raise AssertionError(f"kill-restore on {label}: sessions differ from the "
                                 "uninterrupted run")
        out[label] = {**timing, "launches": counts}
        log(f"faults[kill-restore {label}]: checkpoint at step {KILL_AT} "
            f"({timing['checkpoint_bytes']} bytes) in {timing['save_ms']:.3f} ms, restore "
            f"{timing['restore_ms']:.3f} ms; {len(got)} sessions equal the uninterrupted run, "
            f"{kernel} launched {counts[kernel]} times in {timing['engine_steps']} steps")
    return out


def check_memory_faults(dev, v1, launched) -> dict:
    """64 CAM and 64 SRAM bit flips on the Table-V tables: the JAX
    package's blast radius; the corrupted tables serve the 64 sessions on
    ``cuda`` and ``fused`` equal to the ``reference`` leg session for
    session, with the JAX package's accuracy and decision steps."""
    cc, suits = v1["cc"], v1["suits"]
    corrupted, flips = apply_table_faults(cc.tables, FaultSpec(**MEMORY_FAULTS))
    radius = fault_blast_radius(cc.tables, corrupted)
    if {k: radius[k] for k in BLAST_RADIUS} != BLAST_RADIUS or len(flips) != 128:
        raise AssertionError(f"blast radius {radius}, the JAX package's {BLAST_RADIUS}")
    cc_c = dataclasses.replace(cc, tables=corrupted)
    legs = {label: _serve_leg(cc_c, dev, label, None, suits, kernel)
            for label, kernel in (("reference", None), ("cuda", "cam_match"),
                                  ("fused", "fused_deliver"))}
    for label in ("cuda", "fused"):
        launched.update(legs[label]["launches"])
        if legs[label]["results"] != legs["reference"]["results"]:
            raise AssertionError(f"corrupted tables: {label} differs from the reference leg")
    r = legs["reference"]
    got = {"accuracy": r["accuracy"], "engine_steps": r["engine_steps"],
           "latency_steps": int(sum(x[3] for x in r["results"]))}
    if got != MEMORY_COUNTS:
        raise AssertionError(f"corrupted tables: {got}, the JAX package's {MEMORY_COUNTS}")
    log(f"faults[memory]: {len(flips)} bit flips, blast fraction {radius['blast_fraction']:.4f} "
        f"({radius['connections_lost']} lost, {radius['connections_gained']} gained); "
        f"cuda and fused equal the reference leg, accuracy {r['accuracy']}")
    return {"blast_radius": radius, **got,
            "launches": {k: legs[k]["launches"] for k in ("cuda", "fused")}}


def check_faulted_kernel(dev, v1) -> dict:
    """``fabric_deliver`` on the healthy and the 25%-dead-link entry tables
    (default placement) at B = 32, 10% of the neurons spiking: severed
    entries reach the kernel as weight 0, the kernel leg equals the plain
    leg bit for bit, and the kernel's device time on each table."""
    cc = v1["cc"]
    t = cc.tables
    gen = torch.Generator(device=dev).manual_seed(SEED)
    spikes = (torch.rand((POOL, t.n_neurons), generator=gen, device=dev) < 0.1).float()
    ext = torch.randint(0, 3, (POOL, t.n_clusters, t.k_tags), generator=gen,
                        device=dev).float() * 8.0
    cam_tag = torch.as_tensor(t.cam_tag, device=dev)
    cam_syn = torch.as_tensor(t.cam_syn, device=dev)
    out = {}
    for name, faults in (("healthy", None), ("dead25", FaultSpec(dead_links=DEAD25))):
        be = FabricBackend(faults=faults)
        model = be.model_for(t.n_clusters)
        entries = be.build_entries(t.src_tag, t.src_dest, t.cluster_size, t.k_tags, device=dev)
        ring = torch.randint(0, 3, (POOL, model.max_delay + 1, t.n_clusters, t.k_tags),
                             generator=gen, device=dev).float()
        cursor = torch.ones((), dtype=torch.int32, device=dev)

        def step(kernel, entries=entries, model=model, ring=ring, cursor=cursor):
            return fabric_ops.fabric_deliver_ring(
                spikes, entries, cam_tag, cam_syn, t.cluster_size, t.k_tags, ring, cursor,
                max_delay=model.max_delay, link_capacity=model.link_capacity,
                external_activity=ext, kernel=kernel)

        got, want = step(True), step(False)
        for a, b in zip(got[:2], want[:2]):
            if not torch.equal(a, b):
                raise AssertionError(f"fabric_deliver on the {name} table: kernel and plain "
                                     "legs differ")
        if not all(torch.equal(getattr(got[3], f), getattr(want[3], f))
                   for f in ("link_dropped", "delivered")):
            raise AssertionError(f"fabric_deliver on the {name} table: stats differ")
        severed = int((~entries.alive).sum())
        if (severed == 0) != (faults is None):
            raise AssertionError(f"{name}: {severed} severed entries")
        out[name] = {"entries": int(entries.alive.numel()), "severed_entries": severed,
                     "link_dropped": int(got[3].link_dropped.sum()),
                     "device_ms": device_ms(lambda: step(True), "fabric_deliver_kernel"),
                     "step_ms": time_ms(lambda: step(True))}
    log(f"faults[kernel]: fabric_deliver equals its plain leg on the healthy and the dead-link "
        f"tables ({out['dead25']['severed_entries']} of {out['dead25']['entries']} entries "
        f"severed, weight 0); device {out['healthy']['device_ms']} ms healthy, "
        f"{out['dead25']['device_ms']} ms faulted; ring step {out['healthy']['step_ms']:.4f} / "
        f"{out['dead25']['step_ms']:.4f} ms per call")
    return out


def phase_faults(dev, v1) -> dict[str, int]:
    """Faults and recovery: each part sets the launch counts to 0 just
    before it and reads them just after; their sum must launch every kernel
    of the path."""
    launched: collections.Counter = collections.Counter()
    out = {"kernel": check_faulted_kernel(dev, v1),
           "repair": check_repair_states(dev, v1, launched),
           "classes": check_fault_classes(dev, v1, launched),
           "migration": check_migration(dev, v1, launched),
           "kill_restore": check_kill_restore(dev, v1, launched),
           "memory": check_memory_faults(dev, v1, launched)}
    missing = [name for name in FAULTS_PATH_KERNELS if launched[name] == 0]
    if missing:
        raise AssertionError(f"faults phase: {missing} never launched")
    out["launches"] = dict(launched)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_faults.json").write_text(json.dumps(out, indent=1, default=str))
    log(f"faults phase: launches {dict(launched)}")
    return dict(launched)


# ---------------------------------------------------------------------------
# phase 3d: multi-model residency
# ---------------------------------------------------------------------------
# What the JAX package gives for this phase's workloads on the CPU (printed
# by tests/multimodel_phase_reference.py; the port must reproduce them on
# the card), on the serving phase's Hebbian readout and suits: two resident
# Table-V networks "a" and "b" (3072 neurons in 12 clusters of 256, K =
# 1024) in a pool of 32 slots, 64 sessions of seed 7 with 16 events per step
# alternating between "a" and "b" by index, the default 3x3 fabric. Sums
# are over the sessions: accuracy, link drops, decision steps; and the
# pool's engine steps.
MM_TWO_MODEL = {
    "reference": {"sessions": 64, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 1196,
                  "engine_steps": 41},
    "fabric": {"sessions": 64, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 1236,
               "engine_steps": 42},
}
MM_FABRIC_CAP8 = {"sessions": 32, "accuracy": 1.0, "link_dropped": 847, "latency_steps": 665,
                  "engine_steps": 25}
MM_HOT_LOAD = {  # fabric: "a" alone, "b" loaded after LOAD_AT steps, then "a" unloaded
    "a": {"sessions": 32, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 631},
    "b": {"sessions": 32, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 605},
    "engine_steps": 42,
    "survivor": {"sessions": 32, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 646},
}
MM_REPLACEMENT = {"name": "poker@r1", "placement": [5, 2, 5, 5, 5, 6],
                  "cost_observed_old": 195.5, "cost_observed_new": 22.6,
                  "mid_flight_equal_to_control": True, "drained_at_step": 21,
                  "models": ["poker@r1"], "sessions": 64, "accuracy": 1.0, "link_dropped": 0,
                  "latency_steps": 1266, "engine_steps": 43}
LOAD_AT = 4
REPLACE_AT, AFTER_SWAP = 10, 6
MM_KILL_AT = 5
MM_MODELS = ("a", "b")
MULTIMODEL_PATH_KERNELS = ("cam_match", "fused_deliver", "fabric_deliver", "neuron_step")
MM_MEMORY_SLACK = 1 << 20  # bytes: device memory after a load and an unload against before
# the second, heterogeneous resident of part 6: 6 clusters of 256 at a smaller
# K, S and E, random groups (1-6 sources, 4 targets in one cluster) from a seed
HETERO = {"n_neurons": 1536, "cluster_size": 256, "k_tags": 512, "max_cam_words": 32,
          "max_sram_entries": 8}
HETERO_GROUPS = 600


def _mixed(suits, n=None) -> list[DvsSession]:
    """The serving phase's sessions, on models "a" and "b" by even and odd index."""
    out = _sessions(suits)[:n]
    for i, s in enumerate(out):
        s.model = MM_MODELS[i % 2]
    return out


def _mm_summary(results, pool=None) -> dict:
    out = {"sessions": len(results),
           "accuracy": float(np.mean([r.correct for r in results])),
           "link_dropped": int(sum(r.link_dropped for r in results)),
           "latency_steps": int(sum(r.latency_steps for r in results))}
    if pool is not None:
        out["engine_steps"] = pool.n_steps
    return out


def _pinned(got: dict, want: dict, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got}, the JAX package's {want}")


def _mm_pool(cc, dev, backend, models=MM_MODELS, fabric_options=None, pool_size=POOL):
    return AerSessionPool.from_models({m: cc for m in models}, AerServeConfig(pool_size=pool_size),
                                      backend=backend, device=dev, fabric_options=fabric_options)


def _mm_serve(cc, dev, backend, sessions, fabric_options=None):
    """A two-model pool serving ``sessions``; its launches counted over the serve."""
    pool = _mm_pool(cc, dev, backend, fabric_options=fabric_options)
    results, counts = _counted(lambda: pool.serve(sessions))
    return pool, results, counts


def check_two_model_queued(dev, v1, launched) -> dict:
    """Part 1: the two-model pool on ``fused``, ``cuda`` and ``reference``.
    Every session equals the serving phase's single-model leg of its
    backend (prediction, decided, decision step, counts, drops), the counts
    are the JAX package's, and each kernel runs once per engine step."""
    cc, suits = v1["cc"], v1["suits"]
    out = {}
    for backend, kernel in (("fused", "fused_deliver"), ("cuda", "cam_match"),
                            ("reference", None)):
        t0 = time.perf_counter()
        pool, results, counts = _mm_serve(cc, dev, backend, _mixed(suits))
        wall = time.perf_counter() - t0
        if (pool.engine.n_clusters, pool.engine.n_neurons) != (12, 3072):
            raise AssertionError(f"two-model engine: {pool.engine.n_clusters} clusters, "
                                 f"{pool.engine.n_neurons} neurons")
        _expect_launches(counts, _steps(pool.n_steps, kernel),
                         f"two-model pool on {backend}")
        launched.update(counts)
        if _key(results) != v1["results"][backend]:
            raise AssertionError(f"two-model pool on {backend}: sessions differ from the "
                                 "single-model leg")
        got = _mm_summary(results, pool)
        _pinned(got, MM_TWO_MODEL["reference"], f"two-model pool on {backend}")
        out[backend] = {**got, "wall_ms_per_step": wall * 1e3 / pool.n_steps, "launches": counts,
                        "results": _key(results)}
        log(f"multimodel[two-model {backend}]: 64 sessions on 12 clusters equal the single-model "
            f"leg, accuracy {got['accuracy']}, {got['engine_steps']} steps "
            f"({out[backend]['wall_ms_per_step']:.3f} ms/step wall), launches {counts}")
        if kernel is not None:
            p = out[backend]["profile"] = profile_serving(_mm_pool(cc, dev, backend), suits,
                                                          _mixed(suits))
            host = ", ".join(f"{k} {v:.3f}" for k, v in p["host_ms_per_step"].items())
            log(f"multimodel[profile {backend}]: {p['wall_ms_per_step']:.3f} ms/step wall "
                f"({host} ms); device busy {p['device_busy_ms_per_step']:.3f} ms/step over "
                f"{p['device_ops_per_step']:.1f} device ops, idle share "
                f"{p['device_idle_share']}")
    return out


def check_two_model_fabric(dev, v1, launched) -> dict:
    """Part 2: the two-model pool over the fabric, ring path, the entry table
    built slab by slab (equal, ranges included, to the build from the
    concatenated tables). The kernel leg equals the ``kernel=False`` leg
    session for session, both give the JAX package's counts; and again at
    link capacity 8 on 32 sessions, where both models' entries contend for
    the same link FIFOs."""
    cc, suits = v1["cc"], v1["suits"]
    out = {}
    for label, sessions, extra, want in (("fabric", _mixed(suits), {}, MM_TWO_MODEL["fabric"]),
                                         ("fabric_cap8", _mixed(suits, POOL),
                                          {"link_capacity": 8}, MM_FABRIC_CAP8)):
        legs = {}
        for kernel in (True, False):
            t0 = time.perf_counter()
            pool, results, counts = _mm_serve(cc, dev, "fabric", sessions if kernel
                                              else _mixed(suits, len(sessions)),
                                              {**extra, "kernel": kernel})
            wall = time.perf_counter() - t0
            _expect_launches(counts, _steps(pool.n_steps, "fabric_deliver" if kernel else None),
                             f"two-model {label}, kernel={kernel}")
            launched.update(counts)
            legs[kernel] = (pool, results, wall, counts)
        pool, results, wall, counts = legs[True]
        if _key(results) != _key(legs[False][1]):
            raise AssertionError(f"two-model {label}: kernel and plain legs differ")
        got = _mm_summary(results, pool)
        _pinned(got, want, f"two-model {label}")
        entries = pool.engine._fabric_entries
        if label == "fabric":
            if entries.dstk.numel() != 2 * 1280:
                raise AssertionError(f"two-model entry table holds {entries.dstk.numel()} entries")
            tables = pool.registry.combined()[0]
            direct = pool.engine.fabric_backend.build_entries(
                tables.src_tag, tables.src_dest, tables.cluster_size, tables.k_tags, device=dev)
            for f in dataclasses.fields(direct):
                if not torch.equal(getattr(entries, f.name), getattr(direct, f.name)):
                    raise AssertionError(f"slab-built entry column {f.name} differs from the "
                                         "build from the concatenated tables")
        out[label] = {**got, "wall_ms_per_step": wall * 1e3 / pool.n_steps,
                      "entries": int(entries.dstk.numel()),
                      "ring_slots": pool.engine.fabric_model.max_delay + 1, "launches": counts,
                      "results": _key(results)}
        log(f"multimodel[two-model {label}]: {len(results)} sessions, kernel and plain legs "
            f"equal, the JAX package's counts ({got['link_dropped']} link drops, "
            f"{got['engine_steps']} steps, {out[label]['wall_ms_per_step']:.3f} ms/step wall); "
            f"{out[label]['entries']} slab-built entries, ring of {out[label]['ring_slots']}")
    return out


def _hot_load(cc, dev, backend, suits) -> dict:
    """Part 3 on one backend: "a" with its 32 sessions, ``load_model("b")``
    after LOAD_AT steps (host clock; the first step after it on CUDA
    events), b's sessions admitted as slots free, the pool drained, then
    ``unload_model("a")`` (device memory read before the load and after the
    unload) and the first 32 sessions served on "b"."""
    pool = _mm_pool(cc, dev, backend, models=("a",))
    traffic = _mixed(suits)
    pending = collections.deque([s for s in traffic if s.model == "a"]
                                + [s for s in traffic if s.model == "b"])
    results, timing = [], {}
    while pending or pool.occupied:
        first = False
        if pool.n_steps == LOAD_AT and "b" not in pool.models:
            gc.collect()
            torch.cuda.synchronize()
            timing["memory_before_load"] = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            pool.load_model("b", cc)
            torch.cuda.synchronize()
            timing["load_model_ms"] = (time.perf_counter() - t0) * 1e3
            timing["memory_after_load"] = torch.cuda.memory_allocated()
            timing["sessions_moved"] = len(pool.occupied)
            first = True
        while pending and pool.free_slots and pending[0].model in pool.models:
            pool.admit(pending.popleft())
        if first:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pool.step()
            end.record()
            end.synchronize()
            timing["first_step_ms"] = start.elapsed_time(end)
        else:
            pool.step()
        done = pool.finished_slots()
        if done:
            results.extend(pool.evict_many(done))
    steps = pool.n_steps
    t0 = time.perf_counter()
    pool.unload_model("a")
    torch.cuda.synchronize()
    timing["unload_model_ms"] = (time.perf_counter() - t0) * 1e3
    gc.collect()
    torch.cuda.synchronize()
    timing["memory_after_unload"] = torch.cuda.memory_allocated()
    survivors = _sessions(suits)[:POOL]
    for s in survivors:
        s.model = "b"
    survived = pool.serve(survivors)
    return {"results": results, "survivors": survived, "engine_steps": steps,
            "total_steps": pool.n_steps, "models": list(pool.models), **timing}


def check_hot_load(dev, v1, launched) -> dict:
    """Part 3: the hot load under live sessions on ``fused`` and on the
    fabric. On ``fused`` every session equals the serving phase's fused leg
    (as an undisturbed run); on the fabric the counts are the JAX
    package's. The survivor serves after the unload, and device memory after
    the load and the unload is back within 1 MB of its level before."""
    cc, suits = v1["cc"], v1["suits"]
    out = {}
    for backend, kernel in (("fused", "fused_deliver"), ("fabric", "fabric_deliver")):
        r, counts = _counted(lambda: _hot_load(cc, dev, backend, suits))
        _expect_launches(counts, _steps(r["total_steps"], kernel), f"hot load on {backend}")
        launched.update(counts)
        if r["models"] != ["b"]:
            raise AssertionError(f"hot load on {backend}: resident {r['models']} after unload")
        if backend == "fused":
            if _key(r["results"]) != v1["results"]["fused"]:
                raise AssertionError("hot load on fused: sessions differ from an undisturbed run")
            if _key(r["survivors"]) != v1["results"]["fused"][:POOL]:
                raise AssertionError("hot load on fused: the survivor's sessions differ")
        else:
            got = {m: _mm_summary([x for x in r["results"] if x.session_id % 2 == (m == "b")])
                   for m in "ab"}
            got.update(engine_steps=r["engine_steps"], survivor=_mm_summary(r["survivors"]))
            _pinned(got, MM_HOT_LOAD, "hot load on the fabric")
        drift = r["memory_after_unload"] - r["memory_before_load"]
        if abs(drift) > MM_MEMORY_SLACK:
            raise AssertionError(f"hot load on {backend}: device memory {r['memory_before_load']} "
                                 f"bytes before the load, {r['memory_after_unload']} after the "
                                 "unload")
        out[backend] = {k: v for k, v in r.items() if k not in ("results", "survivors")}
        out[backend].update(memory_drift_bytes=drift, launches=counts)
        log(f"multimodel[hot load {backend}]: load_model ({r['sessions_moved']} live sessions "
            f"moved) {r['load_model_ms']:.3f} ms, first step after it {r['first_step_ms']:.3f} ms "
            f"(CUDA events), unload {r['unload_model_ms']:.3f} ms; device memory "
            f"{r['memory_before_load']} -> {r['memory_after_load']} (loaded) -> "
            f"{r['memory_after_unload']} bytes (unloaded), {drift:+d}; "
            f"{len(r['results'])} sessions and {len(r['survivors'])} after the unload "
            f"{'equal the single-model leg' if backend == 'fused' else 'give the JAX counts'}, "
            f"launches {counts}")
    return out


def _replacement(cc, dev, suits) -> tuple[dict, dict]:
    """Part 4's run: two 32-slot fabric pools with per-link stats on the
    first 32 sessions, stepped REPLACE_AT times; the forced versioned swap on
    the first; AFTER_SWAP more steps of both; then the next 32 sessions
    retargeted onto the new version and the old one drained."""
    pools = [_mm_pool(cc, dev, "fabric", models=("poker",),
                      fabric_options={"per_link_stats": True}) for _ in range(2)]
    for pool in pools:
        for s in _sessions(suits)[:POOL]:
            pool.admit(s)
    pool, control = pools
    for _ in range(REPLACE_AT):
        pool.step()
        control.step()
    ctl = ReplacementController(pool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = ctl.maybe_replace(force=True)
    torch.cuda.synchronize()
    swap_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(AFTER_SWAP):
        pool.step()
        control.step()
    equal = all(a.step == b.step and np.array_equal(a.counts, b.counts) and a.dropped == b.dropped
                and a.link_dropped == b.link_dropped for a, b in zip(pool.slots, control.slots))
    pending = collections.deque(ctl.retarget(s) for s in _sessions(suits)[POOL:])
    results, drained_at = [], None
    while pending or pool.occupied:
        done = pool.finished_slots()
        if done:
            results.extend(pool.evict_many(done))
        if ctl.retired and ctl.drain_retired():
            drained_at = pool.n_steps
        while pending and pool.free_slots:
            pool.admit(pending.popleft())
        if pool.occupied:
            pool.step()
    if ctl.retired and ctl.drain_retired():
        drained_at = pool.n_steps
    got = {"name": report["name"], "placement": np.asarray(report["placement"]).tolist(),
           "cost_observed_old": report["cost_observed_old"],
           "cost_observed_new": report["cost_observed_new"],
           "mid_flight_equal_to_control": bool(equal), "drained_at_step": drained_at,
           "models": list(pool.models), **_mm_summary(results, pool)}
    return got, {"swap_ms": swap_ms, "control_steps": control.n_steps}


def check_replacement(dev, v1, launched) -> dict:
    """Part 4: live versioned re-placement. ``maybe_replace(force=True)``
    after 10 steps gives the JAX package's ``poker@r1`` placement and
    observed costs; the sessions in flight stay byte-equal to an unswapped
    control for the next 6 steps; ``retarget`` and ``drain_retired`` retire
    the old version."""
    (got, extra), counts = _counted(lambda: _replacement(v1["cc"], dev, v1["suits"]))
    _expect_launches(counts, _steps(got["engine_steps"] + extra["control_steps"], "fabric_deliver"),
                     "live re-placement")
    launched.update(counts)
    _pinned(got, MM_REPLACEMENT, "live re-placement")
    log(f"multimodel[re-placement]: {got['name']} on {got['placement']} (observed cost "
        f"{got['cost_observed_old']} -> {got['cost_observed_new']}), swap "
        f"{extra['swap_ms']:.3f} ms; sessions in flight byte-equal to the control for "
        f"{AFTER_SWAP} steps; old version drained at step {got['drained_at_step']}; "
        f"{got['sessions']} sessions, accuracy {got['accuracy']}, the JAX package's counts; "
        f"launches {counts}")
    return {**got, **extra, "launches": counts}


def _serve_killed_mm(cc, dev, backend, suits, ckpt_dir: Path) -> tuple[list, dict]:
    """Part 5's run: the two-model pool serving the 64 mixed sessions; at
    engine step MM_KILL_AT checkpoint, drop the pool and its engine, build a
    new engine and ``restore(models=)``, then serve on."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ck = Checkpointer(str(ckpt_dir))
    cfg = AerServeConfig(pool_size=POOL)
    models = {m: cc for m in MM_MODELS}
    pool = _mm_pool(cc, dev, backend)
    pending = collections.deque(_mixed(suits))
    results, timing = [], {}
    while pending or pool.occupied:
        while pending and pool.free_slots:
            pool.admit(pending.popleft())
        pool.step()
        if pool.n_steps == MM_KILL_AT and not timing:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool.checkpoint(ck, blocking=True)
            t1 = time.perf_counter()
            del pool
            engine = _mm_pool(cc, dev, backend).engine
            swapped = _mm_pool(cc, dev, backend, models=MM_MODELS[::-1]).engine
            try:
                AerSessionPool.restore(cc, swapped, cfg, ck, models={m: cc for m in MM_MODELS[::-1]})
            except CheckpointMismatchError:
                pass
            else:
                raise AssertionError("a restore into the models' other order did not raise")
            del swapped
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pool = AerSessionPool.restore(cc, engine, cfg, ck, models=models)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            timing = {"save_ms": (t1 - t0) * 1e3, "restore_ms": (t3 - t2) * 1e3,
                      "checkpoint_bytes": sum(p.stat().st_size
                                              for p in (ckpt_dir / f"step_{MM_KILL_AT}").iterdir())}
            if pool.n_steps != MM_KILL_AT or len(pool.occupied) != POOL:
                raise AssertionError("restored two-model pool lost its step count or sessions")
        finished = pool.finished_slots()
        if finished:
            results.extend(pool.evict_many(finished))
    timing["engine_steps"] = pool.n_steps
    return results, timing


def check_mm_kill_restore(dev, v1, launched, uninterrupted) -> dict:
    """Part 5: a checkpoint of the two-model pool at step 5 on ``fused`` and
    on the fabric; pool and engine dropped, ``restore(models=)`` onto a new
    engine, the resumed run bit-exact against the uninterrupted one (parts 1
    and 2); a restore into a pool with the models in the other order raises
    ``CheckpointMismatchError``."""
    out = {}
    for backend, kernel in (("fused", "fused_deliver"), ("fabric", "fabric_deliver")):
        (results, timing), counts = _counted(lambda: _serve_killed_mm(
            v1["cc"], dev, backend, v1["suits"], OUT_DIR / "ckpt_multimodel" / backend))
        _expect_launches(counts, _steps(timing["engine_steps"], kernel),
                         f"two-model kill-restore {backend}")
        launched.update(counts)
        if _key(results) != uninterrupted[backend]:
            raise AssertionError(f"two-model kill-restore on {backend}: sessions differ from the "
                                 "uninterrupted run")
        out[backend] = {**timing, "launches": counts}
        log(f"multimodel[kill-restore {backend}]: checkpoint at step {MM_KILL_AT} "
            f"({timing['checkpoint_bytes']} bytes) in {timing['save_ms']:.3f} ms, restore "
            f"{timing['restore_ms']:.3f} ms; 64 sessions equal the uninterrupted two-model run; "
            f"the models' other order refused")
    return out


def hetero_tables(seed: int = SEED):
    """Part 6's second resident: 6 clusters of 256 at K = 512, S = 32, E = 8,
    random groups of 1-6 sources onto 4 targets in one cluster."""
    rng = np.random.default_rng(seed)
    spec = NetworkSpec(**HETERO)
    n, cs = HETERO["n_neurons"], HETERO["cluster_size"]
    for _ in range(HETERO_GROUPS):
        srcs = rng.choice(n, size=int(rng.integers(1, 7)), replace=False)
        c = int(rng.integers(n // cs))
        dsts = c * cs + rng.choice(cs, size=4, replace=False)
        spec.connect_group(srcs.tolist(), [(int(d), int(rng.integers(4))) for d in dsts],
                           shared_tag=False)
    return compile_network(spec)


def _slab_mask(slabs, nc: int, k: int, dev) -> torch.Tensor:
    """[nc, K] 1 where a resident compiled the tag, 0 on the padded columns."""
    mask = torch.zeros((nc, k), device=dev)
    for s in slabs:
        mask[s.cluster_lo:s.cluster_hi, :s.k_tags] = 1.0
    return mask


def _hold(what, got, want, integer) -> float:
    if integer and not torch.equal(got, want):
        raise AssertionError(f"{what}: not bit-exact on integer inputs, max err "
                             f"{(got - want).abs().max()}")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    return float((got - want).abs().max())


def _draw(gen, shape, integer: bool, dev, high: int = 3, scale: float = 8.0) -> torch.Tensor:
    """Integer-valued (multiples of ``scale`` below ``high * scale``) or random-float values."""
    if integer:
        return torch.randint(0, high, shape, generator=gen, device=dev).float() * scale
    return torch.rand(shape, generator=gen, device=dev)


def _kernels_at(dev, parts, gen, label) -> dict:
    """The three stage-2 kernels on the residents' combined table at B = 32
    and 0%, 10% and 100% activity, each against its plain version on
    integer and on random-float inputs, padded tag columns at zero; the
    fabric entry table built slab by slab, equal to the concatenated
    build; the device time at 10%, the split and the blocks per SM at this
    shape."""
    tables, slabs = concat_tables(parts)
    nc, k, cs, n = tables.n_clusters, tables.k_tags, tables.cluster_size, tables.n_neurons
    src_tag, src_dest, cam_tag, cam_syn = (torch.as_tensor(getattr(tables, f), device=dev)
                                           for f in ("src_tag", "src_dest", "cam_tag", "cam_syn"))
    tabs = (src_tag, src_dest, cam_tag, cam_syn)
    mask = _slab_mask(slabs, nc, k, dev)
    be = FabricBackend()
    entries = be.build_entries_slabs([(p.src_tag, p.src_dest) for p in parts], cs, k,
                                     device=dev)
    direct = be.build_entries(tables.src_tag, tables.src_dest, cs, k, device=dev)
    for f in dataclasses.fields(direct):
        if not torch.equal(getattr(entries, f.name), getattr(direct, f.name)):
            raise AssertionError(f"{label}: slab-built entry column {f.name} differs")
    m, d1 = entries.dstk.shape[0], be.model_for(nc).max_delay + 1
    ranges = {"cluster_start": entries.cluster_start, "cluster_order": entries.cluster_order}
    errs = collections.defaultdict(list)
    timed = {}
    for share in (0.1, 0.0, 1.0):
        for integer in (True, False):
            live = (torch.rand((POOL, nc, k), generator=gen, device=dev) < share) * mask
            act = live * _draw(gen, (POOL, nc, k), integer, dev, high=17)
            errs["cam_match"].append(_hold(f"{label} cam_match at {share:.0%}",
                                           cam_ops.cam_match(act, cam_tag, cam_syn, cs),
                                           cam_ops.cam_match_ref(act, cam_tag, cam_syn, cs),
                                           integer))
            active = torch.rand((POOL, n), generator=gen, device=dev) < share
            spikes = active.float() if integer else \
                active * torch.rand((POOL, n), generator=gen, device=dev)
            q = compact_events(spikes, n)
            ext = _draw(gen, (POOL, nc, k), integer, dev) * mask
            errs["fused_deliver"].append(_hold(
                f"{label} fused_deliver at {share:.0%}",
                fused_ops.fused_deliver(q, *tabs, cs, k, external_activity=ext),
                fused_ops.fused_deliver_ref(q, *tabs, cs, k, external_activity=ext), integer))
            carries = (torch.rand((POOL, m), generator=gen, device=dev) < share).float()
            w = carries if integer else carries * torch.rand((POOL, m), generator=gen, device=dev)
            ring = _draw(gen, (POOL, d1, nc, k), integer, dev, scale=1.0) * mask
            for cursor in range(d1):
                cur = torch.tensor(cursor, dtype=torch.int32, device=dev)
                args = (entries.dstk, entries.delay, w, ring, cur, ext, cam_tag, cam_syn, cs, k)
                drive, new_ring = fabric_ops.fabric_deliver(*args, **ranges)
                p_drive, p_ring = fabric_ops.fabric_deliver_ref(*args)
                what = f"{label} fabric_deliver at {share:.0%}, cursor {cursor}"
                errs["fabric_deliver"].append(max(_hold(what, drive, p_drive, integer),
                                                  _hold(what, new_ring, p_ring, integer)))
            if share == 0.1 and not integer:
                timed = {"cam_match": lambda a=act: cam_ops.cam_match(a, cam_tag, cam_syn, cs),
                         "fused_deliver": lambda q=q, e=ext: fused_ops.fused_deliver(
                             q, *tabs, cs, k, external_activity=e),
                         "fabric_deliver": lambda a=args: fabric_ops.fabric_deliver(*a, **ranges)}
    splits = {"cam_match": cam_ops.work_split(POOL, cs, k),
              "fused_deliver": fused_ops.work_split(POOL, n, cs, k),
              "fabric_deliver": fabric_ops.work_split(POOL, cs, k, d1)}
    infos = {"cam_match": cam_ops.kernel_info(splits["cam_match"], k),
             "fused_deliver": fused_ops.kernel_info(splits["fused_deliver"], k),
             "fabric_deliver": fabric_ops.kernel_info(splits["fabric_deliver"], k, d1)}
    out = {"clusters": nc, "neurons": n, "k_tags": k, "cam_words": int(cam_tag.shape[1]),
           "sram_entries": int(src_tag.shape[1]), "fabric_entries": m, "ring_slots": d1}
    for name, fn in timed.items():
        out[name] = {"max_abs_err": max(errs[name]),
                     "device_ms": device_ms(fn, f"{name}_kernel"), "ms": time_ms(fn),
                     "split": str(splits[name]),
                     "registers": infos[name]["registers"],
                     "blocks_per_sm": infos[name]["blocks_per_sm"]}
    log(f"multimodel[kernels, {label}]: {nc} clusters, K {k}, S {out['cam_words']}, E "
        f"{out['sram_entries']}, {m} entries; all three kernels equal their plain versions at "
        "0/10/100% activity (bit-exact on integer inputs); at 10%: " + "; ".join(
            f"{name} device {out[name]['device_ms']} ms, split {out[name]['split']}, "
            f"{out[name]['blocks_per_sm']} blocks/SM" for name in timed))
    return out


def check_hetero_kernels(dev, v1) -> dict:
    """Part 6: ``cam_match``, ``fused_deliver`` and ``fabric_deliver`` on
    the two Table-V residents' combined table and on Table-V beside a
    smaller-K / S / E network (padded CAM words and SRAM entries ``-1``,
    tag columns [512, 1024) of its clusters at zero)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = v1["cc"].tables
    out = {}
    for label, parts in (("two_table_v", [t, t]), ("table_v_plus_k512", [t, hetero_tables()])):
        out[label] = _kernels_at(dev, parts, gen, label)
    return out


def phase_multimodel(dev, v1) -> tuple[dict[str, int], dict]:
    """Multi-model residency: each serving part sets the launch counts to 0
    just before it and reads them just after; their sum must launch every
    kernel of the path. Part 6's comparisons are not counted."""
    launched: collections.Counter = collections.Counter()
    queued = check_two_model_queued(dev, v1, launched)
    fabric = check_two_model_fabric(dev, v1, launched)
    uninterrupted = {"fused": queued["fused"]["results"], "fabric": fabric["fabric"]["results"]}
    out = {"two_model": queued, "two_model_fabric": fabric,
           "hot_load": check_hot_load(dev, v1, launched),
           "replacement": check_replacement(dev, v1, launched),
           "kill_restore": check_mm_kill_restore(dev, v1, launched, uninterrupted),
           "kernels": check_hetero_kernels(dev, v1)}
    missing = [name for name in MULTIMODEL_PATH_KERNELS if launched[name] == 0]
    if missing:
        raise AssertionError(f"multimodel phase: {missing} never launched")
    for part in (queued, fabric):
        for leg in part.values():
            leg.pop("results")
    out["launches"] = dict(launched)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_multimodel.json").write_text(json.dumps(out, indent=1, default=str))
    log(f"multimodel phase: launches {dict(launched)}")
    return dict(launched), out["kernels"]


# ---------------------------------------------------------------------------
# phase 3e: multi-device
# ---------------------------------------------------------------------------
# What the JAX package gives for this phase's workloads on the CPU with 8
# fake devices (printed by tests/multidevice_phase_reference.py; the port
# must reproduce them on the card), on the serving phase's Hebbian readout
# and sessions: sums over the sessions of accuracy, link drops and decision
# steps, and the fleet's steps. Part 1: fleets of 1, 2 and 4 shards over the
# fabric, 64 slots in all. Part 2: 2 shards of 32 slots on the slab-retiled
# tables over 1x1, 1x2 and 2x2 meshes, fabric ring and queued. Part 3: the
# 1x1 and 1x2 fleets at link capacity 8 on 32 sessions. Part 4: migration
# and drain across meshes, checkpoint, restore onto fewer shards, kill and
# recovery, and the admission refusal.
MD_PLACEMENT = [0, 0, 4, 1, 1, 1]  # retile_for_slabs(cc, 2)
MD_FLEETS = {  # part 1, by shard count
    n: {"sessions": 64, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 1260,
        "fleet_steps": 22} for n in ("1", "2", "4")}
MD_MESHES = {  # part 2, by step and mesh
    **{f"fabric_{m}": {"sessions": 64, "accuracy": 1.0, "link_dropped": 0, "latency_steps": 1238,
                       "fleet_steps": 22} for m in ("1x1", "1x2", "2x2")},
    **{f"reference_{m}": {"sessions": 64, "accuracy": 1.0, "link_dropped": 0,
                          "latency_steps": 1196, "fleet_steps": 21} for m in ("1x1", "1x2", "2x2")},
}
MD_CAP8 = {m: {"sessions": 32, "accuracy": 1.0, "link_dropped": 34, "latency_steps": 634,
               "fleet_steps": 21} for m in ("1x1", "1x2")}  # part 3, by mesh
MD_CONTROL = {  # part 4
    "migration": {"migrated": 8, "drained": 8, "sessions": 32, "accuracy": 1.0, "link_dropped": 0,
                  "latency_steps": 633, "fleet_steps": 21},
    "restore": {"occupied": 64, "sessions": 64, "accuracy": 1.0, "link_dropped": 0,
                "latency_steps": 1260, "fleet_steps": 22},
    "recover": {"held": 16, "recovered": 16, "sessions": 64, "accuracy": 1.0, "link_dropped": 0,
                "latency_steps": 1260, "fleet_steps": 24, "watchdog_events": 64,
                "watched_shards": [0, 1, 2, 3]},
    "admitted_before_refusal": 8,
}
MD_SLOTS = 64
MD_MIGRATE, MD_CKPT_AT, MD_KILL_AFTER, MD_VICTIM = 8, 3, 2, 2
MULTIDEVICE_PATH_KERNELS = ("cam_match", "neuron_step")
MD_TIMED_STEPS = 5


def _md_summary(results, fleet=None) -> dict:
    out = _mm_summary(results)
    if fleet is not None:
        out["fleet_steps"] = fleet.n_steps
    return out


def _md_drain(fleet, results=None, watchdog=None, events=None) -> list:
    results = [] if results is None else results
    while fleet.busy:
        fleet.step()
        if watchdog is not None:
            events.extend(watchdog.observe(fleet))
        results.extend(fleet.evict_finished())
    return results


def _cells(fleet) -> int:
    """Mesh cells stepped per fleet step: one cam_match launch each."""
    return sum(fleet.pools[i].engine.mesh.size for i in fleet.live_shards())


def _fleet_device_ms(fleet, reps: int = 3, tries: int = 4) -> float:
    """Device time of one fleet step: for each live shard, CUDA events
    around one replay of its engine step on its current carry (inputs
    already on the card; a step never updates the carry it is given),
    queued behind a spin kernel that holds the device until the whole step
    is enqueued, so the host's launch gaps do not count. The median of
    ``reps`` per shard, summed over the shards. One shard's step at a time:
    while the device spins, a launch blocks once about a thousand are
    queued, so a whole fleet's replays would time the spin instead. A
    replay whose enqueue outlasts its spin (a host stall) times host gaps:
    it is discarded and retaken behind a spin twice as long, at most
    ``tries`` times before the measurement fails."""
    total = 0.0
    for pool in (fleet.pools[i] for i in fleet.live_shards()):
        eng, carry = pool.engine, pool.carry
        inp = torch.as_tensor(pool.gather_inputs(), device=eng.device)
        eng.step(carry, inp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(carry, inp)
        spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 5
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            for _ in range(tries):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                torch.cuda._sleep(int(spin_ms * 2e6))  # cycles at ~2 GHz
                start.record()
                t0 = time.perf_counter()
                eng.step(carry, inp)
                enqueue_ms = (time.perf_counter() - t0) * 1e3
                end.record()
                end.synchronize()
                if enqueue_ms <= spin_ms:
                    times.append(start.elapsed_time(end))
                    break
                log(f"  shard replay: enqueue took {enqueue_ms:.1f} ms, past the {spin_ms:.1f} ms "
                    "spin that holds the device; retaken behind a spin twice as long")
                spin_ms *= 2
            else:
                raise AssertionError(f"shard replay: enqueue outlasted the spin {tries} times "
                                     f"(last {enqueue_ms:.1f} ms)")
        total += statistics.median(times)
    return total


def _shard_step_kernels(fleet, top: int = 5) -> dict:
    """Where a shard step's device time goes: device ms by kernel name of one
    replay of the first live shard's engine step under torch.profiler (up
    to three traces, until one shows device time), the largest ``top``,
    and the step's device ops."""
    from torch.profiler import ProfilerActivity, profile

    pool = fleet.pools[fleet.live_shards()[0]]
    inp = torch.as_tensor(pool.gather_inputs(), device=pool.engine.device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pool.engine.step(pool.carry, inp)
            torch.cuda.synchronize()
        by: collections.Counter = collections.Counter()
        ops = 0
        for evt in device_ops(prof.events()):
            by[evt.name[:80]] += evt.time_range.elapsed_us() / 1e3
            ops += 1
        if ops:
            return {"device_ops": ops, "top_device_ms": dict(by.most_common(top))}
    return {"device_ops": 0, "top_device_ms": {}}


def _md_timing(make_fleet, suits) -> dict:
    """A fresh fleet loaded with the 64 sessions: host ms per fleet step over
    MD_TIMED_STEPS steps (after 3), and the device ms of one step."""
    fleet = make_fleet()
    for s in _sessions(suits):
        fleet.submit(s)
    for _ in range(3):
        fleet.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MD_TIMED_STEPS):
        fleet.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / MD_TIMED_STEPS
    device = _fleet_device_ms(fleet)
    return {"wall_ms_per_fleet_step": wall, "device_ms_per_fleet_step": device,
            "device_idle_share": max(0.0, 1.0 - device / wall),
            "cells_per_fleet_step": _cells(fleet), "shard_step": _shard_step_kernels(fleet)}


def _md_leg(what, make_fleet, sessions, want_summary, launched, suits=None) -> tuple[list, dict]:
    """Serve ``sessions`` on a new fleet with the launch counts set to 0 just
    before and read just after: cam_match once per mesh cell per fleet step,
    nothing else; the summary must be the JAX package's. With ``suits``, a
    second fleet is timed loaded (:func:`_md_timing`)."""
    fleet = make_fleet()
    t0 = time.perf_counter()
    results, counts = _counted(lambda: fleet.serve(sessions))
    wall = time.perf_counter() - t0
    _expect_launches(counts, _steps(_cells(fleet) * fleet.n_steps, "cam_match"), what)
    launched.update(counts)
    got = _md_summary(results, fleet)
    _pinned(got, want_summary, what)
    out = {**got, "serve_wall_ms_per_fleet_step": wall * 1e3 / fleet.n_steps,
           "sessions_per_s": len(results) / wall, "launches": counts}
    if suits is not None:
        out.update(_md_timing(make_fleet, suits))
    log(f"multidevice[{what}]: {len(results)} sessions, the JAX package's counts "
        f"({got['link_dropped']} link drops, {got['fleet_steps']} fleet steps), "
        f"{out['sessions_per_s']:.2f} sessions/s; launches {counts}"
        + ("" if suits is None else
           f"; loaded fleet step {out['wall_ms_per_fleet_step']:.3f} ms wall, "
           f"{out['device_ms_per_fleet_step']:.4f} ms on the device over "
           f"{out['cells_per_fleet_step']} cells, idle share {out['device_idle_share']:.3f}; "
           f"one shard step: {out['shard_step']['device_ops']} device ops, largest "
           + ", ".join(f"{name} {ms:.4f}" for name, ms in
                       list(out["shard_step"]["top_device_ms"].items())[:3]) + " ms"))
    return results, out


def check_md_fleets(dev, v1, launched) -> dict:
    """Part 1: fleets of 1, 2 and 4 shards over the fabric, 64 slots in all,
    oversubscribed on the card (every shard's 1x1 mesh on it). Every
    session equals the serving phase's one-pool fabric leg."""
    cc, suits = v1["cc"], v1["suits"]
    warm = ShardedSessionPool(cc, AerServeConfig(pool_size=2), ShardConfig(backend="fabric"))
    warm.serve(_sessions(suits)[:2])  # first-use allocations
    out = {}
    for n in (1, 2, 4):
        def make(n=n):
            return ShardedSessionPool(cc, AerServeConfig(pool_size=MD_SLOTS // n),
                                      ShardConfig(n_shards=n, backend="fabric"))

        results, out[str(n)] = _md_leg(f"fleet of {n}", make, _sessions(suits),
                                       MD_FLEETS[str(n)], launched, suits)
        if _key(results) != v1["results"]["fabric"]:
            raise AssertionError(f"fleet of {n}: sessions differ from the one-pool fabric leg")
    return out


def check_md_meshes(dev, v1, rc, launched) -> tuple[dict, dict]:
    """Part 2: 2 shards of 32 slots on the retiled tables over 1x1, 1x2 and
    2x2 meshes of the one card named explicitly (``devices=[cuda:0] * k``),
    on the fabric ring and on the queued step. Every mesh's sessions equal
    the 1x1 fleet's (the queued ones also the serving phase's reference
    leg); on one card ``devices=None`` refuses a mesh of 2 cells."""
    suits = v1["suits"]
    out, base = {}, {}
    for backend in ("fabric", "reference"):
        for bd, cd in ((1, 1), (1, 2), (2, 2)):
            label = f"{backend}_{bd}x{cd}"

            def make(bd=bd, cd=cd, backend=backend):
                return ShardedSessionPool(
                    rc, AerServeConfig(pool_size=MD_SLOTS // 2),
                    ShardConfig(n_shards=2, backend=backend, cluster_devices=cd,
                                batch_devices=bd), devices=[dev] * (bd * cd))

            results, out[label] = _md_leg(f"2 shards {label}", make, _sessions(suits),
                                          MD_MESHES[label], launched, suits)
            if (bd, cd) == (1, 1):
                base[backend] = _key(results)
            elif _key(results) != base[backend]:
                raise AssertionError(f"{label}: sessions differ from the 1x1 fleet's")
    if base["reference"] != v1["results"]["reference"]:
        raise AssertionError("queued fleet on the retiled tables: sessions differ from the "
                             "serving phase's reference leg")
    if torch.cuda.device_count() == 1:
        for make, text in (
                (lambda: ShardedSessionPool(rc, AerServeConfig(pool_size=2),
                                            ShardConfig(cluster_devices=2)),
                 "fleet needs at least 2 devices per shard, have 1"),
                (lambda: build_poker_shard_engine(rc.tables, cluster_devices=2),
                 "mesh needs 2 devices, only 1 visible")):
            try:
                make()
            except ValueError as e:
                if not str(e).startswith(text):
                    raise
            else:
                raise AssertionError(f"devices=None on one card did not refuse: {text}")
        log("multidevice: on one card, devices=None refuses a 2-cell mesh (fleet and engine)")
    return out, base


def check_md_cap8(dev, v1, rc, launched) -> dict:
    """Part 3: link capacity 8 on 1x1 and 1x2 meshes, the first 32 sessions:
    link drops are the JAX package's, and equal on both meshes."""
    suits = v1["suits"]
    out, keys = {}, {}
    for cd in (1, 2):
        def factory(i, devices, cd=cd):
            return ShardedEventEngine(
                rc.tables, poker_neuron_params(), fabric=Fabric(),
                fabric_options={"link_capacity": 8}, queue_capacity=rc.tables.n_neurons,
                devices=devices, cluster_devices=cd)

        def make(cd=cd, factory=factory):
            return ShardedSessionPool(rc, AerServeConfig(pool_size=POOL // 2),
                                      ShardConfig(n_shards=2, backend="fabric",
                                                  cluster_devices=cd),
                                      devices=[dev] * cd, engine_factory=factory)

        results, out[f"1x{cd}"] = _md_leg(f"link capacity 8, 1x{cd}", make,
                                          _sessions(suits)[:POOL], MD_CAP8[f"1x{cd}"], launched)
        keys[cd] = _key(results)
    if keys[1] != keys[2] or out["1x2"]["link_dropped"] == 0:
        raise AssertionError("link capacity 8: the 1x2 fleet differs from the 1x1, or no drops")
    return out


def check_md_control(dev, v1, rc, base, launched) -> dict:
    """Part 4, the control plane. Migration: 8 sessions moved mid-flight
    from a 1x1 shard onto a 1x2 shard (each move timed), then the 1x1 shard
    drained; every session equals the 1x1 fleet of part 2. A fabric fleet of
    4 shards of 32 slots (16 sessions each) checkpointed after 3 steps under build/chip_smoke/fleet_ckpt (save
    timed), restored onto 2 shards (timed; the lost shards' sessions into the
    survivors' free slots) and served; the original killed
    at shard 2 two steps later and recovered (timed) with a fleet watchdog
    scanning every live shard; every session equals the one-pool fabric leg.
    A fleet of 2 x 2 slots with queue depth 2 refuses its ninth session."""
    cc, suits = v1["cc"], v1["suits"]
    out = {}

    def factory(i, devices):
        return build_poker_shard_engine(rc.tables, "fabric", cluster_devices=1 + i,
                                        devices=[dev] * (1 + i))

    fleet = ShardedSessionPool(rc, AerServeConfig(pool_size=POOL),
                               ShardConfig(n_shards=2, backend="fabric"), engine_factory=factory)
    migrate_ms = []

    def migration():
        for s in _sessions(suits)[:POOL]:
            fleet.submit(s)
        for _ in range(4):
            fleet.step()
        results = fleet.evict_finished()
        moved = [s.session_id for s in fleet.pools[0].slots if s is not None][:MD_MIGRATE]
        for sid in moved:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.migrate(sid, 1)
            torch.cuda.synchronize()
            migrate_ms.append((time.perf_counter() - t0) * 1e3)
        drained = fleet.drain_shard(0)
        return len(moved), drained, _md_drain(fleet, results)

    (moved, drained, results), counts = _counted(migration)
    _expect_launches(counts, _steps(3 * fleet.n_steps, "cam_match"), "migration fleet")
    launched.update(counts)
    got = {"migrated": moved, "drained": drained, **_md_summary(results, fleet)}
    _pinned(got, MD_CONTROL["migration"], "migration and drain")
    if _key(results) != [k for k in base["fabric"] if k[0] < POOL]:
        raise AssertionError("migrated sessions differ from the 1x1 fleet's")
    out["migration"] = {**got, "migrate_ms": migrate_ms, "launches": counts}
    log(f"multidevice[migration]: {moved} sessions moved 1x1 -> 1x2 mid-flight in "
        f"{statistics.median(migrate_ms):.3f} ms each (median), {drained} drained, every session "
        "equal to the 1x1 fleet's")

    ckpt_dir = OUT_DIR / "fleet_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    big = ShardedSessionPool(cc, AerServeConfig(pool_size=MD_SLOTS // 2),
                             ShardConfig(n_shards=4, backend="fabric"))
    wd = FleetWatchdog()
    events: list = []
    ck = Checkpointer(str(ckpt_dir), keep=2)

    def until_checkpoint():
        for s in _sessions(suits):
            big.submit(s)
        for _ in range(MD_CKPT_AT):
            big.step()
            events.extend(wd.observe(big))
        finished = big.evict_finished()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.checkpoint(ck, blocking=True)
        return finished, (time.perf_counter() - t0) * 1e3

    (finished, save_ms), counts = _counted(until_checkpoint)
    _expect_launches(counts, _steps(4 * MD_CKPT_AT, "cam_match"), "fleet before its checkpoint")
    launched.update(counts)
    t0 = time.perf_counter()
    small = ShardedSessionPool.restore(cc, AerServeConfig(pool_size=MD_SLOTS // 2),
                                       ShardConfig(n_shards=2, backend="fabric"), ck)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    occupied = sum(o for o, _ in small.occupancy().values())
    results, counts = _counted(lambda: _md_drain(small, list(finished)))
    _expect_launches(counts, _steps(2 * (small.n_steps - MD_CKPT_AT), "cam_match"),
                     "restored fleet")
    launched.update(counts)
    got = {"occupied": occupied, **_md_summary(results, small)}
    _pinned(got, MD_CONTROL["restore"], "restore onto 2 shards")
    if _key(results) != v1["results"]["fabric"]:
        raise AssertionError("restored fleet: sessions differ from the one-pool fabric leg")
    out["restore"] = {**got, "save_ms": save_ms, "restore_ms": restore_ms, "launches": counts}

    def kill_and_recover():
        for _ in range(MD_KILL_AFTER):
            big.step()
            events.extend(wd.observe(big))
        held = sum(s is not None for s in big.pools[MD_VICTIM].slots)
        big.kill_shard(MD_VICTIM)
        t0 = time.perf_counter()
        recovered = big.recover_shard(ck, MD_VICTIM)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return held, recovered, ms, _md_drain(big, list(finished), wd, events)

    (held, recovered, recover_ms, results), counts = _counted(kill_and_recover)
    after = big.n_steps - MD_CKPT_AT - MD_KILL_AFTER
    _expect_launches(counts, _steps(4 * MD_KILL_AFTER + 3 * after, "cam_match"), "killed fleet")
    launched.update(counts)
    got = {"held": held, "recovered": recovered, **_md_summary(results, big),
           "watchdog_events": len(events), "watched_shards": sorted(wd._per_shard)}
    _pinned(got, MD_CONTROL["recover"], "kill and recover")
    if _key(results) != v1["results"]["fabric"]:
        raise AssertionError("recovered fleet: sessions differ from the one-pool fabric leg")
    out["recover"] = {**got, "recover_ms": recover_ms, "launches": counts}
    log(f"multidevice[checkpoint]: 4 shards x 32 slots saved in {save_ms:.2f} ms, restored onto "
        f"2 shards of 32 in {restore_ms:.2f} ms ({occupied} sessions in flight); shard "
        f"{MD_VICTIM} killed with {held} sessions, {recovered} recovered in {recover_ms:.2f} ms; "
        f"{len(events)} watchdog events over shards {sorted(wd._per_shard)}; every session equal "
        "to the one-pool fabric leg")

    tiny = ShardedSessionPool(cc, AerServeConfig(pool_size=2), ShardConfig(queue_depth=2))
    admitted = 0
    try:
        for s in _sessions(suits):
            tiny.submit(s)
            admitted += 1
    except AdmissionError:
        pass
    if admitted != MD_CONTROL["admitted_before_refusal"]:
        raise AssertionError(f"admission: {admitted} sessions before the refusal")
    out["admitted_before_refusal"] = admitted
    return out


def check_md_backend(dev, v1) -> dict:
    """Part 5: the ``sharded`` backend on a 1x2 mesh of the card against the
    ``cuda`` backend on the serving phase's tables, B = 32, a lossless
    queue, at 0%, 10% and 100% activity: drive and drops equal, and
    cam_match launched once per mesh cell per call (not counted for the
    phase: a comparison)."""
    cc = v1["cc"]
    t = build_poker_engine(cc.tables, "cuda", device=dev).tables
    args = (t.src_tag, t.src_dest, t.cam_tag, t.cam_syn, cc.tables.cluster_size,
            cc.tables.k_tags)
    sharded = get_backend("sharded", mesh=make_mesh((1, 2), devices=[dev, dev]))
    single = get_backend("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, nc, k = cc.tables.n_neurons, cc.tables.n_clusters, cc.tables.k_tags
    out = {}
    for act in (0.0, 0.1, 1.0):
        spikes = (torch.rand((POOL, n), generator=gen, device=dev) < act).float()
        ext = torch.randint(0, 3, (POOL, nc, k), generator=gen, device=dev).float() * 8.0
        before = cam_ops.cam_match.launches
        got, got_st = sharded.deliver(spikes, *args, external_activity=ext, queue_capacity=n,
                                      with_stats=True)
        torch.cuda.synchronize()
        calls = cam_ops.cam_match.launches - before
        want, want_st = single.deliver(spikes, *args, external_activity=ext, queue_capacity=n,
                                       with_stats=True)
        if not torch.equal(got, want) or not torch.equal(got_st.dropped, want_st.dropped):
            raise AssertionError(f"sharded backend at {act:.0%}: drive or drops differ from cuda")
        if calls != 2:
            raise AssertionError(f"sharded backend: {calls} cam_match launches for 2 cells")
        out[str(act)] = {"drive_sum": float(got.sum()), "dropped": int(got_st.dropped.sum())}
    log("multidevice[sharded backend]: 1x2 mesh equals the cuda backend at 0%, 10% and 100% "
        "activity (drive bit-exact, drops), 2 cam_match launches per call")
    return out


def phase_multidevice(dev, v1) -> dict[str, int]:
    """Multi-device: each serving part sets the launch counts to 0 just
    before it and reads them just after; their sum must launch cam_match,
    and nothing else."""
    count = torch.cuda.device_count()
    log(f"multidevice: {count} visible device(s)"
        + ("; disjoint device sets and peer copies are not exercised: every mesh cell and "
           "every shard runs on cuda:0" if count == 1 else ""))
    rc = retile_for_slabs(v1["cc"], 2)
    if np.asarray(rc.tables.tile_of_cluster).tolist() != MD_PLACEMENT:
        raise AssertionError(f"retiled placement {rc.tables.tile_of_cluster}, the JAX package's "
                             f"{MD_PLACEMENT}")
    launched: collections.Counter = collections.Counter()
    t0 = time.perf_counter()
    out = {"device_count": count, "fleets": check_md_fleets(dev, v1, launched)}
    out["meshes"], base = check_md_meshes(dev, v1, rc, launched)
    out["cap8"] = check_md_cap8(dev, v1, rc, launched)
    out["control"] = check_md_control(dev, v1, rc, base, launched)
    out["backend"] = check_md_backend(dev, v1)
    out["seconds"] = time.perf_counter() - t0
    stray = {name: n for name, n in launched.items()
             if n and name not in MULTIDEVICE_PATH_KERNELS}
    missing = [name for name in MULTIDEVICE_PATH_KERNELS if launched[name] == 0]
    if missing or stray:
        raise AssertionError(f"multidevice phase: {missing} never launched, or {stray} launched")
    out["launches"] = dict(launched)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_multidevice.json").write_text(json.dumps(out, indent=1, default=str))
    log(f"multidevice phase: launches {dict(launched)} in {out['seconds']:.1f} s")
    return dict(launched)


# ---------------------------------------------------------------------------
# phase 4: LM serving (rwkv6-3b)
# ---------------------------------------------------------------------------
STREAM_TOL = 2.0**-5  # bfloat16 residual stream: 4 ulps at its largest element


def _hold_rel(got, want, tol: float, what: str) -> float:
    """Largest difference over the largest magnitude of ``want``; fails past ``tol``."""
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    if not err <= tol:
        raise AssertionError(f"{what}: differs by {err:.3g} of the largest value, past {tol}")
    return err


def _stream_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Largest difference over the largest magnitude of ``want``; fails past
    STREAM_TOL. A chunk output that rounds to the next bfloat16 value moves
    the block's output by an ulp or two at the stream's scale."""
    return _hold_rel(got, want, STREAM_TOL, f"{what}: kernel and plain legs")


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
            outs = {kernel: block(x, None, caches[kernel][i], use_kernel=kernel)
                    for kernel in (True, False)}
            (xk, ck, _), (xp, cp, _) = outs[True], outs[False]
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


def profile_lm(fn, per: int = 1, kernel: str | None = None, inference: bool = True) -> dict:
    """One call of ``fn`` under torch.profiler (and ``inference_mode`` unless
    ``inference=False``, as a train step needs), reported per ``per`` steps:
    wall ms, device busy ms, device ops, the device idle share of the wall
    time, the largest kernels and, given the name of a kernel of the port,
    that kernel's device ms."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    mode = torch.inference_mode() if inference else contextlib.nullcontext()
    with mode, profile(activities=activities) as prof:
        _, wall_ms = _timed(fn)
    by_kernel: dict[str, float] = {}
    n_ops = 0
    for evt in device_ops(prof.events()):
        by_kernel[evt.name] = by_kernel.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e3
        n_ops += 1
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "steps": per,
        "wall_ms": wall_ms / per,
        "device_busy_ms": busy / per,
        "device_ops": n_ops / per,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top_device_ms": {name[:100]: ms / per for name, ms in top},
    }
    if kernel is not None:
        out[f"{kernel}_device_ms"] = sum(ms for name, ms in by_kernel.items()
                                         if f"{kernel}_kernel" in name) / per
    return out


def _clone(tree):
    """A copy of a cache tree (attention layers write their KV rings in place)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def time_prefill_decode(model, prompts, tokens, max_len: int, extras=None,
                        kernel: str | None = None, profile: bool = True) -> tuple[dict, torch.Tensor]:
    """Prefill (median of 3) and the decode steps feeding ``tokens[:, :-1]``
    teacher-forced, timed apart on the host clock around a device
    synchronise; then, with ``profile``, one prefill and the same decode
    steps under torch.profiler. Returns (the numbers, the last prefill's
    logits)."""
    b, s = prompts.shape
    steps = tokens.shape[1] - 1
    with torch.inference_mode():
        prefill_ms, repeats = [], []
        for _ in range(3):
            (logits, caches), ms = _timed(
                lambda: model.prefill(prompts, model.init_caches(b, max_len), extras))
            prefill_ms.append(ms)
            repeats.append(logits)
        if not torch.isfinite(logits).all() or logits.shape != (b, 1, model.cfg.vocab):
            raise AssertionError(f"prefill logits: shape {tuple(logits.shape)}, or not finite")

        def decode(c):
            for t in range(steps):
                pos = torch.full((b, 1), s + t, device=prompts.device)
                lg, c = model.decode_step(tokens[:, t:t + 1], pos, c)
            return lg

        last, decode_ms = _timed(lambda c0=_clone(caches): decode(c0))
        if not torch.isfinite(last).all():
            raise AssertionError("decode logits are not finite")
    pf = statistics.median(prefill_ms)
    per_token = decode_ms / steps
    out = {"prefill_ms": pf, "prefill_ms_runs": prefill_ms,
           "prefill_tokens_per_s": b * s / pf * 1e3, "decode_ms_per_step": per_token,
           "decode_tokens_per_s": b / per_token * 1e3,
           "prefill_bitwise_repeatable": all(torch.equal(x, repeats[0]) for x in repeats)}
    if profile:
        t0 = time.perf_counter()
        out["profile_prefill"] = profile_lm(
            lambda: model.prefill(prompts, model.init_caches(b, max_len), extras), kernel=kernel)
        out["profile_decode"] = profile_lm(lambda c0=_clone(caches): decode(c0), per=steps,
                                           kernel=kernel)
        out["profile_seconds"] = time.perf_counter() - t0  # tracing and reading the traces
    return out, logits


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

    # prefill and decode timed apart (median of 3 prefills; 31 decode steps), then profiled
    before = rwkv_ops.rwkv6_chunk.launches
    timing, logits = time_prefill_decode(model, prompts, tokens, LM_PROMPT + LM_NEW,
                                         kernel="rwkv6_chunk")
    if rwkv_ops.rwkv6_chunk.launches - before != 4 * per_prefill:
        raise AssertionError("a prefill did not launch rwkv6_chunk once per chunk per layer")
    lm.update(timing)
    pf, per_token = lm["prefill_ms"], lm["decode_ms_per_step"]
    prof, dprof = lm["profile_prefill"], lm["profile_decode"]
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
    del model, engine, logits, plain_logits
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


# ---------------------------------------------------------------------------
# phase 5: attention and MoE serving
# ---------------------------------------------------------------------------
G3_BATCH, G3_PROMPT = 4, 4096  # gemma3-1b: 4 prompts of 4096 tokens, LM_NEW new
SMALL_BATCH, SMALL_PROMPT, SMALL_NEW = 2, 300, 8  # phase 5c
FP32_TOL = 1e-4  # float32 logits, the same sums in two orders: 1e-4 of the largest
# phase 5c: (arch, periods kept; None keeps the full depth). yi-34b and
# internvl2-76b would not fit whole in bfloat16 (about 69 and 152 GB)
SMALL_ARCHS = (("gemma2-27b", 1), ("glm4-9b", 1), ("yi-34b", 1), ("internvl2-76b", 1),
               ("whisper-base", None))


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _frontend_inputs(cfg, b: int, dev) -> dict | None:
    """The stub frontends' inputs, as ``batch_extras``: random frames
    (whisper) or patch embeddings (internvl2) from the seed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if cfg.frontend == "audio_stub":
        return {"frames": torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen, device=dev)}
    if cfg.frontend == "vision_stub":
        return {"prefix_embeddings": torch.randn((b, cfg.n_prefix_embeddings, cfg.d_model),
                                                 generator=gen, device=dev)}
    return None


def decode_floor_ms(model, b: int, max_len: int) -> float:
    """The least time of one decode step: every byte it must read once, over
    the card's memory rate. Every layer's parameters (a shared block at each
    of its applications: it does not stay in the 50 MB L2 between them; every
    MoE expert, as each expert runs its buffer of slots, empty or not, as
    repro's dispatch does), the other parameters but the rows of an untied
    input embedding (a gather) and MTP (it enters the loss only), and the
    caches."""
    n = sum(_nbytes(*block.parameters()) for block in model.stack)
    n += sum(p.numel() * p.element_size() for name, p in model.named_parameters()
             if not name.startswith(("stack.", "mtp."))
             and not (name == "embedding.table" and not model.cfg.tie_embeddings))
    caches = model.init_caches(b, max_len)
    n += sum(_nbytes(*c.values()) for c in caches["stack"])
    n += _nbytes(caches["enc_out"]) if "enc_out" in caches else 0
    return n / HBM_BYTES_PER_S * 1e3


def serve_lm(cfg, dev, b: int, s: int, new: int, profile: bool):
    """Build ``cfg`` on the card from the seed, serve ``b`` prompts of ``s``
    tokens plus ``new`` greedy tokens through ``Engine.generate``, then time
    prefill and decode apart (profiled when asked). Returns (model, numbers,
    prompts, tokens, frontend inputs)."""
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = _timed(lambda: build_model(cfg, device=dev, seed=SEED))
    init_allocated = torch.cuda.memory_allocated()
    init_requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    prompts_np = np.random.default_rng(SEED).integers(0, cfg.vocab, (b, s))
    prompts = torch.as_tensor(prompts_np, device=dev)
    extras = _frontend_inputs(cfg, b, dev)
    engine = Engine(model, ServeConfig(max_len=s + new))
    engine.generate(prompts, 2, extras)  # first-use allocations and library loads
    tokens, gen_ms = _timed(lambda: engine.generate(prompts_np, new, extras))
    if tokens.shape != (b, new) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"{cfg.name} generate: tokens of shape {tuple(tokens.shape)} "
                             f"in [{int(tokens.min())}, {int(tokens.max())}]")
    total, active = cfg.param_count()
    out = {"layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
           "parameters": sum(p.numel() for p in model.parameters()),
           "param_count_total": total, "param_count_active": active, "init_ms": init_ms,
           "init_memory_allocated_bytes": init_allocated, "init_requested_bytes": init_requested,
           "batch": b, "prompt": s, "new": new, "generate_ms": gen_ms,
           "generate_tokens_per_s": b * new / gen_ms * 1e3,
           "decode_floor_ms": decode_floor_ms(model, b, s + new)}
    timing, _ = time_prefill_decode(model, prompts, tokens, s + new, extras, profile=profile)
    out.update(timing)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
        + f", {out['parameters']} parameters, param_count {total} / {active} active, "
        f"{cfg.param_dtype}) serves B = {b} x {s} + {new} greedy: generate {gen_ms:.1f} ms; "
        f"prefill {out['prefill_ms']:.2f} ms ({out['prefill_tokens_per_s']:.0f} tokens/s), decode "
        f"{out['decode_ms_per_step']:.2f} ms/step ({out['decode_tokens_per_s']:.1f} tokens/s; "
        f"floor {out['decode_floor_ms']:.2f} ms), peak memory {out['max_memory_allocated_gb']:.2f} GB")
    for what in ("prefill", "decode"):
        pr = out.get(f"profile_{what}")
        if pr:
            top = ", ".join(f"{name[:60]} {ms:.2f}" for name, ms in list(pr["top_device_ms"].items())[:4])
            log(f"  profiled {what}: wall {pr['wall_ms']:.2f} ms, device busy "
                f"{pr['device_busy_ms']:.2f} ms over {pr['device_ops']:.0f} ops, idle share "
                f"{pr['device_idle_share']:.3f}; largest: {top}")
    return model, out, prompts, tokens, extras


def check_against_full(model, prompts, tokens, extras, tol: float, what: str) -> dict:
    """A prefill over ``prompts`` and decode steps feeding ``tokens[:, :-1]``
    against one forward over the prompt and those tokens: the logits at the
    last prompt position and at each decoded one within ``tol`` of the
    largest full-forward logit (repro's tests/test_smoke_archs.py check)."""
    b, s = prompts.shape
    n = tokens.shape[1] - 1
    seq = torch.cat([prompts, tokens[:, :n]], 1)
    pos = torch.arange(s + n, device=prompts.device).expand(b, s + n)
    with torch.inference_mode():
        h, _, _ = model(seq, pos, None, extras)
        full = model._unembed(h[:, s - 1:])
        del h
        lp, caches = model.prefill(prompts, model.init_caches(b, s + n), extras)
        got = [lp[:, 0]]
        for t in range(n):
            ld, caches = model.decode_step(tokens[:, t:t + 1], pos[:, s + t:s + t + 1], caches)
            got.append(ld[:, 0])
        got = torch.stack(got, 1)
    err = _hold_rel(got, full, tol, f"{what}: prefill + decode against the full forward")
    return {"max_rel_err": err, "tol": tol, "positions": n + 1,
            "argmax_agree_share": float((got.argmax(-1) == full.argmax(-1)).float().mean())}


def moe_routing(model, cfg, prompts, tokens) -> dict:
    """Expert loads of the prefill and of the decode steps (teacher-forced
    with the served tokens), and the assignments dropped at the configured
    capacity: an expert keeps the first ``cap`` of its assignments."""
    b, s = prompts.shape
    with torch.inference_mode():
        caches = model.init_caches(b, s + tokens.shape[1])
        pos = torch.arange(s, device=prompts.device).expand(b, s)
        _, caches, aux = model(prompts, pos, caches)
        loads = {"prefill": (aux["moe_load_periods"], b * s)}
        steps = []
        for t in range(tokens.shape[1] - 1):
            pos = torch.full((b, 1), s + t, device=prompts.device)
            _, caches, aux = model(tokens[:, t:t + 1], pos, caches)
            steps.append(aux["moe_load_periods"])
        loads["decode"] = (torch.stack(steps), b)
    out = {}
    for what, (load, t) in loads.items():
        cap = moe_ops.expert_capacity(cfg, t)
        dropped = int((load - cap).clamp_min(0).sum())
        assigned = int(load.sum())
        if assigned != load.numel() // cfg.n_experts * t * cfg.top_k:  # (step,) layer rows
            raise AssertionError(f"{what}: {assigned} assignments for {t} tokens per layer")
        out[what] = {"tokens_per_layer": t, "capacity": cap, "assignments": assigned,
                     "dropped": dropped, "dropped_share": dropped / assigned,
                     "load_max": int(load.max()), "load_min": int(load.min()),
                     "load_mean": float(load.mean()),
                     "expert_layers_over_capacity": int((load > cap).sum())}
        log(f"  routing, {what}: {t} tokens per layer, capacity {cap} per expert: {dropped} of "
            f"{assigned} assignments dropped ({dropped / assigned:.4f}); load per expert and layer "
            f"{out[what]['load_min']}-{out[what]['load_max']} (mean {out[what]['load_mean']:.1f}), "
            f"{out[what]['expert_layers_over_capacity']} (expert, layer) pairs over capacity")
    return out


def check_moe_layer(model, cfg, dev) -> dict:
    """The first MoE layer of the served model on the card: ``moe_local`` at
    capacity T * k (nothing drops) against ``moe_reference`` on 512 random
    bfloat16 tokens, within STREAM_TOL of the largest output (bfloat16
    expert outputs summed in bfloat16 against a float32 combine), loads
    equal; and the layer timed at the prefill's and the decode's token
    counts (CUDA events)."""
    layer = next(block.ffn for block in model.stack if block.spec.ffn == "moe")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((512, cfg.d_model), generator=gen, device=dev).to(lm_layers.dt(cfg.param_dtype))
    with torch.inference_mode():
        y, aux = moe_ops.moe_local(layer, x, cfg, capacity=512 * cfg.top_k)
        ref, ref_aux = moe_ops.moe_reference(layer, x, cfg)
        if not torch.equal(aux["load"], ref_aux["load"]):
            raise AssertionError("moe_local and moe_reference route differently")
        err = _hold_rel(y, ref, STREAM_TOL, "moe_local against moe_reference")
        out = {"tokens": 512, "max_rel_err": err, "tol": STREAM_TOL}
        for what, t in (("prefill", LM_BATCH * LM_PROMPT), ("decode", LM_BATCH)):
            xt = torch.randn((t, cfg.d_model), generator=gen, device=dev).to(x.dtype)
            out[f"moe_local_ms_{what}"] = time_ms(lambda: moe_ops.moe_local(layer, xt, cfg),
                                                  repeats=10, inner=5)
    log(f"  one MoE layer: moe_local (capacity T*k) against moe_reference at T = 512, bf16: "
        f"within {err:.3g} of the largest output (limit {STREAM_TOL}), loads equal; moe_local "
        f"{out['moe_local_ms_prefill']:.3f} ms at T = {LM_BATCH * LM_PROMPT}, "
        f"{out['moe_local_ms_decode']:.3f} ms at T = {LM_BATCH}")
    return out


def phase5_deepseek(dev) -> dict:
    """5a: deepseek-moe-16b at full width and depth."""
    cfg = get_config("deepseek-moe-16b")
    model, out, prompts, tokens, _ = serve_lm(cfg, dev, LM_BATCH, LM_PROMPT, LM_NEW, profile=True)
    out["routing"] = moe_routing(model, cfg, prompts, tokens)
    out["moe_layer"] = check_moe_layer(model, cfg, dev)
    del model
    _free()
    # float32, the dense prefix layer and one MoE layer, a capacity factor at
    # which no expert can drop (capacity >= T); 2 prompts of 512 + 8 steps
    cfg32 = dataclasses.replace(cfg, n_periods=1, param_dtype="float32", compute_dtype="float32",
                                capacity_factor=float(math.ceil(cfg.n_experts / cfg.top_k)))
    model = build_model(cfg32, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED)
    p32 = torch.as_tensor(rng.integers(0, cfg.vocab, (2, LM_PROMPT)), device=dev)
    t32 = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)), device=dev)
    out["fp32_prefix_and_one_moe_layer"] = check_against_full(model, p32, t32, None, FP32_TOL,
                                                              "deepseek-moe-16b fp32, 2 layers")
    log(f"  fp32, the prefix layer + 1 MoE layer at full width, capacity_factor "
        f"{cfg32.capacity_factor} (no drops): prefill + 8 decode steps equal the full forward "
        f"within {out['fp32_prefix_and_one_moe_layer']['max_rel_err']:.3g} of the largest logit "
        f"(limit {FP32_TOL})")
    del model
    _free()
    return out


def check_chunked_attention(dev, cfg) -> dict:
    """One gemma3-1b attention core at its prefill shape (B = 4, S = 4096,
    4 query heads on 1 kv head of 256), float32, random q, k, v from the
    seed: ``attend_chunked`` against ``attend_dense``, global (causal) and
    local (window 512), allclose(rtol=1e-5, atol=2e-5); each path timed."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, s = G3_BATCH, G3_PROMPT
    q = torch.randn((b, s, cfg.n_heads, cfg.head_dim), generator=gen, device=dev)
    k, v = (torch.randn((b, s, cfg.n_kv_heads, cfg.head_dim), generator=gen, device=dev)
            for _ in range(2))
    pos = torch.arange(s, device=dev).expand(b, s)
    out = {}
    with torch.inference_mode():
        for what, window in (("global", None), ("local", 512)):
            kw = dict(window=window, scale=cfg.head_dim**-0.5)
            chunked = attn_ops.attend_chunked(q, k, v, pos, pos, **kw)
            dense = attn_ops.attend_dense(q, k, v, pos, pos, **kw)
            torch.testing.assert_close(chunked, dense, rtol=1e-5, atol=2e-5)
            out[what] = {"max_abs_err": float((chunked - dense).abs().max()),
                         "chunked_ms": time_ms(lambda: attn_ops.attend_chunked(q, k, v, pos, pos, **kw),
                                               repeats=3, inner=2),
                         "dense_ms": time_ms(lambda: attn_ops.attend_dense(q, k, v, pos, pos, **kw),
                                             repeats=3, inner=2)}
            del chunked, dense
    log(f"  gemma3-1b attention core at B = {b}, S = {s}, fp32: attend_chunked equals attend_dense "
        + "; ".join(f"{w} max abs err {o['max_abs_err']:.3g}, chunked {o['chunked_ms']:.2f} ms, "
                    f"dense {o['dense_ms']:.2f} ms" for w, o in out.items())
        + " (allclose(rtol=1e-5, atol=2e-5))")
    return out


def phase5_gemma3(dev) -> dict:
    """5b: gemma3-1b at full width and depth, 4096-token prompts."""
    cfg = get_config("gemma3-1b")
    model, out, prompts, tokens, _ = serve_lm(cfg, dev, G3_BATCH, G3_PROMPT, LM_NEW, profile=True)
    del model
    _free()
    out["attention_core"] = check_chunked_attention(dev, cfg)
    _free()
    # float32, one period (5 local layers and the global one), the same prompts + 8 steps
    cfg32 = dataclasses.replace(cfg, n_periods=1, remainder=(), param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED)
    out["fp32_one_period"] = check_against_full(model, prompts, tokens[:, :9], None, FP32_TOL,
                                                "gemma3-1b fp32, one period")
    log(f"  fp32, one period (6 layers) at full width: prefill of {G3_PROMPT} + 8 decode steps "
        f"equal the full forward within {out['fp32_one_period']['max_rel_err']:.3g} of the "
        f"largest logit (limit {FP32_TOL})")
    del model
    _free()
    return out


def phase5_small(dev) -> dict:
    """5c: the other five at full width, B = 2 prompts of 300 tokens + 8."""
    out = {}
    for arch, periods in SMALL_ARCHS:
        cfg = get_config(arch)
        if periods is not None:
            cfg = dataclasses.replace(cfg, n_periods=periods)
        model, res, prompts, tokens, extras = serve_lm(cfg, dev, SMALL_BATCH, SMALL_PROMPT,
                                                       SMALL_NEW, profile=False)
        res["periods_kept"] = cfg.n_periods
        res["vs_full"] = check_against_full(model, prompts, tokens, extras, STREAM_TOL, arch)
        log(f"  {arch} ({cfg.n_periods} of {get_config(arch).n_periods} periods): prefill + "
            f"{SMALL_NEW - 1} decode steps equal the full forward within "
            f"{res['vs_full']['max_rel_err']:.3g} of the largest logit (limit {STREAM_TOL}); "
            f"argmax agrees at {res['vs_full']['argmax_agree_share']:.3f} of positions")
        out[arch] = res
        del model, extras
        _free()
    return out


def phase_attention_moe(dev) -> dict[str, int]:
    """Phase 5: the launch counts set to 0 just before and read just after.
    No Pallas kernel lies on this path (repro computes attention and the MoE
    dispatch in plain jnp), so it must launch none of the port's kernels."""
    t0 = time.perf_counter()
    _reset_counts()
    out = {"deepseek-moe-16b": phase5_deepseek(dev), "gemma3-1b": phase5_gemma3(dev),
           "small": phase5_small(dev)}
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"attention and MoE phase launched {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_attention_moe.json").write_text(json.dumps(out, indent=1))
    log(f"attention and MoE phase: {out['seconds']:.1f} s, launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 6: the LM remainder (MLA with MTP, Mamba2 with a shared block)
# ---------------------------------------------------------------------------
V3_PERIODS = 1  # deepseek-v3-671b in bf16: 3 dense MLA layers + 1 of 58 MoE periods (15.1 B)
LOSS_BATCH, LOSS_SEQ, LOSS_CHUNK = 2, 64, 32  # Model.loss with MTP, whole and blockwise
SSM_PREFILL = 384  # one Mamba2 layer: prefill of 384, then LM_PROMPT - 384 decode steps


def mla_cache_bytes(cfg) -> dict:
    """The MLA ring per token and layer in the parameter dtype: the latent
    ``c_kv`` and ``k_rope`` (beside the int32 position), and what a GQA cache of
    the same heads would hold (K and V of every head)."""
    item = torch.finfo(lm_layers.dt(cfg.param_dtype)).bits // 8
    latent = (cfg.kv_lora_rank + cfg.qk_rope_dim) * item
    gqa = cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * item
    return {"latent_bytes": latent, "position_bytes": 4, "gqa_equivalent_bytes": gqa,
            "ratio": gqa / latent}


def check_loss(model, dev) -> dict:
    """``Model.loss`` with MTP, forward only, on a LOSS_BATCH x LOSS_SEQ batch
    from the seed (labels the next token): finite, and the whole
    cross-entropy equal to the blockwise one (``loss_chunk`` LOSS_CHUNK)
    within rtol 1e-5."""
    cfg = model.cfg
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab, (LOSS_BATCH, LOSS_SEQ)),
                           device=dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    model.loss_chunk = 0
    (whole, _), whole_ms = _timed(lambda: model.loss(batch))
    model.loss_chunk = LOSS_CHUNK
    (chunked, _), chunked_ms = _timed(lambda: model.loss(batch))
    model.loss_chunk = 0
    whole, chunked = float(whole), float(chunked)
    if not math.isfinite(whole) or abs(chunked - whole) > 1e-5 * abs(whole):
        raise AssertionError(f"Model.loss {whole} (whole) against {chunked} (chunks of {LOSS_CHUNK})")
    return {"batch": LOSS_BATCH, "seq": LOSS_SEQ, "loss": whole, "loss_chunked": chunked,
            "loss_chunk": LOSS_CHUNK, "rel_diff": abs(chunked - whole) / abs(whole),
            "ms": whole_ms, "chunked_ms": chunked_ms}


def phase6_deepseek_v3(dev) -> dict:
    """6a: deepseek-v3-671b at full width, cut in depth; MTP built."""
    t0 = time.perf_counter()
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_periods=V3_PERIODS)
    model, out, prompts, tokens, _ = serve_lm(cfg, dev, LM_BATCH, LM_PROMPT, LM_NEW, profile=True)
    out["serve_seconds"] = time.perf_counter() - t0
    out["cut"] = {"n_periods": V3_PERIODS, "of": full.n_periods,
                  "layers": cfg.n_layers, "of_layers": full.n_layers,
                  "why": "two MoE periods would be about 55 GB of bf16 weights beside activations"}
    out["mtp_parameters"] = sum(p.numel() for p in model.mtp.parameters())
    out["mla_cache_per_token_per_layer"] = mla_cache_bytes(cfg)
    out["routing"] = moe_routing(model, cfg, prompts, tokens)
    c = out["mla_cache_per_token_per_layer"]
    log(f"  cut to {cfg.n_layers} of {full.n_layers} layers ({V3_PERIODS} of {full.n_periods} MoE "
        f"periods); MTP {out['mtp_parameters']} parameters; MLA ring {c['latent_bytes']} B + "
        f"{c['position_bytes']} B position per token and layer ({c['ratio']:.1f}x under a GQA cache "
        f"of {c['gqa_equivalent_bytes']} B)")
    del model
    _free()
    # float32, the three dense MLA prefix layers alone (n_periods 0), MTP built:
    # prefill + 8 absorbed decode steps against one full (decompressed) forward
    cfg32 = dataclasses.replace(full, n_periods=0, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED)
    rng = np.random.default_rng(SEED)
    p32 = torch.as_tensor(rng.integers(0, cfg.vocab, (2, LM_PROMPT)), device=dev)
    t32 = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)), device=dev)
    out["fp32_dense_prefix"] = check_against_full(model, p32, t32, None, FP32_TOL,
                                                  "deepseek-v3 fp32, 3 MLA layers")
    out["loss"] = check_loss(model, dev)
    log(f"  fp32, the 3 dense MLA layers at full width: prefill of {LM_PROMPT} + 8 absorbed decode "
        f"steps equal the full forward within {out['fp32_dense_prefix']['max_rel_err']:.3g} of the "
        f"largest logit (limit {FP32_TOL}); Model.loss with MTP on {LOSS_BATCH} x {LOSS_SEQ}: "
        f"{out['loss']['loss']:.6f} whole, {out['loss']['loss_chunked']:.6f} in chunks of "
        f"{LOSS_CHUNK} (rel diff {out['loss']['rel_diff']:.3g}, limit 1e-5)")
    del model
    _free()
    out["seconds"] = time.perf_counter() - t0
    return out


def check_ssm_layer(dev, cfg) -> dict:
    """One float32 Mamba2 layer at full width from the seed, on B = LM_BATCH x
    LM_PROMPT random inputs: the chunked core against the sequential one, and
    a prefill of SSM_PREFILL + decode steps to LM_PROMPT against the full
    layer, each within FP32_TOL of the largest output."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer = ssm_ops.Mamba2(cfg, torch.float32, dev, gen).requires_grad_(False)
    u = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), generator=gen, device=dev) * 0.5
    with torch.inference_mode():
        (chunked, _), chunked_ms = _timed(lambda: layer(u))
        (seq, _), seq_ms = _timed(lambda: layer(u, sequential=True))
        err = _hold_rel(chunked, seq, FP32_TOL, "Mamba2 layer: chunked core against sequential")
        state = ssm_ops.init_mamba2_state(LM_BATCH, cfg, dev)
        y, state = layer(u[:, :SSM_PREFILL], state)
        outs = [y]
        for t in range(SSM_PREFILL, LM_PROMPT):
            y, state = layer(u[:, t:t + 1], state)
            outs.append(y)
        err_decode = _hold_rel(torch.cat(outs, 1), chunked, FP32_TOL,
                               "Mamba2 layer: prefill + decode against the full layer")
    out = {"batch": LM_BATCH, "seq": LM_PROMPT, "chunked_vs_sequential_max_rel_err": err,
           "prefill": SSM_PREFILL, "decode_steps": LM_PROMPT - SSM_PREFILL,
           "prefill_decode_vs_full_max_rel_err": err_decode, "chunked_ms": chunked_ms,
           "sequential_ms": seq_ms, "tol": FP32_TOL}
    log(f"  one Mamba2 layer at full width, fp32, B = {LM_BATCH} x {LM_PROMPT}: chunked core equals the "
        f"sequential one within {err:.3g} of the largest output ({chunked_ms:.1f} ms against "
        f"{seq_ms:.1f} ms); prefill {SSM_PREFILL} + {LM_PROMPT - SSM_PREFILL} decode steps equal the "
        f"full layer within {err_decode:.3g} (limit {FP32_TOL})")
    return out


def phase6_zamba2(dev) -> dict:
    """6b: zamba2-2.7b whole (54 Mamba2 layers, 9 applications of one shared
    attention block)."""
    cfg = get_config("zamba2-2.7b")
    t0 = time.perf_counter()
    _free()
    before = torch.cuda.memory_allocated()
    before_requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    model, out, prompts, tokens, _ = serve_lm(cfg, dev, LM_BATCH, LM_PROMPT, LM_NEW, profile=True)
    out["serve_seconds"] = time.perf_counter() - t0
    # the shared block is one parameter set: the build's device memory is the
    # parameters' bytes counted once. Bytes requested by the build within 1%
    # of them; the allocator's blocks (memory_allocated) round each tensor of
    # over 1 MB up to its 2 MB segment, so they may exceed them by at most
    # 2 MB per tensor (applying the block 9 times would add 8 x 0.21 GB)
    shared = model.stack.shared_block
    applications = sum(block is shared for block in model.stack)
    params = list(model.parameters())
    param_bytes = _nbytes(*params)
    requested = out["init_requested_bytes"] - before_requested
    allocated = out["init_memory_allocated_bytes"] - before
    rounding = 2**21 * sum(p.numel() * p.element_size() > 2**20 for p in params)
    out["shared_block"] = {
        "applications": applications,
        "parameters": sum(p.numel() for p in shared.parameters()),
        "state_dict_keys": sum(k.startswith("stack.shared_block.") for k in model.state_dict()),
        "param_bytes_counted_once": param_bytes, "requested_bytes_by_build": requested,
        "requested_over_param_bytes": requested / param_bytes,
        "memory_allocated_by_build": allocated,
        "memory_allocated_over_param_bytes": allocated / param_bytes,
        "allocator_rounding_bound_bytes": rounding,
    }
    if (applications != cfg.n_periods or abs(requested / param_bytes - 1) > 0.01
            or not param_bytes <= allocated <= param_bytes + rounding):
        raise AssertionError(f"zamba2 shared block: {applications} applications, the build requested "
                             f"{requested} and allocated {allocated} bytes for {param_bytes} "
                             f"parameter bytes")
    log(f"  shared block: {applications} applications of one set of "
        f"{out['shared_block']['parameters']} parameters; the build requested {requested} bytes "
        f"({requested / param_bytes:.5f} of the {param_bytes} parameter bytes counted once) and "
        f"allocated {allocated} ({allocated / param_bytes:.4f}; the 2 MB segments of large tensors)")
    del model
    _free()
    cfg32 = dataclasses.replace(cfg, n_periods=1, param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED)
    out["fp32_one_period"] = check_against_full(model, prompts, tokens[:, :9], None, FP32_TOL,
                                                "zamba2 fp32, one period")
    log(f"  fp32, one period (6 Mamba2 layers + the shared block) at full width: prefill of "
        f"{LM_PROMPT} + 8 decode steps equal the full forward within "
        f"{out['fp32_one_period']['max_rel_err']:.3g} of the largest logit (limit {FP32_TOL})")
    del model
    _free()
    out["mamba2_layer"] = check_ssm_layer(dev, cfg)
    _free()
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_lm_remainder(dev) -> dict[str, int]:
    """Phase 6: the launch counts set to 0 just before and read just after.
    No Pallas kernel lies on this path (repro computes MLA, the SSD scan and
    the shared block in plain jnp); the port's bf16 MLA prefill launches
    ``mla_attention`` once a layer (6a's float32 run keeps the plain
    attention), so that count is a whole, non-zero multiple of 6a's layers
    and every other count is 0."""
    t0 = time.perf_counter()
    _reset_counts()
    out = {"deepseek-v3-671b": phase6_deepseek_v3(dev), "zamba2-2.7b": phase6_zamba2(dev)}
    counts = _read_counts()
    mla_layers = out["deepseek-v3-671b"]["layers"]
    if (any(v for k, v in counts.items() if k != "mla_attention")
            or counts["mla_attention"] == 0 or counts["mla_attention"] % mla_layers):
        raise AssertionError(f"LM remainder phase launched {counts} ({mla_layers} MLA layers)")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_lm_remainder.json").write_text(json.dumps(out, indent=1))
    log(f"LM remainder phase: {out['seconds']:.1f} s (deepseek-v3 "
        f"{out['deepseek-v3-671b']['seconds']:.1f} s, serving "
        f"{out['deepseek-v3-671b']['serve_seconds']:.1f}; zamba2 {out['zamba2-2.7b']['seconds']:.1f} s, "
        f"serving {out['zamba2-2.7b']['serve_seconds']:.1f}), launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
TRAIN_B, TRAIN_S = 8, 512  # 7a and 7c: sequences x tokens per step
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 3, 4  # 7a, through launch/train.run
TRAIN_TIMED = 3  # 7a: steps timed by part after one warm-up step
TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 64  # 7b: float32, one period, card against CPU
MOE_TRAIN_STEPS, MOE_MICROBATCHES = 3, 2  # 7c
ARCH_B, ARCH_S = 2, 32  # 7d: every arch's smoke config
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
# float32 gradients held leaf by leaf to allclose(1e-4, GRAD_ATOL * max |g|):
# float32 rounding reaches a few 1e-6 of a leaf's largest gradient on its
# elements near zero (the CPU tests measure the port and repro each against a
# float64 evaluation: up to 4.8e-6 and 2.4e-6); the elements past 1e-6 are
# counted and reported
GRAD_RTOL, GRAD_ATOL, GRAD_ATOL_TIGHT = 1e-4, 1e-5, 1e-6
ROUTER_U = 1e-3  # repro's router-bias step


class _Tee:
    """A text stream writing to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def train_flops(model, b: int, s: int) -> dict:
    """Model FLOPs of one training step on ``b x s`` tokens: ``6 * N * tokens``
    with N the parameters that enter a product (every parameter of rank >=
    2; a tied embedding counted once, as the unembedding), plus attention's
    two products, ``12 * B * H * head_dim * sum_q keys(q)`` per attention
    layer (forward 4, backward 8), keys(q) = min(q + 1, window) causal.
    Recomputation (remat) is not counted."""
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    dense = 6 * n * b * s
    attn = 0
    q = np.arange(s)
    for block in model.stack:
        if block.spec.kind != "attn":
            continue
        keys = q + 1 if block.spec.window is None else np.minimum(q + 1, block.spec.window)
        attn += 12 * b * cfg.n_heads * cfg.head_dim * int(keys.sum())
    return {"matmul_params": n, "dense_flops": dense, "attention_flops": attn,
            "flops": dense + attn,
            "formula": "6 * N * tokens + 12 * B * H * head_dim * sum_q min(q + 1, window) "
                       "per attention layer; N = parameters of rank >= 2"}


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def time_train_parts(model, state, batches) -> dict:
    """Each step by part with CUDA events, the first step a warm-up: the
    forward (``Model.loss`` with gradients on), forward + backward
    (``loss_and_grads``, remat's recompute included) and the whole
    ``train_step``; the backward and the optimizer (AdamW and the
    router-bias update) are the differences. Then one whole step under
    torch.profiler, and one checkpoint of the state: the blocking host copy
    and the write to disk (host clock)."""
    opt_cfg = train_opt.OptConfig(total_steps=100, warmup_steps=10)
    step = train_loop.make_train_step(model, opt_cfg)

    def forward(batch):
        with torch.enable_grad(), train_loop.bound_parameters(model, {
                n: p.detach().requires_grad_() for n, p in state["params"].items()}):
            return model.loss(batch)

    parts = {"forward": [], "forward_backward": [], "step": []}
    for i, batch in enumerate(batches):
        for name, fn in (("forward", lambda: forward(batch)),
                         ("forward_backward",
                          lambda: train_loop.loss_and_grads(model, state["params"], batch)),
                         ("step", lambda: step(state, batch))):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            result = fn()
            z.record()
            z.synchronize()
            if i:
                parts[name].append(a.elapsed_time(z))
            if name == "step":
                state = result[0]
            del result
    out = {f"{k}_ms": statistics.median(v) for k, v in parts.items()}
    out["backward_ms"] = out["forward_backward_ms"] - out["forward_ms"]
    out["optimizer_ms"] = out["step_ms"] - out["forward_backward_ms"]
    out["samples_ms"] = parts
    # one whole train step under the profiler: device busy ms, ops, idle share
    out["profile"] = profile_lm(lambda: step(state, batches[-1]), inference=False)
    ckpt_dir = OUT_DIR / "train_ckpt_timed"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = Checkpointer(str(ckpt_dir), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(1, state)
    t1 = time.perf_counter()
    ckpt.wait()
    t2 = time.perf_counter()
    out["checkpoint"] = {"host_copy_ms": (t1 - t0) * 1e3, "write_ms": (t2 - t1) * 1e3,
                         "bytes": _dir_bytes(ckpt_dir)}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def phase7_launcher(dev) -> dict:
    """7a: gemma3-1b whole (bf16, float32 moments) through ``launch/train.run``:
    B x S = TRAIN_B x TRAIN_S, TRAIN_STEPS steps, a checkpoint every
    TRAIN_CKPT_EVERY, a failure injected at TRAIN_FAIL_AT; then the step
    timed by part and the model-FLOP share of the card's dense bf16 peak."""
    cfg = get_config("gemma3-1b")
    total, _ = cfg.param_count()
    ckpt_dir = OUT_DIR / "train_ckpt"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    save_bytes = total * (2 + 4 + 4)  # bf16 parameters, float32 m and v
    free = shutil.disk_usage(OUT_DIR).free
    if free < 3.5 * save_bytes:  # two kept checkpoints and one being written
        raise AssertionError(f"7a needs about {3.5 * save_bytes / 1e9:.1f} GB of disk for its "
                             f"checkpoints; {free / 1e9:.1f} GB are free")
    argv = ["--arch", "gemma3-1b", "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--fail-at", str(TRAIN_FAIL_AT), "--ckpt-dir", str(ckpt_dir), "--log-every", "1",
            "--restart-delay", "0", "--seed", str(SEED), "--device", str(dev)]
    history, text = [], io.StringIO()
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Tee(sys.stdout, text)):
        rc = train_cli.run(train_cli.build_parser().parse_args(argv), history)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    printed = text.getvalue()
    saved = _dir_bytes(ckpt_dir / f"step_{TRAIN_STEPS}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = [s for s, *_ in history]
    want_steps = [*range(TRAIN_FAIL_AT), *range(TRAIN_CKPT_EVERY, TRAIN_STEPS)]
    for needle in (f"[supervisor] failure #1: RuntimeError: injected failure (test)",
                   f"[supervisor] resumed from step {TRAIN_CKPT_EVERY}",
                   "[supervisor] training complete"):
        if needle not in printed:
            raise AssertionError(f"7a: the launcher did not print {needle!r}")
    if rc != 0 or steps != want_steps or not all(math.isfinite(l) for _, l, _ in history):
        raise AssertionError(f"7a: exit {rc}, steps {steps} (want {want_steps}), {history}")
    out = {"argv": argv, "exit_code": rc, "seconds": seconds, "steps_run": steps,
           "losses": [l for _, l, _ in history], "grad_norms": [g for *_, g in history],
           "step3_first_and_resumed_loss": [history[TRAIN_CKPT_EVERY][1],
                                            history[TRAIN_FAIL_AT][1]],
           "max_memory_allocated_bytes": peak, "checkpoint_bytes": saved,
           "checkpoint_bytes_predicted": save_bytes, "disk_free_bytes_before": free}
    log(f"  7a launcher: exit {rc} in {seconds:.1f} s; steps {steps}; loss "
        f"{history[0][1]:.4f} -> {history[-1][1]:.4f}; step 3 {history[3][1]!r} first, "
        f"{history[4][1]!r} resumed; peak {peak / 1e9:.2f} GB; checkpoint {saved / 1e9:.2f} GB")
    # the step by part, on a fresh model (the launcher's is gone)
    _free()
    model = build_model(cfg, device=dev, rwkv_kernel=False, seed=SEED)
    state = train_loop.init_train_state(model, train_opt.OptConfig())
    data = make_source(DataConfig(vocab=cfg.vocab, global_batch=TRAIN_B, seq_len=TRAIN_S,
                                  seed=SEED))
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()}
               for i in range(1 + TRAIN_TIMED)]
    torch.cuda.reset_peak_memory_stats()
    timing = time_train_parts(model, state, batches)
    timing["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    flops = train_flops(model, TRAIN_B, TRAIN_S)
    timing["tokens_per_s"] = TRAIN_B * TRAIN_S / (timing["step_ms"] / 1e3)
    timing["model_flops"] = flops
    timing["achieved_flops_per_s"] = flops["flops"] / (timing["step_ms"] / 1e3)
    timing["peak_share"] = timing["achieved_flops_per_s"] / BF16_PEAK_FLOPS
    timing["parameters"] = sum(p.numel() for p in model.parameters())
    out["timing"] = timing
    c = timing["checkpoint"]
    log(f"  7a step, {TRAIN_B} x {TRAIN_S}: forward {timing['forward_ms']:.1f} + backward "
        f"{timing['backward_ms']:.1f} + optimizer {timing['optimizer_ms']:.1f} = "
        f"{timing['step_ms']:.1f} ms ({timing['tokens_per_s']:.0f} tokens/s), peak "
        f"{timing['max_memory_allocated_bytes'] / 1e9:.2f} GB; {flops['flops'] / 1e12:.2f} TFLOP "
        f"of model work = {timing['peak_share']:.3f} of {BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s; "
        f"checkpoint {c['bytes'] / 1e9:.2f} GB: host copy {c['host_copy_ms']:.0f} ms, write "
        f"{c['write_ms']:.0f} ms")
    prof = timing["profile"]
    log(f"  7a one step profiled: {prof['wall_ms']:.1f} ms wall, device busy "
        f"{prof['device_busy_ms']:.1f} ms over {prof['device_ops']} ops (idle "
        f"{prof['device_idle_share']:.3f}); largest: " + ", ".join(
            f"{name[:60]} {ms:.1f}" for name, ms in list(prof["top_device_ms"].items())[:6]))
    del model, state, batches
    _free()
    return out


def _batch(cfg, b: int, s: int, seed: int = SEED) -> dict:
    """A numpy batch from the seed: tokens, next-token labels and the
    frontend's input (whisper's frames, internvl2's patch embeddings)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["prefix_embeddings"] = rng.normal(
            size=(b, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


def _card_and_cpu(cfg, dev, batch, grads: bool) -> dict:
    """One ``make_train_step`` from the same weights and batch on the card and
    on the CPU; with ``grads``, both sides' gradients too."""
    cpu = build_model(cfg, device="cpu", rwkv_kernel=False, seed=SEED)
    gpu = build_model(cfg, device=dev, rwkv_kernel=False, seed=SEED)
    gpu.load_state_dict(cpu.state_dict())
    out = {}
    for side, model in (("cpu", cpu), ("gpu", gpu)):
        opt = train_opt.OptConfig()
        state = train_loop.init_train_state(model, opt)
        t0 = time.perf_counter()
        new, metrics = train_loop.make_train_step(model, opt)(state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        out[side] = {"loss": loss, "grad_norm": gnorm, "step_s": time.perf_counter() - t0,
                     "state": state, "new": new}
        if grads:
            out[side]["grads"] = train_loop.loss_and_grads(model, state["params"], batch)[2]
    for what, tol in (("loss", LOSS_RTOL), ("grad_norm", NORM_RTOL)):
        rel = abs(out["gpu"][what] - out["cpu"][what]) / abs(out["cpu"][what])
        out[f"{what}_rel_diff"] = rel
        if not rel <= tol:
            raise AssertionError(f"{cfg.name}: {what} {out['gpu'][what]} on the card against "
                                 f"{out['cpu'][what]} on the CPU (rel {rel:.3g}, limit {tol})")
    return out


def _hold_grads(cpu: dict, gpu: dict, what: str) -> dict:
    """Every gradient leaf: allclose(GRAD_RTOL, GRAD_ATOL * max |g|); counts
    the elements past GRAD_ATOL_TIGHT * max |g| and the largest difference
    over a leaf's largest gradient."""
    worst, past_tight, elements = 0.0, 0, 0
    for name, want in cpu.items():
        got = gpu[name].float().cpu()
        want = want.float()
        top = float(want.abs().max())
        diff = (got - want).abs()
        bound = GRAD_RTOL * want.abs()
        if not bool((diff <= bound + GRAD_ATOL * top).all()):
            raise AssertionError(f"{what}: gradient {name} differs by {float(diff.max()):.3g} "
                                 f"(largest |g| {top:.3g})")
        past_tight += int((diff > bound + GRAD_ATOL_TIGHT * top).sum())
        elements += want.numel()
        worst = max(worst, float(diff.max()) / top if top else 0.0)
    return {"leaves": len(cpu), "elements": elements, "max_diff_over_leaf_max": worst,
            "elements_past_1e-6_of_leaf_max": past_tight, "rtol": GRAD_RTOL,
            "atol_over_leaf_max": GRAD_ATOL}


def phase7_fp32_check(dev) -> dict:
    """7b: gemma3-1b cut to one period at full width, float32, one step on
    the card against the CPU (TF32 off): loss rel 1e-5, gradient norm rel
    1e-4, every gradient leaf held."""
    cfg = dataclasses.replace(get_config("gemma3-1b"), n_periods=1, param_dtype="float32",
                              compute_dtype="float32")
    t0 = time.perf_counter()
    legs = _card_and_cpu(cfg, dev, _batch(cfg, TRAIN_CHECK_B, TRAIN_CHECK_S), grads=True)
    held = _hold_grads(legs["cpu"]["grads"], legs["gpu"]["grads"], "7b gemma3-1b one period")
    out = {"batch": TRAIN_CHECK_B, "seq": TRAIN_CHECK_S, "layers": cfg.n_layers,
           "loss": legs["gpu"]["loss"], "cpu_loss": legs["cpu"]["loss"],
           "loss_rel_diff": legs["loss_rel_diff"], "grad_norm": legs["gpu"]["grad_norm"],
           "grad_norm_rel_diff": legs["grad_norm_rel_diff"], "grads": held,
           "seconds": time.perf_counter() - t0}
    log(f"  7b fp32 one period ({cfg.n_layers} layers), {TRAIN_CHECK_B} x {TRAIN_CHECK_S}: loss "
        f"{out['loss']:.7f} (CPU {out['cpu_loss']:.7f}, rel {out['loss_rel_diff']:.2g}), grad norm "
        f"rel {out['grad_norm_rel_diff']:.2g}; {held['leaves']} gradient leaves within "
        f"{held['max_diff_over_leaf_max']:.2g} of their largest |g| "
        f"({held['elements_past_1e-6_of_leaf_max']} of {held['elements']} elements past 1e-6)")
    del legs
    _free()
    return out


def phase7_moe(dev) -> dict:
    """7c: deepseek-moe-16b at full width cut to its dense prefix layer and
    one MoE layer (64 experts, top-6, 2 shared), bf16, q8 moments,
    MOE_MICROBATCHES microbatches, MOE_TRAIN_STEPS steps of TRAIN_B x
    TRAIN_S: step ms, tokens/s, peak memory, the dropped share; the loss
    finite and equal to cross-entropy + the switch load term."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_periods=1)
    _free()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=SEED)
    opt = train_opt.OptConfig(state_dtype="q8", total_steps=100, warmup_steps=10)
    state = train_loop.init_train_state(model, opt)
    step = train_loop.make_train_step(model, opt, microbatches=MOE_MICROBATCHES)
    data = make_source(DataConfig(vocab=cfg.vocab, global_batch=TRAIN_B, seq_len=TRAIN_S,
                                  seed=SEED))
    step_ms, losses = [], []
    for i in range(MOE_TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()}
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, metrics = step(state, batch)
        z.record()
        z.synchronize()
        step_ms.append(a.elapsed_time(z))
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"7c: losses {losses}")
    # one microbatch forward at the trained weights: the loads, the drops and
    # the switch term inside the loss
    mb = {k: v[: TRAIN_B // MOE_MICROBATCHES] for k, v in batch.items()}
    t = mb["tokens"].numel()
    with torch.no_grad(), train_loop.bound_parameters(model, state["params"]):
        total, aux = model.loss(mb)
        pos = torch.arange(TRAIN_S, device=dev).expand(mb["tokens"].shape)
        h, _, _ = model(mb["tokens"].long(), pos)
        ce = lm_model.cross_entropy(model._unembed(h), mb["labels"].long())
    load = aux["moe_load"]
    frac = load / load.sum()
    switch = float(1e-2 * cfg.n_experts * (frac * frac).sum())
    total, ce = float(total), float(ce)
    if not (switch > 0 and abs(total - (ce + switch)) <= 1e-5 * abs(total)):
        raise AssertionError(f"7c: loss {total} is not cross-entropy {ce} + switch {switch}")
    cap = moe_ops.expert_capacity(cfg, t)
    dropped = int((load - cap).clamp_min(0).sum())
    assigned = int(load.sum())
    steady = statistics.median(step_ms[1:])
    out = {"layers": cfg.n_layers, "parameters": sum(p.numel() for p in model.parameters()),
           "state_dtype": "q8", "microbatches": MOE_MICROBATCHES, "batch": TRAIN_B,
           "seq": TRAIN_S, "step_ms": step_ms, "steady_step_ms": steady,
           "tokens_per_s": TRAIN_B * TRAIN_S / (steady / 1e3), "losses": losses,
           "max_memory_allocated_bytes": peak, "tokens_per_microbatch": t,
           "capacity": cap, "assignments": assigned, "dropped": dropped,
           "dropped_share": dropped / assigned, "loss_microbatch": total, "cross_entropy": ce,
           "switch_term": switch}
    log(f"  7c deepseek-moe-16b, {cfg.n_layers} layers ({out['parameters'] / 1e9:.2f} B), q8, "
        f"{MOE_MICROBATCHES} microbatches of {TRAIN_B // MOE_MICROBATCHES} x {TRAIN_S}: steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms ({out['tokens_per_s']:.0f} tokens/s), peak "
        f"{peak / 1e9:.2f} GB; losses {', '.join(f'{x:.4f}' for x in losses)}; {dropped} of "
        f"{assigned} assignments dropped at capacity {cap} ({dropped / assigned:.4f}); switch "
        f"term {switch:.5f} inside the loss")
    del model, state, step
    _free()
    return out


def phase7_archs(dev) -> dict:
    """7d: every arch's smoke config in float32, one step on the card against
    the CPU: loss rel 1e-5, gradient norm rel 1e-4; deepseek-v3's
    ``router_bias`` moves by exactly +-u or 0 per period, as on the CPU."""
    out = {}
    u = float(torch.tensor(ROUTER_U))
    for arch in sorted(ARCHS):
        cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="float32",
                                  compute_dtype="float32")
        legs = _card_and_cpu(cfg, dev, _batch(cfg, ARCH_B, ARCH_S), grads=False)
        out[arch] = {"loss": legs["gpu"]["loss"], "loss_rel_diff": legs["loss_rel_diff"],
                     "grad_norm": legs["gpu"]["grad_norm"],
                     "grad_norm_rel_diff": legs["grad_norm_rel_diff"]}
        if arch == "deepseek-v3-671b":
            moves = []
            for period in range(cfg.n_periods):
                name = f"stack.{len(cfg.prefix_layers) + period}.ffn.router_bias"
                by_side = {side: (legs[side]["new"]["params"][name]
                                  - legs[side]["state"]["params"][name]).cpu()
                           for side in ("cpu", "gpu")}
                if not (set(by_side["gpu"].tolist()) <= {-u, 0.0, u}
                        and torch.equal(by_side["gpu"], by_side["cpu"])):
                    raise AssertionError(f"7d deepseek-v3: period {period}'s router_bias moved "
                                         f"by {by_side}")
                moves.append([int((by_side["gpu"] > 0).sum()), int((by_side["gpu"] == 0).sum()),
                               int((by_side["gpu"] < 0).sum())])
            out[arch]["router_bias_up_zero_down_per_period"] = moves
        del legs
    _free()
    log("  7d smoke configs, fp32, card against CPU: " + "; ".join(
        f"{a} loss {v['loss']:.5f} (rel {v['loss_rel_diff']:.1g}), norm rel "
        f"{v['grad_norm_rel_diff']:.1g}" for a, v in out.items()))
    log(f"  7d deepseek-v3 router_bias up / unchanged / down per period: "
        f"{out['deepseek-v3-671b']['router_bias_up_zero_down_per_period']} (+-{ROUTER_U})")
    return out


def phase7_refusal(dev) -> dict:
    """7e: ``rwkv6_chunk`` (no backward) raises on CUDA inputs that require
    gradients, before it launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, t, h, p = 2, 16, 4, 16
    r, k, v = (torch.randn((b, t, h, p), generator=gen, device=dev) for _ in range(3))
    log_w = -torch.rand((b, t, h, p), generator=gen, device=dev) - 0.01
    u = torch.randn((h, p), generator=gen, device=dev)
    s0 = torch.zeros((b, h, p, p), device=dev)
    refused = []
    for i, name in enumerate(("r", "k", "v", "log_w", "u", "s0")):
        args = [x.detach().requires_grad_(j == i) for j, x in enumerate((r, k, v, log_w, u, s0))]
        try:
            rwkv_ops.rwkv6_chunk(*args)
        except RuntimeError as e:
            if "no backward" in str(e):
                refused.append(name)
    if len(refused) != 6:
        raise AssertionError(f"7e: rwkv6_chunk refused only {refused}")
    log(f"  7e rwkv6_chunk refuses CUDA inputs that require grad: {refused}")
    return {"refused_inputs": refused}


def phase_train(dev) -> dict[str, int]:
    """Phase 7: the launch counts set to 0 just before and read just after.
    No Pallas kernel lies on the training path (repro trains RWKV-6 on its
    plain chunked core), so it must launch none of the port's kernels."""
    t0 = time.perf_counter()
    _reset_counts()
    out = {"card": torch.cuda.get_device_name(0)}
    for name, fn in (("7a_launcher", phase7_launcher), ("7b_fp32_check", phase7_fp32_check),
                     ("7c_moe", phase7_moe), ("7d_archs", phase7_archs),
                     ("7e_refusal", phase7_refusal)):
        t1 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["phase_seconds"] = time.perf_counter() - t1
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"training phase launched {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_train.json").write_text(json.dumps(out, indent=1))
    log(f"training phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v['phase_seconds']:.1f}" for k, v in out.items() if isinstance(v, dict)
        and "phase_seconds" in v) + f"), launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 8: expert parallel (the sharded MoE, the sharding rules, re-meshing
# and the hierarchical collectives) over meshes of this one card
# ---------------------------------------------------------------------------
EP_MESH = ((2, 4), ("data", "model"))  # 8 cells of the card: EP over both axes
EP_CHECK_B, EP_CHECK_S = 2, 512  # 8a: prefill layout held against moe_local
REMESHES = {"2x16x16": ((2, 16, 16), ("pod", "data", "model")),
            "16x16": ((16, 16), ("data", "model"))}
ALLREDUCE_BYTES = 64 << 20  # 8d: one float32 gradient per cell
ALLREDUCE_TOL = 1e-6  # 8d: of the largest sum; 8 float32 terms added in two orders


def _cells_of(dev, shape) -> list[torch.device]:
    """``dev`` (with its index: ``cuda`` is ``cuda:0``) once per cell."""
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * math.prod(shape)


def _ep_mesh(dev, shape=EP_MESH[0], axes=EP_MESH[1]):
    return make_mesh(shape, axes, devices=_cells_of(dev, shape))


def _no_drop_cfg(cfg):
    """``cfg`` at a capacity factor at which no expert and no shard can drop
    (``ceil(E / k)``: every capacity reaches the tokens it could receive)."""
    return dataclasses.replace(cfg, capacity_factor=float(math.ceil(cfg.n_experts / cfg.top_k)))


def ep_buffer_bytes(cfg, t_cell: int, mesh) -> int:
    """The bytes of the sharded dispatch's buffers at ``t_cell`` tokens per
    cell, summed over the cells: the packed payload, what the exchange
    delivers, each shard's expert buffer, its results and what comes back
    (``[tp, cap_send, D]`` three times, ``[E / tp, cap_recv, D]`` twice) in
    the activations' dtype, and the expert FFN's gate, up and product
    (``[E / tp, cap_recv, moe_d_ff]``) of one cell at a time."""
    tp = mesh.axes_size(moe_ops.ep_axes_for(cfg, mesh))
    e_local, k, d = cfg.n_experts // tp, cfg.top_k, cfg.d_model
    cap_send = max(8, int(t_cell * k / tp * cfg.capacity_factor))
    cap_recv = max(8, int(t_cell * k / e_local * cfg.capacity_factor))
    size = lm_layers.dt(cfg.param_dtype).itemsize
    per_cell = (3 * tp * cap_send * d + 2 * e_local * cap_recv * d) * size
    return mesh.size * per_cell + 3 * e_local * cap_recv * cfg.moe_d_ff * size


def _dropped_share(cfg, load: torch.Tensor, t: int) -> float:
    """moe_local's dropped share: each expert keeps the first ``cap`` of its
    assignments."""
    cap = moe_ops.expert_capacity(cfg, t)
    return float((load - cap).clamp_min(0).sum()) / (t * cfg.top_k)


def check_ep_layer(dev) -> dict:
    """8a: one deepseek-v3-671b MoE layer at full width (256 experts of
    7168 -> 2048 -> 7168, top-8, aux-free router, bf16), EP over the (2, 4)
    mesh's ("data", "model"), 32 experts per cell. At a capacity factor at
    which nothing drops, moe_block_sharded against moe_local on the same
    weights and tokens, in prefill layout (2 x 512) and decode layout
    (8 x 1): y within STREAM_TOL of the largest output, loads equal. Then
    both timed (CUDA events) at 8 x 512 and 8 x 1 under the config's own
    capacity factor, with each one's dropped share."""
    cfg = get_config("deepseek-v3-671b")
    nofill = _no_drop_cfg(cfg)
    mesh = _ep_mesh(dev)
    _free()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer = moe_ops.MoE(cfg, lm_layers.dt(cfg.param_dtype), dev, gen)
    expert_bytes = _nbytes(*(getattr(layer, n) for n in moe_ops.EXPERT_PARAMS))
    out = {"experts": cfg.n_experts, "top_k": cfg.top_k, "d_model": cfg.d_model,
           "moe_d_ff": cfg.moe_d_ff, "mesh": list(EP_MESH[0]), "axes": list(EP_MESH[1]),
           "ep_axes": list(moe_ops.ep_axes_for(cfg, mesh)), "expert_bytes": expert_bytes}
    log(f"  8a deepseek-v3-671b MoE layer, experts {expert_bytes / 1e9:.2f} GB bf16, EP over "
        f"{out['ep_axes']} of a {EP_MESH[0]} mesh of {dev} ({cfg.n_experts // mesh.size} experts "
        f"per cell)")
    with torch.inference_mode():
        for what, (b, s) in (("prefill", (EP_CHECK_B, EP_CHECK_S)), ("decode", (LM_BATCH, 1))):
            x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(layer.wi_up.dtype)
            # tokens per cell: prefill cuts them over every cell; decode over
            # "data" only (replicated over "model")
            t_cell = b * s // (mesh.size if s > 1 else mesh.shape["data"])
            reckoned = ep_buffer_bytes(nofill, t_cell, mesh)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            y, aux = moe_ops.moe_block_sharded(layer, x, nofill, mesh)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ref, ref_aux = moe_ops.moe_local(layer, x.reshape(b * s, -1), nofill)
            if not torch.equal(aux["load"], ref_aux["load"]):
                raise AssertionError(f"8a {what}: the sharded and local loads differ")
            if int(aux["dispatched"]) != b * s * cfg.top_k:
                raise AssertionError(f"8a {what}: {int(aux['dispatched'])} of "
                                     f"{b * s * cfg.top_k} assignments reached an expert")
            err = _hold_rel(y, ref.reshape(b, s, -1), STREAM_TOL,
                            f"8a {what}: moe_block_sharded against moe_local")
            out[f"check_{what}"] = {"batch": b, "seq": s, "capacity_factor": nofill.capacity_factor,
                                    "max_rel_err": err, "tol": STREAM_TOL, "loads_equal": True,
                                    "reckoned_buffer_bytes": reckoned,
                                    "measured_peak_bytes": peak}
            log(f"  8a {what} {b} x {s}, capacity factor {nofill.capacity_factor} (no drops): "
                f"sharded within {err:.3g} of moe_local (limit {STREAM_TOL}), loads equal; "
                f"buffers reckoned {reckoned / 1e9:.2f} GB, measured peak "
                f"{peak / 1e9:.2f} GB over the weights")
            del x, y, ref
            _free()
        for what, (b, s) in (("prefill", (LM_BATCH, LM_PROMPT)), ("decode", (LM_BATCH, 1))):
            x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(layer.wi_up.dtype)
            flat = x.reshape(b * s, -1)
            sharded_ms = time_ms(lambda: moe_ops.moe_block_sharded(layer, x, cfg, mesh),
                                 repeats=5, inner=2)
            local_ms = time_ms(lambda: moe_ops.moe_local(layer, flat, cfg), repeats=5, inner=2)
            _, aux = moe_ops.moe_block_sharded(layer, x, cfg, mesh)
            _, laux = moe_ops.moe_local(layer, flat, cfg)
            assigned = b * s * cfg.top_k
            row = {"batch": b, "seq": s, "capacity_factor": cfg.capacity_factor,
                   "sharded_ms": sharded_ms, "local_ms": local_ms,
                   "sharded_dropped_share": 1 - float(aux["dispatched"]) / assigned,
                   "local_dropped_share": _dropped_share(cfg, laux["load"], b * s)}
            out[f"timed_{what}"] = row
            log(f"  8a {what} {b} x {s} at capacity factor {cfg.capacity_factor}: sharded "
                f"{sharded_ms:.3f} ms ({row['sharded_dropped_share']:.4f} dropped), moe_local "
                f"{local_ms:.3f} ms ({row['local_dropped_share']:.4f} dropped)")
            del x, flat
    del layer
    _free()
    return out


def _set_moe_impl(model, impl: str) -> None:
    """Every block of ``model`` dispatches as ``impl`` says (the same weights)."""
    model.moe_impl = impl
    for block in model.stack:
        block.moe_impl = impl


@contextlib.contextmanager
def _counted_dispatch():
    """Records (tokens, assignments, assignments that reached an expert) of
    every moe_block_sharded call while it is open, the counts as device
    tensors (no wait for the device)."""
    seen: list[tuple] = []
    real = moe_ops.moe_block_sharded

    def counted(params, x3, cfg, mesh, *args, **kwargs):
        y, aux = real(params, x3, cfg, mesh, *args, **kwargs)
        seen.append((x3.shape[0] * x3.shape[1], aux["load"].sum(), aux["dispatched"]))
        return y, aux

    moe_ops.moe_block_sharded = counted
    try:
        yield seen
    finally:
        moe_ops.moe_block_sharded = real


def _sharded_drops(seen, prefill_tokens: int) -> dict:
    """The sharded dispatch's dropped share in the prefills and in the
    decode steps of ``seen``: the assignments that did not reach an expert
    (a full send buffer or a full expert)."""
    out = {}
    for what, rows in (("prefill", [r for r in seen if r[0] == prefill_tokens]),
                       ("decode", [r for r in seen if r[0] != prefill_tokens])):
        assigned = float(sum(r[1] for r in rows))
        dispatched = float(sum(r[2] for r in rows))
        out[what] = {"calls": len(rows), "assignments": assigned, "dispatched": dispatched,
                     "dropped_share": 1 - dispatched / assigned}
    return out


def phase8_deepseek_moe(dev) -> dict:
    """8b: deepseek-moe-16b whole (bf16) built with moe_impl="sharded" on the
    (2, 4) mesh: serves 8 x 512 + 32 through Engine.generate; prefill and
    decode timed with the sharded dispatch and, on the same weights, with
    moe_local, with each one's dropped share. Then phase 5a's float32 cut
    (the prefix layer + one MoE layer, no-drop capacity factor): sharded
    prefill + 8 decode steps against its own full forward, the sharded full
    forward against the local one (FP32_TOL of the largest logit), and one
    train step of 2 x 512 with loss and gradient norm against local
    (LOSS_RTOL, NORM_RTOL)."""
    cfg = get_config("deepseek-moe-16b")
    mesh = _ep_mesh(dev)
    _free()
    torch.cuda.reset_peak_memory_stats()
    model, init_ms = _timed(lambda: build_model(cfg, device=dev, seed=SEED, moe_impl="sharded",
                                                mesh=mesh))
    prompts_np = np.random.default_rng(SEED).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT))
    prompts = torch.as_tensor(prompts_np, device=dev)
    engine = Engine(model, ServeConfig(max_len=LM_PROMPT + LM_NEW))
    tokens, gen_ms = _timed(lambda: engine.generate(prompts_np, LM_NEW))
    if tokens.shape != (LM_BATCH, LM_NEW) or int(tokens.min()) < 0 or \
            int(tokens.max()) >= cfg.vocab:
        raise AssertionError(f"8b generate: tokens of shape {tuple(tokens.shape)}")
    out = {"layers": cfg.n_layers, "init_ms": init_ms, "generate_ms": gen_ms,
           "mesh": list(EP_MESH[0]), "ep_axes": list(moe_ops.ep_axes_for(cfg, mesh))}
    with _counted_dispatch() as seen:
        out["sharded"], _ = time_prefill_decode(model, prompts, tokens, LM_PROMPT + LM_NEW,
                                                profile=False)
    out["sharded"]["routing"] = _sharded_drops(seen, LM_BATCH * LM_PROMPT)
    _set_moe_impl(model, "local")
    out["local"], _ = time_prefill_decode(model, prompts, tokens, LM_PROMPT + LM_NEW,
                                          profile=False)
    with contextlib.redirect_stdout(io.StringIO()):
        out["local"]["routing"] = moe_routing(model, cfg, prompts, tokens)
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for impl in ("sharded", "local"):
        r = out[impl]
        pf, dc = r["routing"]["prefill"], r["routing"]["decode"]
        log(f"  8b deepseek-moe-16b, {impl} dispatch: prefill {r['prefill_ms']:.2f} ms "
            f"({r['prefill_tokens_per_s']:.0f} tokens/s), decode {r['decode_ms_per_step']:.2f} "
            f"ms/step; dropped {pf['dropped_share']:.4f} in prefill, {dc['dropped_share']:.4f} "
            f"in decode")
    log(f"  8b generate {LM_BATCH} x {LM_PROMPT} + {LM_NEW} sharded: {gen_ms:.1f} ms; peak "
        f"{out['max_memory_allocated_gb']:.2f} GB")
    del model, engine
    _free()

    cfg32 = dataclasses.replace(_no_drop_cfg(cfg), n_periods=1, param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(cfg32, device=dev, seed=SEED, moe_impl="sharded", mesh=mesh)
    rng = np.random.default_rng(SEED)
    p32 = torch.as_tensor(rng.integers(0, cfg.vocab, (2, LM_PROMPT)), device=dev)
    t32 = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)), device=dev)
    out["fp32_cut"] = check_against_full(model, p32, t32, None, FP32_TOL,
                                         "8b deepseek-moe-16b fp32 cut, sharded")
    seq = torch.cat([p32, t32], 1)
    pos = torch.arange(seq.shape[1], device=dev).expand(seq.shape)
    with torch.inference_mode():
        full = {}
        for impl in ("sharded", "local"):
            _set_moe_impl(model, impl)
            h, _, _ = model(seq, pos)
            full[impl] = model._unembed(h)
    out["fp32_cut"]["sharded_vs_local_rel_err"] = _hold_rel(
        full["sharded"], full["local"], FP32_TOL, "8b fp32 cut: sharded against local logits")
    del full, h
    batch = _batch(cfg32, 2, LM_PROMPT)
    opt = train_opt.OptConfig()
    state = train_loop.init_train_state(model, opt)
    steps = {}
    for impl in ("sharded", "local"):
        _set_moe_impl(model, impl)
        _, metrics = train_loop.make_train_step(model, opt)(state, batch)
        steps[impl] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
        del metrics
        _free()
    for what, tol in (("loss", LOSS_RTOL), ("grad_norm", NORM_RTOL)):
        rel = abs(steps["sharded"][what] - steps["local"][what]) / abs(steps["local"][what])
        steps[f"{what}_rel_diff"] = rel
        if not rel <= tol:
            raise AssertionError(f"8b train step: {what} {steps['sharded'][what]} sharded "
                                 f"against {steps['local'][what]} local (rel {rel:.3g})")
    out["fp32_train_step"] = steps
    log(f"  8b fp32 cut (prefix + 1 MoE layer, capacity factor {cfg32.capacity_factor}): sharded "
        f"prefill + 8 decode steps within {out['fp32_cut']['max_rel_err']:.3g} of its full "
        f"forward, sharded full forward within {out['fp32_cut']['sharded_vs_local_rel_err']:.3g} "
        f"of local (limit {FP32_TOL}); train step 2 x {LM_PROMPT}: loss "
        f"{steps['sharded']['loss']:.6f} (rel {steps['loss_rel_diff']:.2g}), grad norm "
        f"{steps['sharded']['grad_norm']:.5f} (rel {steps['grad_norm_rel_diff']:.2g})")
    del model, state
    _free()
    return out


def phase8_remesh(dev) -> dict:
    """8c: remesh_pspecs for the ten full configs (shapes from models built
    on the meta device, nothing allocated) on (2, 16, 16) and (16, 16)
    meshes of the card, every spec checked against its shape; the sharded
    leaves counted per arch. Then gemma3-1b's whole train state (bf16
    parameters, float32 moments, after one step of 2 x 64) re-placed on the
    (2, 4) mesh by reshard_state from the card and from host memory, timed,
    every value bit-equal and ``step`` kept."""
    meshes = {name: make_mesh(shape, axes, devices=_cells_of(dev, shape))
              for name, (shape, axes) in REMESHES.items()}
    out = {"archs": {}}
    for arch in sorted(ARCHS):
        model = build_model(get_config(arch), device="meta")
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        row = {"leaves": len(shapes)}
        for name, mesh in meshes.items():
            t0 = time.perf_counter()
            specs = remesh_pspecs(model, shapes, mesh)
            row[f"ms_{name}"] = (time.perf_counter() - t0) * 1e3
            for leaf, spec in specs.items():
                NamedSharding(mesh, spec).check(shapes[leaf])
            row[f"sharded_{name}"] = sum(any(e is not None for e in sp) for sp in specs.values())
        out["archs"][arch] = row
        del model
    log("  8c remesh_pspecs, sharded leaves of all (2x16x16 / 16x16): " + "; ".join(
        f"{a} {r['sharded_2x16x16']} / {r['sharded_16x16']} of {r['leaves']}"
        for a, r in out["archs"].items()))
    cfg = get_config("gemma3-1b")
    _free()
    model = build_model(cfg, device=dev, seed=SEED)
    opt = train_opt.OptConfig()
    state, _ = train_loop.make_train_step(model, opt)(train_loop.init_train_state(model, opt),
                                                     _batch(cfg, 2, 64))
    del model
    mesh = _ep_mesh(dev)
    shapes = {n: tuple(p.shape) for n, p in state["params"].items()}
    pspecs = remesh_pspecs(build_model(cfg, device="meta"), shapes, mesh)
    host = tree_map(lambda t: t.cpu(), state)  # as a checkpoint restores it
    state_bytes = _tree_bytes(state)
    res = {"state_bytes": state_bytes,
           "sharded_leaves": sum(any(e is not None for e in sp) for sp in pspecs.values())}
    for where, src in (("card", state), ("host", host)):
        placed, ms = _timed(lambda src=src: reshard_state(src, pspecs, mesh))
        res[f"ms_from_{where}"] = ms
        for name, want in state["params"].items():
            if not torch.equal(placed["params"][name], want) or \
                    placed["params"][name].device != mesh.home:
                raise AssertionError(f"8c reshard_state from the {where}: {name} moved")
        for moment in ("m", "v"):
            for name, want in state["opt"][moment].items():
                if not torch.equal(placed["opt"][moment][name], want):
                    raise AssertionError(f"8c reshard_state from the {where}: {moment} {name}")
        if not int(placed["opt"]["step"]) == int(state["opt"]["step"]) == 1:
            raise AssertionError(f"8c reshard_state from the {where}: step changed")
        del placed
    out["reshard_state_gemma3_1b"] = res
    log(f"  8c reshard_state, gemma3-1b train state ({state_bytes / 1e9:.2f} GB, "
        f"{res['sharded_leaves']} of {len(pspecs)} parameters sharded on {EP_MESH[0]}): "
        f"{res['ms_from_card']:.2f} ms from the card, {res['ms_from_host']:.1f} ms from host "
        f"memory; every value bit-equal")
    del state, host
    _free()
    return out


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return _nbytes(tree)


def phase8_collectives(dev) -> dict:
    """8d: hierarchical_all_reduce (reduce-scatter over data, sum over pod,
    all-gather) against flat_all_reduce over a (2, 4) ("pod", "data") mesh
    of the card, a 64 MB float32 gradient per cell: the largest difference
    (within ALLREDUCE_TOL of the largest sum) and the ms of each (CUDA
    events)."""
    mesh = _ep_mesh(dev, (2, 4), ("pod", "data"))
    n = ALLREDUCE_BYTES // 4
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = {cell: torch.randn(n, generator=gen, device=dev) for cell in mesh.cells()}
    hier = ep_coll.hierarchical_all_reduce(mesh, x, "data", "pod")
    flat = ep_coll.flat_all_reduce(mesh, x, ("pod", "data"))
    worst = max(float((hier[c] - flat[c]).abs().max()) for c in mesh.cells())
    rel = max(_hold_rel(hier[c], flat[c], ALLREDUCE_TOL, "8d hierarchical against flat")
              for c in mesh.cells())
    del hier, flat
    out = {"bytes_per_cell": ALLREDUCE_BYTES, "cells": mesh.size, "max_abs_diff": worst,
           "max_rel_diff": rel, "tol": ALLREDUCE_TOL,
           "hierarchical_ms": time_ms(lambda: ep_coll.hierarchical_all_reduce(mesh, x, "data",
                                                                              "pod"),
                                      repeats=5, inner=2),
           "flat_ms": time_ms(lambda: ep_coll.flat_all_reduce(mesh, x, ("pod", "data")),
                              repeats=5, inner=2),
           "cross_pod_bytes_hierarchical": ep_coll.all_reduce_cross_pod_bytes(
               ALLREDUCE_BYTES, 2, 4, True),
           "cross_pod_bytes_flat": ep_coll.all_reduce_cross_pod_bytes(ALLREDUCE_BYTES, 2, 4,
                                                                      False)}
    log(f"  8d all-reduce of {ALLREDUCE_BYTES >> 20} MB float32 per cell over (2, 4) (pod, data): "
        f"hierarchical {out['hierarchical_ms']:.3f} ms, flat {out['flat_ms']:.3f} ms, largest "
        f"difference {worst:.3g} ({rel:.3g} of the largest sum, limit {ALLREDUCE_TOL})")
    del x
    _free()
    return out


def phase_expert_parallel(dev) -> dict[str, int]:
    """Phase 8: the launch counts set to 0 just before and read just after.
    No Pallas kernel lies on this path (repro computes the sharded MoE and
    the collectives in plain jnp), so it must launch none of the port's
    kernels."""
    t0 = time.perf_counter()
    _reset_counts()
    out = {"card": torch.cuda.get_device_name(0)}
    for name, fn in (("8a_layer", check_ep_layer), ("8b_deepseek_moe", phase8_deepseek_moe),
                     ("8c_remesh", phase8_remesh), ("8d_collectives", phase8_collectives)):
        t1 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["phase_seconds"] = time.perf_counter() - t1
    counts = _read_counts()
    if any(counts.values()):
        raise AssertionError(f"expert-parallel phase launched {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_expert_parallel.json").write_text(json.dumps(out, indent=1))
    log(f"expert-parallel phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k} {v['phase_seconds']:.1f}" for k, v in out.items() if isinstance(v, dict)
        and "phase_seconds" in v) + f"), launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 9: the dry run (launch/dryrun.py) checked against the card
# ---------------------------------------------------------------------------
DRY_CASES = (  # 9a: (what, arch, shape, mesh shape); the step counted on cuda:0 and meta
    ("gemma3-1b train", "gemma3-1b", Shape("train_512", 512, 8, "train"), (1, 1)),
    ("rwkv6-3b prefill", "rwkv6-3b", Shape("prefill_512", 512, 8, "prefill"), (1, 1)),
    ("deepseek-moe-16b sharded prefill", "deepseek-moe-16b",
     Shape("prefill_512", 512, 8, "prefill"), EP_MESH[0]),
)
DRY_SWEEP = ([(arch, "decode_32k", False) for arch in ARCHS]  # 9c: meta cells
             + [("gemma3-1b", "train_4k", True), ("deepseek-v3-671b", "train_4k", True)])


def _step_bound_ms(summary: dict) -> tuple[float, float]:
    """(compute, memory) ms of the counted work against the data-sheet peaks
    the dry run uses; all of it on one card."""
    compute = sum(f / dryrun.PEAK_FLOPS.get(k, dryrun.PEAK_FLOPS["float32"])
                  for k, f in summary["flops"].items())
    return compute * 1e3, sum(summary["bytes"].values()) / dryrun.HBM_BW * 1e3


def _time_step(cell, repeats: int = 3) -> dict:
    """The cell's step without the counter: CUDA-event ms and host ms after
    synchronize, the median of ``repeats`` (the counted run warmed it up)."""
    dev_ms, host_ms = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = cell.step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
        del out
    return {"event_ms": statistics.median(dev_ms), "host_ms": statistics.median(host_ms),
            "event_ms_samples": dev_ms}


def check_dry_counts(dev, smi: str) -> dict:
    """9a: each case's step counted on the meta device (the dry run) and on
    the card must give the same FLOPs by dtype, bytes by class and
    collective bytes by kind; then the card's step timed without the
    counter, beside the dry run's bound (the larger of compute and memory)."""
    out = {}
    opt = train_opt.OptConfig(state_dtype="float32")
    for what, arch, shape, mesh_shape in DRY_CASES:
        cfg = get_config(arch)
        n = math.prod(mesh_shape)
        t0 = time.perf_counter()
        meta_mesh = make_mesh(mesh_shape, EP_MESH[1], devices=["meta"] * n)
        meta = dryrun.count(dryrun.build_cell(cfg, shape, meta_mesh, opt)).summary()
        meta_s = time.perf_counter() - t0
        cell = dryrun.build_cell(cfg, shape, make_mesh(mesh_shape, EP_MESH[1],
                                                      devices=_cells_of(dev, mesh_shape)), opt)
        t1 = time.perf_counter()
        before = _read_counts()
        card = dryrun.count(cell).summary()
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        launched = {k: v - before[k] for k, v in _read_counts().items()}
        if card != meta:
            raise AssertionError(f"9a {what}: the card counted {card}, the meta device {meta}")
        timing = _time_step(cell)
        compute_ms, memory_ms = _step_bound_ms(meta)
        bound_ms = max(compute_ms, memory_ms)
        out[what] = {"counts": meta, "meta_seconds": meta_s, "counted_card_seconds": card_s,
                     "launches_in_counted_step": launched, **timing,
                     "bound_compute_ms": compute_ms, "bound_memory_ms": memory_ms,
                     "bound_ms": bound_ms, "share_of_bound": bound_ms / timing["event_ms"],
                     "card": smi}
        flops = sum(meta["flops"].values())
        log(f"9a {what}: card and meta counts equal ({flops / 1e12:.3f} TFLOP "
            f"{ {k: f'{v / 1e12:.3f}' for k, v in meta['flops'].items()} }, "
            f"{sum(meta['bytes'].values()) / 1e9:.2f} GB "
            f"{ {k: f'{v / 1e9:.2f}' for k, v in meta['bytes'].items()} }, collectives "
            f"{meta['collective']['total'] / 1e6:.2f} MB); step {timing['event_ms']:.1f} ms "
            f"(host {timing['host_ms']:.1f}), bound {bound_ms:.2f} ms "
            f"(compute {compute_ms:.2f}, memory {memory_ms:.2f}): share "
            f"{bound_ms / timing['event_ms']:.4f}; {smi}; meta {meta_s:.1f} s, counted "
            f"card step {card_s:.1f} s, kernels {launched}")
        del cell
        _free()
    return out


def _requested() -> int:
    """The bytes the caching allocator has been asked for and holds (exact;
    ``memory_allocated`` counts its rounded blocks and whole segments)."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def check_dry_memory(dev) -> dict:
    """9b: gemma3-1b's one-cell train state, 8 x 512, float32 moments: the
    dry run's argument bytes equal the card's tensors' bytes and the growth
    of the allocator's requested bytes as they are placed (the growth of
    ``memory_allocated()``, in the allocator's blocks, beside it). The temp
    estimate against ``max_memory_allocated()`` over the step."""
    _free()
    cfg = get_config("gemma3-1b")
    shape = DRY_CASES[0][2]
    opt = train_opt.OptConfig(state_dtype="float32")
    rec = dryrun.run_cell("gemma3-1b", shape, False, opt_cfg=opt, save=False, cfg=cfg,
                          mesh=make_mesh((1, 1), EP_MESH[1], devices=["meta"]))
    reckoned = rec["memory"]["argument_size_in_bytes"]
    base, base_requested = torch.cuda.memory_allocated(), _requested()
    cell = dryrun.build_cell(cfg, shape, make_mesh((1, 1), EP_MESH[1],
                                                  devices=_cells_of(dev, (1, 1))), opt)
    grown, requested = torch.cuda.memory_allocated() - base, _requested() - base_requested
    tensors = _leaves(cell.args)
    exact = sum(t.numel() * t.element_size() for t in tensors)
    if not reckoned == exact == requested:
        raise AssertionError(f"9b: reckoned {reckoned} argument bytes, the card's tensors hold "
                             f"{exact}, the allocator's requested bytes grew {requested}")
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    out = cell.step()
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - at_start
    del out, cell
    _free()
    ratio = rec["memory"]["temp_size_in_bytes"] / temp
    log(f"9b gemma3-1b one-cell train state: argument bytes reckoned {reckoned} = the card's "
        f"{len(tensors)} tensors = the allocator's requested growth ({grown} in its blocks, "
        f"memory_allocated); temp estimate {rec['memory']['temp_size_in_bytes'] / 1e9:.2f} GB "
        f"against {temp / 1e9:.2f} GB peak over the step (ratio {ratio:.3f})")
    return {"argument_size_in_bytes": reckoned, "requested_growth_bytes": requested,
            "allocated_growth_bytes": grown, "tensors": len(tensors),
            "temp_estimate_bytes": rec["memory"]["temp_size_in_bytes"],
            "step_peak_over_arguments_bytes": temp, "temp_ratio": ratio, "record": rec}


def _leaves(tree) -> list[torch.Tensor]:
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor) else None, tree)
    return out


def check_dry_sweep() -> dict:
    """9c: the meta dry run of every arch's decode_32k on (16, 16) and
    gemma3-1b's and deepseek-v3-671b's train_4k on (2, 16, 16)."""
    shapes = {s.name: s for s in SHAPES}
    out = {}
    for arch, shape, multi in DRY_SWEEP:
        r = dryrun.run_cell(arch, shapes[shape], multi, save=False)
        rf, mem = r["roofline"], r["memory"]
        out[f"{arch}__{shape}__{r['mesh']}"] = r
        log(f"9c {arch} x {shape} x {r['mesh']} ({r['n_chips']} cells): {r['seconds']:.1f} s; "
            f"per device {r['cost']['flops_per_device'] / 1e12:.3f} TFLOP, "
            f"{r['cost']['bytes_per_device'] / 1e9:.3f} GB, collectives "
            f"{r['collective_bytes_per_device']['total'] / 1e6:.2f} MB; arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.2f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB; compute {rf['compute_s'] * 1e3:.3f} ms, "
            f"memory {rf['memory_s'] * 1e3:.3f} ms, collective {rf['collective_s'] * 1e3:.3f} ms "
            f"({rf['dominant']}; H100 data-sheet peaks)")
    return out


def phase_dryrun(dev, smi: str) -> dict[str, int]:
    """Phase 9: the launch counts set to 0 just before and read just after.
    Its only kernel is ``rwkv6_chunk``, in 9a's rwkv6-3b prefills (256 per
    prefill: once counted, then the timed ones); no other kernel lies on
    these paths."""
    t0 = time.perf_counter()
    _reset_counts()
    out = {"card": smi}
    for name, fn in (("9a_counts", lambda: check_dry_counts(dev, smi)),
                     ("9b_memory", lambda: check_dry_memory(dev)),
                     ("9c_sweep", check_dry_sweep)):
        t1 = time.perf_counter()
        out[name] = fn()
        out[name + "_seconds"] = time.perf_counter() - t1
    counts = _read_counts()
    per_prefill = get_config("rwkv6-3b").n_periods * len(get_config("rwkv6-3b").period) * (
        -(-DRY_CASES[1][2].seq_len // get_config("rwkv6-3b").ssm_chunk))
    if counts["rwkv6_chunk"] % per_prefill or counts["rwkv6_chunk"] == 0 or any(
            v for k, v in counts.items() if k != "rwkv6_chunk"):
        raise AssertionError(f"dry-run phase launched {counts} ({per_prefill} per prefill)")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_dryrun.json").write_text(json.dumps(out, indent=1))
    log(f"dry-run phase: {out['seconds']:.1f} s (" + ", ".join(
        f"{k.removesuffix('_seconds')} {v:.1f}" for k, v in out.items()
        if k.endswith("_seconds")) + f"), launches {counts}")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs on the GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = phase_card_and_build()
    kernels = phase_kernels(dev)
    launches, v1 = phase_serving(dev)
    compiler_launches = phase_compiler(dev, v1)
    faults_launches = phase_faults(dev, v1)
    multimodel_launches, mm_kernels = phase_multimodel(dev, v1)
    multidevice_launches = phase_multidevice(dev, v1)
    launches.update(phase_lm(dev))
    attention_moe_launches = phase_attention_moe(dev)
    lm_remainder_launches = phase_lm_remainder(dev)
    launches["mla_attention"] = lm_remainder_launches["mla_attention"]
    train_launches = phase_train(dev)
    expert_parallel_launches = phase_expert_parallel(dev)
    dryrun_launches = phase_dryrun(dev, smi)
    if set(launches) != set(kernels):
        raise AssertionError(f"serving legs launched {sorted(launches)}, kernels {sorted(kernels)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the serving path")
        kernels[name]["launches"] = n
        kernels[name]["launches_compiler_phase"] = compiler_launches.get(name, 0)
        kernels[name]["launches_faults_phase"] = faults_launches.get(name, 0)
        kernels[name]["launches_multimodel_phase"] = multimodel_launches.get(name, 0)
        kernels[name]["launches_multidevice_phase"] = multidevice_launches.get(name, 0)
        kernels[name]["launches_attention_moe_phase"] = attention_moe_launches.get(name, 0)
        kernels[name]["launches_lm_remainder_phase"] = lm_remainder_launches.get(name, 0)
        kernels[name]["launches_train_phase"] = train_launches.get(name, 0)
        kernels[name]["launches_expert_parallel_phase"] = expert_parallel_launches.get(name, 0)
        kernels[name]["launches_dryrun_phase"] = dryrun_launches.get(name, 0)
        for shape, at in mm_kernels.items():
            if name in at:
                kernels[name][f"device_ms_{shape}"] = at[name]["device_ms"]
                log(f"{name}: device {at[name]['device_ms']} ms at the {shape} shape beside "
                    f"{kernels[name]['device_ms']} ms at phase 2's one-model shape")
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
