"""Multi-pod dry run: every (arch x shape x mesh) cell, counted on the meta device.

The port of ``repro.launch.dryrun``. ``repro`` lowers and compiles each
cell's step over 512 fake CPU devices and reads XLA's analyses; the port
runs each cell's real step on the meta device, which allocates nothing
and computes nothing, under ``launch.costs.CostCounter``. For each cell it

  1. builds the FULL architecture config on the meta device and the
     production mesh (``launch.mesh``, every cell the meta device; a MoE
     arch dispatches expert-parallel over it, ``moe_impl="sharded"``),
  2. resolves parameter, optimizer, cache and input shardings (logical
     axes -> PartitionSpec, ``distributed.sharding``),
  3. runs the train step (``train.loop.make_train_step``), the prefill or
     the decode step (``Model.prefill`` / ``decode_step`` under
     ``torch.inference_mode``) once under the counter,
  4. records per-device memory (arguments and outputs exact from their
     specs, on the fullest device; temporaries an estimate), FLOPs, bytes,
     collective bytes and the roofline against the H100's data-sheet peaks,

into ``build/dryrun/<arch>__<shape>__<mesh>.json`` (``"device": "meta"``).
The JSON keeps ``repro``'s keys, with three changes: ``seconds`` (the meta
run, build and step) for ``seconds_to_compile``; no
``xla_cost_analysis_flops_raw``; and the memory terms above.

The mesh runs a sharded MoE block cell by cell; on the meta device one
cell stands for all of them (``DeviceMesh.map_cells``), so a 512-cell
mesh costs host time of the order of one cell's. ``repro``'s
``REPRO_OPT_LEVEL`` (its activation-layout hints) has no counterpart: eager
PyTorch has no partitioner to pin.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import Shape, cells, get_config
from repro_torch.convert import repro_path
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.elastic import remesh_pspecs
from repro_torch.distributed.mesh import P, axes_tuple
from repro_torch.launch.costs import CostCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import OptConfig

__all__ = [
    "HBM_BW", "LINK_BW", "OUT_DIR", "PEAK_FLOPS", "Cell", "build_cell", "cache_pspecs", "count",
    "input_specs", "main", "model_param_pspecs", "opt_pspecs", "pad_heads", "run_cell",
]

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# H100 SXM data-sheet peaks at its 700 W limit, per card (dense, no sparsity;
# float32 without TF32, as the port runs)
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s, NVLink each way


def pad_heads(cfg, multiple: int):
    """Pad attention q-heads up to a multiple of the TP degree (zero-weight
    heads: exact numerics, vLLM-style). Enables clean head sharding for
    head counts like yi-34b's 56 on a 16-way axis."""
    h = math.ceil(cfg.n_heads / multiple) * multiple
    if h == cfg.n_heads or cfg.n_heads < multiple:
        return cfg
    if cfg.n_kv_heads and h % cfg.n_kv_heads != 0:
        return cfg  # would break GQA grouping
    return dataclasses.replace(cfg, n_heads=h)


# ---------------------------------------------------------------------------
# sharding resolution for the full state
# ---------------------------------------------------------------------------
def model_param_pspecs(model, params_shapes: dict, mesh) -> dict[str, P]:
    """Every parameter's spec by name: ``distributed.elastic.remesh_pspecs``
    (a scanned period's layer resolves as ``repro``'s stacked leaf)."""
    return remesh_pspecs(model, params_shapes, mesh)


def _periods(model) -> dict[str, int]:
    return {"stack": model.cfg.n_periods, "encoder": model.cfg.n_enc_layers}


def _stacked(model, name: str, spec, shape) -> tuple[tuple, tuple]:
    """A parameter's (spec, shape) as ``repro`` holds its leaf: a scanned
    period's layer with the leading ``[n_periods]`` dim, unsharded."""
    path, period = repro_path(model.cfg, name)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    if period is None:
        return spec, tuple(shape)
    return (None, *spec), (_periods(model)[path[0]], *shape)


def opt_pspecs(model, param_pspecs: dict, params_shapes: dict, mesh, opt_cfg: OptConfig,
               zero1: bool = True) -> dict:
    """Every moment's spec by parameter name: the parameter's, plus ZeRO-1
    over ``pod`` on the first divisible unsharded dim. A scanned period's
    layer resolves at ``repro``'s stacked shape and keeps the leading period
    dim in its spec (ZeRO-1 may cut the period stack over ``pod``). q8
    moments get ``{"q", "scale"}`` specs on the ``(..., blocks, block)``
    layout of ``train.optimizer``: the leading dims sharded as the
    parameter's, the two block dims whole."""
    spare = [a for a in ("pod",) if a in mesh.shape]

    def moment_spec(pspec, shape):
        if opt_cfg.state_dtype == "q8":
            lead = list(pspec)[: max(0, len(shape) - 1)]
            lead += [None] * (max(0, len(shape) - 1) - len(lead))
            return {"q": P(*lead, None, None), "scale": P(*lead, None, None)}
        if not zero1 or not spare:
            return P(*pspec)
        size = math.prod(mesh.shape[a] for a in spare)
        new = list(pspec) + [None] * (len(shape) - len(pspec))
        for i, d in enumerate(shape):
            if new[i] is None and d % size == 0:
                new[i] = tuple(spare) if len(spare) > 1 else spare[0]
                break
        return P(*new)

    return {name: moment_spec(*_stacked(model, name, spec, params_shapes[name]))
            for name, spec in param_pspecs.items()}


_BATCH = [("pod", "data"), "data", "pod"]


def _cache_spec(name: str, shape: tuple, mesh) -> P:
    """One per-layer cache leaf, by name: ``repro``'s rule for its stacked
    leaf with the period dim dropped (it never shards)."""
    spec: list = [None] * len(shape)
    used: set[str] = set()

    def assign(i, prefs):
        for axes in prefs:
            axes_t = axes_tuple(axes)
            if not all(a in mesh.shape for a in axes_t) or (set(axes_t) & used):
                continue
            size = math.prod(mesh.shape[a] for a in axes_t)
            if size > 1 and shape[i] % size == 0:
                spec[i] = axes_t if len(axes_t) > 1 else axes_t[0]
                used.update(axes_t)
                return

    if name in ("k", "v"):  # [B, L, KV, HD]
        assign(2, ["model"])
        assign(0, _BATCH)
        assign(1, ["data"])
    elif name in ("c_kv", "k_rope", "pos"):  # [B, L, R] / [B, L]
        assign(0, _BATCH)
        assign(1, ["data"])
    elif name == "conv":  # [B, K-1, C]
        assign(2, ["model"])
        assign(0, _BATCH)
    elif name in ("ssm", "wkv"):  # [B, H, P, N] / [B, H, P, P]
        assign(1, ["model"])
        assign(0, _BATCH)
    elif name in ("x_prev", "enc_out"):  # [B, D] / [B, S, D]
        assign(0, _BATCH)
    return P(*spec)


def cache_pspecs(caches: dict, mesh) -> dict:
    """The cache tree's specs (``{"stack": [per-layer {name: spec}],
    "enc_out"?}``), each leaf resolved by its name and shape."""
    out = {"stack": [{n: _cache_spec(n, tuple(t.shape), mesh) for n, t in layer.items()}
                     for layer in caches["stack"]]}
    if "enc_out" in caches:
        out["enc_out"] = _cache_spec("enc_out", tuple(caches["enc_out"].shape), mesh)
    return out


# ---------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------
def input_specs(cfg, shape: Shape, mesh, device="meta") -> tuple[dict, dict]:
    """One cell's inputs of ``repro``'s shapes and dtypes (meta tensors, or
    zeros on another ``device``), and their specs."""
    b, s = shape.global_batch, shape.seq_len
    tok_spec = shd.token_pspec(b, s, mesh)
    batch_axes = tok_spec[0]

    def meta(shape_, dtype):
        return torch.zeros(shape_, dtype=dtype, device=device)

    out = {}
    if shape.kind == "train":
        out["tokens"] = meta((b, s), torch.int32)
        out["labels"] = meta((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = meta((b, s), torch.int32)
    else:
        out["tokens"] = meta((b, 1), torch.int32)
        out["pos"] = meta((b, 1), torch.int32)
    if cfg.frontend == "vision_stub" and shape.kind in ("train", "prefill"):
        out["prefix_embeddings"] = meta((b, cfg.n_prefix_embeddings, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "audio_stub" and shape.kind in ("train", "prefill"):
        out["frames"] = meta((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    specs = {}
    for k in out:
        if k in ("tokens", "labels"):
            specs[k] = tok_spec if shape.kind == "train" else P(batch_axes, None)
        elif k == "pos":
            specs[k] = P(batch_axes, None)
        else:
            specs[k] = P(batch_axes, None, None)
    return out, specs


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------
def _device_bytes(numel: int, itemsize: int, spec, mesh) -> float:
    """Bytes of one device's slab: every cut dim divides, so all slabs of a
    tensor are the same size."""
    cut = math.prod(mesh.axes_size(e) for e in spec if e is not None)
    return numel * itemsize / cut


def _tree_device_bytes(tensors: dict, specs: dict, mesh, counter=None) -> float:
    """Per-device bytes of a tree of tensors under a tree of specs; with a
    ``counter``, of the leaves the step read only."""
    total = 0.0
    for k, t in tensors.items():
        if isinstance(t, dict):
            total += _tree_device_bytes(t, specs[k], mesh, counter)
        elif isinstance(t, list):
            total += sum(_tree_device_bytes(x, s, mesh, counter) for x, s in zip(t, specs[k]))
        elif counter is None or counter.was_read(t):
            total += _device_bytes(t.numel(), t.element_size(), specs[k], mesh)
    return total


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cell:
    """One cell's model, inputs and state (train) or caches (prefill,
    decode) on its mesh's home device, ready to step."""

    cfg: object
    shape: Shape
    mesh: object
    model: object
    opt_cfg: OptConfig
    inputs: dict
    in_specs: dict
    state: dict | None = None
    caches: dict | None = None

    @property
    def args(self):
        """The step's arguments."""
        if self.state is not None:
            return self.state, self.inputs
        return dict(self.model.named_parameters()), self.inputs, self.caches

    def step(self):
        """Run the cell's step once (prefill and decode under
        ``torch.inference_mode``); returns its outputs."""
        if self.state is not None:
            return make_train_step(self.model, self.opt_cfg)(self.state, self.inputs)
        extras = {k: v for k, v in self.inputs.items() if k in ("prefix_embeddings", "frames")}
        with torch.inference_mode():
            if self.shape.kind == "prefill":
                return self.model.prefill(self.inputs["tokens"], self.caches, extras or None)
            return self.model.decode_step(self.inputs["tokens"], self.inputs["pos"], self.caches)


def build_cell(cfg, shape: Shape, mesh, opt_cfg: OptConfig | None = None,
               loss_chunk: int = 0) -> Cell:
    """``cfg``'s model and one cell's inputs on ``mesh``'s home device (the
    meta device for the dry run; ``cuda:0`` for the same step on the card).
    A MoE arch dispatches expert-parallel over ``mesh``; training runs the
    plain ``rwkv6_chunk`` (the kernel has no backward, as the port trains);
    q8 moments above 1e11 parameters, as ``repro``."""
    train = shape.kind == "train"
    sharded = bool(cfg.n_experts)
    model = build_model(cfg, device=mesh.home, rwkv_kernel=not train,
                        moe_impl="sharded" if sharded else "local",
                        mesh=mesh if sharded else None, loss_chunk=loss_chunk,
                        requires_grad=train)
    opt_cfg = opt_cfg or OptConfig(state_dtype="q8" if cfg.param_count()[0] > 1e11 else "float32")
    inputs, in_specs = input_specs(cfg, shape, mesh, device=mesh.home)
    cell = Cell(cfg, shape, mesh, model, opt_cfg, inputs, in_specs)
    if train:
        cell.state = init_train_state(model, opt_cfg)
    else:
        cell.caches = model.init_caches(shape.global_batch, shape.seq_len + 8)
    return cell


def count(cell: Cell, track_memory: bool = False) -> CostCounter:
    """The cell's step, once, under a :class:`CostCounter`."""
    counter = CostCounter(n_devices=cell.mesh.size, track_memory=track_memory)
    with counter:
        counter.read_inputs(cell.args)
        out = cell.step()
    del out
    return counter


def run_cell(arch: str, shape: Shape, multi_pod: bool, opt_cfg: OptConfig | None = None,
             save: bool = True, mesh=None, cfg=None, loss_chunk: int = 0,
             pad_heads_to: int = 0, out_dir: Path | str | None = None) -> dict:
    """One cell's dry run; returns (and with ``save`` writes) its record.
    ``loss_chunk`` and ``pad_heads_to`` are ``repro``'s ``REPRO_LOSS_CHUNK``
    and ``REPRO_PAD_HEADS``."""
    t0 = time.perf_counter()
    cfg = cfg if cfg is not None else get_config(arch)
    if pad_heads_to:
        cfg = pad_heads(cfg, pad_heads_to)
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    mesh_name = "multi" if multi_pod else "single"
    cell = build_cell(cfg, shape, mesh, opt_cfg, loss_chunk)
    model, inputs, in_specs = cell.model, cell.inputs, cell.in_specs
    params = dict(model.named_parameters())
    params_shapes = {n: tuple(p.shape) for n, p in params.items()}
    p_specs = model_param_pspecs(model, params_shapes, mesh)
    counter = count(cell, track_memory=True)
    if cell.state is not None:
        o_specs = opt_pspecs(model, p_specs, params_shapes, mesh, cell.opt_cfg)
        # a scanned period's moment is its share of the stacked leaf, whose
        # spec may cut the period dim; the step is replicated
        opt = cell.state["opt"]
        state_bytes = (_tree_device_bytes(cell.state["params"], p_specs, mesh, counter)
                       + _tree_device_bytes({"m": opt["m"], "v": opt["v"], "step": opt["step"]},
                                            {"m": o_specs, "v": o_specs, "step": P()}, mesh,
                                            counter))
        arg_bytes = state_bytes + _tree_device_bytes(inputs, in_specs, mesh, counter)
        out_bytes = state_bytes + 3 * 4  # the new state; loss, grad_norm, lr
    else:
        c_specs = cache_pspecs(cell.caches, mesh)
        arg_bytes = (_tree_device_bytes(params, p_specs, mesh, counter)
                     + _tree_device_bytes(cell.caches, c_specs, mesh, counter)
                     + _tree_device_bytes(inputs, in_specs, mesh, counter))
        logits = _device_bytes(shape.global_batch * cfg.vocab, 4, P(in_specs["tokens"][0]), mesh)
        # [B, 1, V] float32 and the new caches
        out_bytes = logits + _tree_device_bytes(cell.caches, c_specs, mesh)
    seconds = time.perf_counter() - t0
    n_chips = mesh.size
    temp = max(0.0, counter.peak_bytes - counter.bytes["inputs"]) / n_chips

    flops_by_dtype = {k: v / n_chips for k, v in counter.flops.items()}
    flops = sum(flops_by_dtype.values())
    bytes_by_class = {k: v / n_chips for k, v in counter.bytes.items()}
    bytes_acc = sum(bytes_by_class.values())
    coll = counter.summary()["collective"]
    coll["analytic_total"] = coll["total"]
    total_p, active_p = cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * active_p * tokens

    comp_t = sum(f / PEAK_FLOPS.get(k, PEAK_FLOPS["float32"]) for k, f in flops_by_dtype.items())
    mem_t = bytes_acc / HBM_BW
    coll_t = coll["total"] / LINK_BW
    dom = max(("compute", comp_t), ("memory", mem_t), ("collective", coll_t), key=lambda kv: kv[1])
    bound = max(comp_t, mem_t, coll_t)
    result = {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "n_chips": int(n_chips),
        "device": "meta",
        "seconds": seconds,
        "memory": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(temp),
            "generated_code_size_in_bytes": 0,
        },
        "cost": {
            "flops_per_device": flops,
            "bytes_per_device": bytes_acc,
            "flops_per_device_by_dtype": flops_by_dtype,
            "bytes_per_device_by_class": bytes_by_class,
        },
        "collective_bytes_per_device": coll,
        "params": {"total": total_p, "active": active_p},
        "model_flops_global": model_flops,
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW,
                  "card": "H100 SXM data sheet, 700 W"},
        "roofline": {
            "compute_s": comp_t,
            "memory_s": mem_t,
            "collective_s": coll_t,
            "dominant": dom[0],
            "model_flops_ratio": model_flops / (flops * n_chips) if flops else None,
            "mfu_upper_bound": (model_flops / (PEAK_FLOPS["bfloat16"] * n_chips)) / bound
            if bound > 0 else None,
        },
    }
    if save:
        out_dir = Path(out_dir) if out_dir is not None else OUT_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape.name}__{mesh_name}.json").write_text(
            json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="blockwise cross-entropy chunk (repro's REPRO_LOSS_CHUNK)")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad q-heads to a multiple of this (repro's REPRO_PAD_HEADS)")
    ap.add_argument("--out-dir", type=str, default=str(OUT_DIR))
    args = ap.parse_args(argv)

    todo = []
    for arch, shape, runnable, skip in cells():
        if not args.all:
            if args.arch and arch != args.arch:
                continue
            if args.shape and shape.name != args.shape:
                continue
        if not runnable:
            print(f"SKIP {arch} x {shape.name}: {skip}")
            continue
        for mp in ([False, True] if args.mesh == "both" else [args.mesh == "multi"]):
            todo.append((arch, shape, mp))

    failures = 0
    for arch, shape, mp in todo:
        tag = f"{arch} x {shape.name} x {'multi' if mp else 'single'}"
        try:
            r = run_cell(arch, shape, mp, loss_chunk=args.loss_chunk,
                         pad_heads_to=args.pad_heads, out_dir=args.out_dir)
            rf = r["roofline"]
            print(f"OK   {tag}: meta run {r['seconds']:.1f}s "
                  f"compute={rf['compute_s']:.3e}s memory={rf['memory_s']:.3e}s "
                  f"collective={rf['collective_s']:.3e}s dominant={rf['dominant']}", flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue the sweep
            failures += 1
            print(f"FAIL {tag}: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
