"""The port's dry run (``launch/{mesh,costs,dryrun}.py``) against repro's.

* The resolvers: ``opt_pspecs`` (float32, bfloat16 and q8 moments, ZeRO-1 on
  and off) and ``cache_pspecs`` for the ten full configs on (16, 16) and
  (2, 16, 16) equal repro's, leaf by leaf (a duck-typed mesh: repro's
  resolvers read only ``mesh.shape``; importing ``repro.launch.dryrun``
  rewrites ``XLA_FLAGS``, which is saved and restored around the import).
  A scanned period's layer keeps repro's stacked spec for its moments
  (ZeRO-1 may cut the period stack over ``pod``) and drops the period dim
  for its cache.
* ``run_cell`` for deepseek-v3-671b smoke, ``Shape("train_4k", 32, 8,
  "train")``, on a (2, 2, 2) mesh of the meta device, with the three
  assertions of repro's ``test_dryrun_cell_on_test_mesh``; and the record's
  keys, device and JSON file.
* One subprocess with 8 fake CPU devices runs repro's ``run_cell`` on an
  Auto-axes ``jax.sharding.Mesh`` (``jax.make_mesh`` gives Explicit axes,
  on which repro's activation hints raise) for that cell and for a
  deepseek-moe-16b smoke prefill. Equal: ``argument_size_in_bytes``, the
  analytic collective bytes by kind, ``params``, ``model_flops_global``.
  ``flops_per_device`` is held exactly to repro's walker with each
  ``shard_map`` body counted once per device of its mesh: the walker's own
  ``"jaxpr" in params`` branch (``src/repro/launch/costs.py:109``) catches
  ``shard_map`` before its mesh-size branch (``:113``), so repro's recorded figure counts the sharded MoE's work once in
  all, and the port's exceeds it by exactly the other devices' share.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs import ARCHS, SHAPES, Shape, get_config
from repro_torch.convert import repro_path
from repro_torch.distributed.mesh import NamedSharding, P, make_mesh
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import OptConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_saved_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdr  # noqa: E402  (rewrites XLA_FLAGS when imported)

if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

SMOKE_TRAIN = Shape("train_4k", 32, 8, "train")
SMOKE_PREFILL = Shape("prefill_32k", 32, 8, "prefill")
DECODE = next(s for s in SHAPES if s.name == "decode_32k")


class _FakeMesh:
    """Duck-typed mesh: the resolvers only read ``.shape``."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _norm(spec, ndim: int) -> tuple:
    out = [None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = j_build_model(j_get_config(arch))
        model = build_model(get_config(arch), device="meta")
        out[arch] = (jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), model)
    return out


# ---------------------------------------------------------------------------
# (a) the resolvers, ten full configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_pspecs_match_repro(models, arch, mesh_name):
    jm, j_shapes, model = models[arch]
    mesh = _FakeMesh(MESHES[mesh_name])
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    p_specs = dr.model_param_pspecs(model, shapes, mesh)
    j_pspecs = jdr.model_param_pspecs(jm, j_shapes, mesh)
    for dtype in ("float32", "bfloat16", "q8"):
        for zero1 in (True, False):
            got = dr.opt_pspecs(model, p_specs, shapes, mesh, OptConfig(state_dtype=dtype), zero1)
            want = jdr.opt_pspecs(j_pspecs, j_shapes, mesh, JOptConfig(state_dtype=dtype), zero1)
            for name, spec in got.items():
                path, _ = repro_path(model.cfg, name)
                w = _get(want, path)
                ndim = len(_get(j_shapes, path).shape)
                if dtype == "q8":
                    assert set(spec) == {"q", "scale"}
                    for part in ("q", "scale"):
                        assert _norm(spec[part], ndim + 1) == _norm(w[part], ndim + 1), (
                            name, dtype, part)
                else:
                    assert _norm(spec, ndim) == _norm(w, ndim), (name, dtype, zero1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_pspecs_match_repro(models, arch, mesh_name):
    jm, _, model = models[arch]
    mesh = _FakeMesh(MESHES[mesh_name])
    b, length = DECODE.global_batch, DECODE.seq_len + 8
    j_caches = jax.eval_shape(lambda: jm.init_caches(b, length))
    want = jdr.cache_pspecs(j_caches, mesh, b)
    caches = model.init_caches(b, length)
    got = dr.cache_pspecs(caches, mesh)
    n = 0
    for i, (layer, specs) in enumerate(zip(caches["stack"], got["stack"])):
        for name, t in layer.items():
            path, period = repro_path(model.cfg, f"stack.{i}.{name}")
            w = _get(want, path)
            if period is not None:  # repro's leaf is stacked over the periods
                assert w[0] is None
                w = tuple(w)[1:]
            assert _norm(specs[name], t.dim()) == _norm(w, t.dim()), (i, name)
            n += 1
    if "enc_out" in caches:
        assert _norm(got["enc_out"], 3) == _norm(want["enc_out"], 3)
    assert n == sum(len(layer) for layer in caches["stack"])


def test_production_mesh_on_meta():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.on_meta
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    x = torch.empty(64, 32, device="meta")
    parts = NamedSharding(multi, P(("pod", "data"), "model")).shard(x)
    assert len(parts) == 512 and next(iter(parts.values())).shape == (2, 2)


# ---------------------------------------------------------------------------
# (b) the port's counterpart of repro's failing test_dryrun_cell_on_test_mesh
# ---------------------------------------------------------------------------
def _smoke_mesh():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["meta"] * 8)


@pytest.fixture(scope="module")
def port_cells():
    cfg = get_config("deepseek-v3-671b", smoke=True)
    train = dr.run_cell("deepseek-v3-671b", SMOKE_TRAIN, multi_pod=True, save=False,
                        mesh=_smoke_mesh(), cfg=cfg)
    prefill = dr.run_cell("deepseek-moe-16b", SMOKE_PREFILL, multi_pod=True, save=False,
                          mesh=_smoke_mesh(), cfg=get_config("deepseek-moe-16b", smoke=True))
    return {"train": train, "prefill": prefill}


def test_dryrun_cell_on_test_mesh(port_cells):
    r = port_cells["train"]
    assert r["roofline"]["compute_s"] > 0
    assert r["collective_bytes_per_device"]["total"] > 0
    assert r["memory"]["temp_size_in_bytes"] > 0
    assert r["device"] == "meta" and r["n_chips"] == 8
    keys = {"arch", "shape", "kind", "mesh", "n_chips", "seconds", "memory", "cost",
            "collective_bytes_per_device", "params", "model_flops_global", "roofline"}
    assert keys <= set(r)
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                  "model_flops_ratio", "mfu_upper_bound"}
    flops = r["cost"]["flops_per_device_by_dtype"]
    assert r["roofline"]["compute_s"] == sum(f / dr.PEAK_FLOPS[k] for k, f in flops.items())


def test_run_cell_writes_its_json(tmp_path):
    r = dr.run_cell("gemma3-1b", Shape("decode_32k", 32, 8, "decode"), multi_pod=False,
                    mesh=make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8),
                    cfg=get_config("gemma3-1b", smoke=True), out_dir=tmp_path)
    saved = json.loads((tmp_path / "gemma3-1b__decode_32k__single.json").read_text())
    assert saved["memory"] == r["memory"] and saved["device"] == "meta"
    assert r["memory"]["argument_size_in_bytes"] > 0 and r["cost"]["flops_per_device"] > 0


# ---------------------------------------------------------------------------
# (c) repro's run_cell on an Auto-axes mesh of 8 fake devices
# ---------------------------------------------------------------------------
def _reference() -> dict:
    """Runs in the subprocess: repro's records of the two smoke cells, the
    walker's analytic collectives by kind, and its FLOPs with each
    shard_map body counted once per device of its mesh."""
    from repro.configs import Shape as JShape
    from repro.launch import costs as jcosts

    plain = jcosts._sub_jaxprs

    def per_device(eqn):
        if eqn.primitive.name == "shard_map":
            sizes = dict(eqn.params["mesh"].shape)
            return [(eqn.params["jaxpr"], float(math.prod(sizes.values())), sizes)]
        return plain(eqn)

    seen = {}
    walker = jdr.jaxpr_cost

    def spy(closed):
        r = walker(closed)
        seen["analytic"] = {k: v for k, v in r["collective"].items() if k != "total"}
        jcosts._sub_jaxprs = per_device
        try:
            seen["flops_all_devices"] = jcosts.jaxpr_cost(closed)["flops"]
        finally:
            jcosts._sub_jaxprs = plain
        return r

    jdr.jaxpr_cost = spy
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                             ("pod", "data", "model"))
    out = {}
    for kind, arch, shape in (("train", "deepseek-v3-671b", SMOKE_TRAIN),
                              ("prefill", "deepseek-moe-16b", SMOKE_PREFILL)):
        r = jdr.run_cell(arch, JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind),
                         multi_pod=True, save=False, mesh=mesh, cfg=j_get_config(arch, smoke=True))
        out[kind] = {"record": r, **seen}
    return out


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="0", XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import sys, json; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}]; "
            f"import torch; torch.set_num_threads(1); "
            f"import test_torch_dryrun as m; print(json.dumps(m._reference()))")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stdout + "\n" + done.stderr
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_run_cell_matches_repro(port_cells, reference, kind):
    got, ref = port_cells[kind], reference[kind]
    want = ref["record"]
    assert got["memory"]["argument_size_in_bytes"] == want["memory"]["argument_size_in_bytes"]
    coll = {k: v for k, v in got["collective_bytes_per_device"].items()
            if k not in ("total", "analytic_total")}
    assert coll == ref["analytic"]
    assert got["collective_bytes_per_device"]["analytic_total"] == \
        want["collective_bytes_per_device"]["analytic_total"]
    assert got["params"] == want["params"]
    assert got["model_flops_global"] == want["model_flops_global"]
    # exact against the walker with every shard_map body counted per device
    assert got["cost"]["flops_per_device"] == ref["flops_all_devices"] / got["n_chips"]
    assert got["cost"]["flops_per_device"] > want["cost"]["flops_per_device"]
