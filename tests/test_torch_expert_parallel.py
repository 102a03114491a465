"""The port's expert-parallel MoE and hierarchical collectives against repro.

repro runs ``moe_block_sharded``, its collectives and ``jax.lax``'s
``all_to_all`` / ``all_gather`` inside ``shard_map`` on fake XLA devices,
which a process fixes at its first JAX call: the ``reference`` fixture runs
them all once, in one subprocess with 8 fake CPU devices, every call jitted,
and saves every output to a ``.npz``. The port runs the same inputs (made
from numpy seeds in this module, so both processes draw them alike)
in-process, on meshes of ``["cpu"] * 8``.

Covered: ``moe_block_sharded`` on the ``(2, 2, 2)`` ``("pod", "data",
"model")`` mesh in prefill layout, in the replicated decode layout (B = 8
and B = 3), and where the dispatch drops (``capacity_factor`` 1.0, 8 x 32
tokens), and on ``(2, 4)`` (dropping too) and ``(1, 8)`` (decode)
``("data", "model")`` meshes;
the gradients of ``sum(y**2)`` through it; one train step of the smoke
deepseek-v3-671b with ``moe_impl="sharded"``; ``hierarchical_all_reduce``,
``hierarchical_all_to_all`` and 20 steps of ``ef_all_reduce``; the mesh's
``all_to_all`` and ``all_gather`` against ``jax.lax``'s.

Tolerances: ``y`` within 1e-5 of repro's sharded output, ``load`` (integer
counts in float32) bit-equal; gradients within 1e-4 of the largest |g| of
each leaf; the train step's loss within rel 1e-5, its gradient norm rel
1e-4 and the updated ``router_bias`` bit-equal; the all-to-alls bit-equal
(they move values), the sums within 1e-5; each error-feedback step's mean
within 1e-6 and its carried error within 1e-5 (``EF_ERROR_ATOL``).
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import lm_params_to_numpy
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import OptConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AX3 = ("pod", "data", "model")
AX2 = ("data", "model")
D, E, K, F = 32, 8, 2, 16
# moe_block_sharded cases: mesh, axes, x's shape, capacity factor, aux-free router
MOE_CASES = {
    "ppm_prefill": ((2, 2, 2), AX3, (4, 8, D), 8.0, True),
    "ppm_decode": ((2, 2, 2), AX3, (8, 1, D), 8.0, True),
    "ppm_decode_b3": ((2, 2, 2), AX3, (3, 1, D), 8.0, True),
    "ppm_drops": ((2, 2, 2), AX3, (8, 32, D), 1.0, False),
    "dm_2x4": ((2, 4), AX2, (4, 8, D), 1.0, True),
    "dm_1x8_decode": ((1, 8), AX2, (2, 1, D), 8.0, False),
}
GRAD_CASES = ("ppm_prefill", "ppm_decode")
Y_ATOL, GRAD_REL, LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4, 1e-5, 1e-4
TRAIN_MESH = ((2, 2, 2), AX3)
EF_STEPS = 20
EF_ERROR_ATOL = 1e-5
# all_to_all cases: (split dim, concat dim, tiled) on [4, 8, 4] per cell of a 4-cell group
A2A_CASES = ((0, 0, False), (0, 1, False), (2, 0, False), (0, 2, False), (1, 0, True),
             (1, 2, True), (2, 2, True))
GATHER_CASES = ((0, False), (0, True), (1, False), (2, True))


def _cfg(case) -> ModelConfig:
    return ModelConfig(d_model=D, n_experts=E, top_k=K, moe_d_ff=F, capacity_factor=case[3],
                       router_aux_free=case[4])


def _moe_params(seed=0) -> dict:
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"router": normal((D, E), D**-0.5), "router_bias": normal((E,), 0.1),
            "wi_gate": normal((E, D, F), D**-0.5), "wi_up": normal((E, D, F), D**-0.5),
            "wo": normal((E, F, D), F**-0.5)}


def _moe_x(name) -> np.ndarray:
    shape = MOE_CASES[name][2]
    return np.random.default_rng(sorted(MOE_CASES).index(name) + 10).normal(
        size=shape).astype(np.float32)


def _train_setup():
    """The smoke deepseek-v3-671b in float32 built by the port from seed 1,
    and a numpy batch of 2 x 16 tokens (labels the next token)."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, device="cpu", rwkv_kernel=False, seed=1)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    return cfg, model, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _coll_inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(8, 37)).astype(np.float32),
            "y": np.random.default_rng(1).normal(size=(64, 5)).astype(np.float32),
            "g": np.random.default_rng(2).normal(size=(8, 16)).astype(np.float32),
            "a2a": np.random.default_rng(4).normal(size=(16, 8, 4)).astype(np.float32)}


def _reference(path):
    """repro's outputs on 8 fake CPU devices (run by the ``reference``
    fixture in a subprocess)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config as j_get_config
    from repro.configs.base import ModelConfig as JConfig
    from repro.core.shard_compat import SM_CHECK_KW, shard_map
    from repro.distributed import collectives as jcoll
    from repro.models.model import build_model as j_build_model
    from repro.models.moe import moe_block_sharded as j_moe_block_sharded
    from repro.train import loop as jloop
    from repro.train import optimizer as jopt

    assert len(jax.devices()) >= 8, jax.devices()
    out = {}
    params = {k: jnp.asarray(v) for k, v in _moe_params().items()}
    for name, case in MOE_CASES.items():
        mesh = jax.make_mesh(case[0], case[1])
        cfg = JConfig(d_model=D, n_experts=E, top_k=K, moe_d_ff=F, capacity_factor=case[3],
                      router_aux_free=case[4])
        x = jnp.asarray(_moe_x(name))
        y, aux = jax.jit(lambda p, xx: j_moe_block_sharded(p, xx, cfg, mesh))(params, x)
        out[f"{name}/y"], out[f"{name}/load"] = np.asarray(y), np.asarray(aux["load"])
        if name in GRAD_CASES:
            def f(p, xx):
                return jnp.sum(j_moe_block_sharded(p, xx, cfg, mesh)[0] ** 2)

            gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
            out[f"{name}/grad/x"] = np.asarray(gx)
            for k in ("router", "wi_gate", "wi_up", "wo"):
                out[f"{name}/grad/{k}"] = np.asarray(gp[k])

    # one train step of the smoke deepseek-v3 on the port's init
    cfg_t, model, batch = _train_setup()
    cfg_j = dataclasses.replace(j_get_config("deepseek-v3-671b", smoke=True),
                                param_dtype="float32", compute_dtype="float32")
    # a mesh of the classic (auto) axis types: on one of jax.make_mesh's
    # default explicit axes, the attention after repro's sharded MoE block
    # refuses the layout the block's shard_map hands it
    devices = np.asarray(jax.devices()[:math.prod(TRAIN_MESH[0])]).reshape(TRAIN_MESH[0])
    jm = j_build_model(cfg_j, moe_impl="sharded", mesh=jax.sharding.Mesh(devices, TRAIN_MESH[1]))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jparams = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype),
                           lm_params_to_numpy(cfg_t, model), shapes)
    state = {"params": jparams, "opt": jopt.init_opt_state(jparams, jopt.OptConfig())}
    new, metrics = jax.jit(jloop.make_train_step(jm, jopt.OptConfig()))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    out["train/loss"] = np.asarray(metrics["loss"])
    out["train/grad_norm"] = np.asarray(metrics["grad_norm"])
    for b, leaf in new["params"]["stack"]["periods"].items():
        if "ffn" in leaf and "router_bias" in leaf["ffn"]:
            out[f"train/router_bias/{b}"] = np.asarray(leaf["ffn"]["router_bias"])

    # the collectives, as tests/test_distributed.py runs them
    cin = {k: jnp.asarray(v) for k, v in _coll_inputs().items()}
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    spec = JP(("pod", "data"))

    def sm(fn, i, o):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=i, out_specs=o, **SM_CHECK_KW))

    out["coll/hier"] = np.asarray(
        sm(lambda v: jcoll.hierarchical_all_reduce(v, "data", "pod"), spec, spec)(cin["x"]))
    out["coll/flat"] = np.asarray(
        sm(lambda v: jcoll.flat_all_reduce(v, ("pod", "data")), spec, spec)(cin["x"]))
    out["coll/hier_a2a"] = np.asarray(
        sm(lambda v: jcoll.hierarchical_all_to_all(v, "data", "pod"), spec, spec)(cin["y"]))
    out["coll/joint_a2a"] = np.asarray(sm(
        lambda v: jax.lax.all_to_all(v.reshape(8, 1, 5), ("pod", "data"), 0, 0).reshape(8, 5),
        spec, spec)(cin["y"]))
    step = sm(lambda gg, ee: jcoll.ef_all_reduce(gg, ee, "pod"), (spec, spec), (spec, spec))
    err = jnp.zeros_like(cin["g"])
    for t in range(EF_STEPS):
        red, err = step(cin["g"], err)
        out[f"coll/ef/{t}/reduced"], out[f"coll/ef/{t}/error"] = np.asarray(red), np.asarray(err)
    out["coll/ef/true"] = np.asarray(
        sm(lambda gg: jax.lax.pmean(gg, "pod"), spec, spec)(cin["g"]))

    # jax.lax's all_to_all / all_gather over a 4-cell axis
    mesh4 = jax.make_mesh((4,), ("i",))
    for split, concat, tiled in A2A_CASES:
        fn = shard_map(lambda v, s=split, c=concat, t=tiled: jax.lax.all_to_all(v, "i", s, c,
                                                                                 tiled=t),
                       mesh=mesh4, in_specs=JP("i"), out_specs=JP("i"), **SM_CHECK_KW)
        out[f"a2a/{split}{concat}{int(tiled)}"] = np.asarray(jax.jit(fn)(cin["a2a"]))
    for dim, tiled in GATHER_CASES:
        fn = shard_map(lambda v, d=dim, t=tiled: jax.lax.all_gather(v, "i", axis=d, tiled=t),
                       mesh=mesh4, in_specs=JP("i"), out_specs=JP("i"), **SM_CHECK_KW)
        out[f"gather/{dim}{int(tiled)}"] = np.asarray(jax.jit(fn)(cin["a2a"]))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("expert_parallel") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = (f"import sys; sys.path[:0] = [{os.path.join(ROOT, 'tests')!r}]; "
            f"import torch; torch.set_num_threads(1); "
            f"import test_torch_expert_parallel as m; m._reference({str(path)!r})")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert done.returncode == 0, done.stdout + "\n" + done.stderr
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, so test workers running side by
    side do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(shape, axes):
    return tmesh.make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


def _port_moe(requires_grad=False) -> tmoe.MoE:
    layer = tmoe.MoE(_cfg(MOE_CASES["ppm_prefill"]), torch.float32, "meta", None)
    for name, a in _moe_params().items():
        setattr(layer, name, torch.nn.Parameter(torch.as_tensor(a), requires_grad=requires_grad))
    return layer


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_block_sharded_matches_repro(reference, name):
    """y within 1e-5 of repro's sharded output, load bit-equal; at capacity
    factor 1.0 some assignments drop, at 8.0 none does and y equals the
    port's single-device dispatch."""
    case = MOE_CASES[name]
    cfg = _cfg(case)
    layer = _port_moe()
    x = torch.as_tensor(_moe_x(name))
    y, aux = tmoe.moe_block_sharded(layer, x, cfg, _cpu_mesh(case[0], case[1]))
    assert y.shape == x.shape and y.dtype == x.dtype
    np.testing.assert_allclose(y.numpy(), reference[f"{name}/y"], rtol=0, atol=Y_ATOL)
    np.testing.assert_array_equal(aux["load"].numpy(), reference[f"{name}/load"])
    assigned = x.shape[0] * x.shape[1] * K
    assert float(aux["load"].sum()) == assigned
    if case[3] == 1.0:  # these cases exist to drop: fewer events reach an expert
        assert float(aux["dispatched"]) < assigned
    else:
        assert float(aux["dispatched"]) == assigned
        y_local, _ = tmoe.moe_local(layer, x.reshape(-1, D), cfg, capacity=x.shape[0] * x.shape[1])
        np.testing.assert_allclose(y.numpy(), y_local.reshape(x.shape).numpy(), rtol=0,
                                   atol=Y_ATOL)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_moe_block_sharded_gradients_match_repro(reference, name):
    """d sum(y**2) / d (x, router, expert weights) through the two all-to-alls
    and, in decode layout, the replicas' sum: within 1e-4 of each leaf's
    largest |g| of repro's jitted gradients."""
    case = MOE_CASES[name]
    layer = _port_moe(requires_grad=True)
    x = torch.as_tensor(_moe_x(name)).requires_grad_()
    y, _ = tmoe.moe_block_sharded(layer, x, _cfg(case), _cpu_mesh(case[0], case[1]))
    leaves = {"x": x, "router": layer.router, "wi_gate": layer.wi_gate, "wi_up": layer.wi_up,
              "wo": layer.wo}
    grads = torch.autograd.grad((y**2).sum(), list(leaves.values()))
    for (key, _), g in zip(leaves.items(), grads):
        want = reference[f"{name}/grad/{key}"]
        assert _rel(g, want) <= GRAD_REL, (key, _rel(g, want))


def test_sharded_deepseek_v3_train_step_matches_repro(reference):
    """One train step of the smoke deepseek-v3-671b (MLA, MTP, aux-free
    router) with moe_impl="sharded" on a (2, 2, 2) mesh: loss, gradient
    norm and every period's updated router_bias as repro's; the loss as the
    port's own local dispatch gives it (nothing drops at capacity 4.0)."""
    cfg, local, batch = _train_setup()
    sharded = build_model(cfg, device="cpu", rwkv_kernel=False, seed=1, moe_impl="sharded",
                          mesh=_cpu_mesh(*TRAIN_MESH))
    sharded.load_state_dict(local.state_dict())
    state = init_train_state(sharded, OptConfig())
    new, metrics = make_train_step(sharded, OptConfig())(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(reference["train/loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(reference["train/grad_norm"]),
                               rtol=NORM_RTOL)
    got = lm_params_to_numpy(cfg, new["params"])["stack"]["periods"]
    biases = [k for k in reference if k.startswith("train/router_bias/")]
    assert biases
    for key in biases:
        np.testing.assert_array_equal(got[key.rsplit("/", 1)[1]]["ffn"]["router_bias"],
                                      reference[key])
    with torch.no_grad():
        assert float(local.loss(batch)[0]) == pytest.approx(float(metrics["loss"]), rel=1e-6)


def _cells(mesh, spec, a) -> dict:
    return tmesh.NamedSharding(mesh, spec).shard(torch.as_tensor(a))


def _whole(mesh, spec, parts) -> np.ndarray:
    return tmesh.NamedSharding(mesh, spec).unshard(parts, torch.device("cpu")).numpy()


def test_hierarchical_collectives_match_flat_and_repro(reference):
    """hierarchical_all_reduce equals the flat sum within 1e-5 and repro's;
    hierarchical_all_to_all equals the joint all_to_all over (pod, data)
    and repro's, bit for bit."""
    mesh = _cpu_mesh((2, 4), ("pod", "data"))
    spec = tmesh.P(("pod", "data"))
    cin = _coll_inputs()
    x = _cells(mesh, spec, cin["x"])
    hier = _whole(mesh, spec, tcoll.hierarchical_all_reduce(mesh, x, "data", "pod"))
    flat = _whole(mesh, spec, tcoll.flat_all_reduce(mesh, x, ("pod", "data")))
    assert np.abs(hier - flat).max() < 1e-5
    np.testing.assert_allclose(hier, reference["coll/hier"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(flat, reference["coll/flat"], rtol=0, atol=1e-5)
    y = _cells(mesh, spec, cin["y"])
    ha = _whole(mesh, spec, tcoll.hierarchical_all_to_all(mesh, y, "data", "pod"))
    joint = {}
    for group in mesh.groups(("pod", "data")):
        parts = [y[c].reshape(8, 1, 5) for c in group]
        for c, got in zip(group, tmesh.all_to_all(parts, 0, 0)):
            joint[c] = got.reshape(8, 5)
    fa = _whole(mesh, spec, joint)
    np.testing.assert_array_equal(ha, fa)
    np.testing.assert_array_equal(ha, reference["coll/hier_a2a"])
    np.testing.assert_array_equal(fa, reference["coll/joint_a2a"])
    assert tcoll.all_reduce_cross_pod_bytes(1024, 2, 4, True) == 256.0
    assert tcoll.all_reduce_cross_pod_bytes(1024, 2, 4, False) == 1024.0
    assert tcoll.all_reduce_cross_pod_bytes(1024, 1, 4, False) == 0.0


def test_ef_all_reduce_integrates_its_error_away_as_repro(reference):
    """20 steps of the int8 error-feedback mean across pods: each step's mean
    and carried error as repro's, and the running average far nearer the
    true mean than one compressed step (tests/test_distributed.py's check)."""
    mesh = _cpu_mesh((2, 4), ("pod", "data"))
    spec = tmesh.P(("pod", "data"))
    g = _cells(mesh, spec, _coll_inputs()["g"])
    err = {c: torch.zeros_like(v) for c, v in g.items()}
    acc = 0.0
    for t in range(EF_STEPS):
        red, err = tcoll.ef_all_reduce(mesh, g, err, "pod")
        red_w = _whole(mesh, spec, red)
        np.testing.assert_allclose(red_w, reference[f"coll/ef/{t}/reduced"], rtol=0, atol=1e-6)
        # the residual g + e - q * scale rounds apart by an ulp or two of |g + e|
        # per step (XLA fuses it), and the ulps add up over the steps; one
        # quantisation flip would be a whole quantum, about 2e-2 here
        np.testing.assert_allclose(_whole(mesh, spec, err), reference[f"coll/ef/{t}/error"],
                                   rtol=0, atol=EF_ERROR_ATOL)
        acc = acc + red_w
    true = reference["coll/ef/true"]
    zero = {c: torch.zeros_like(v) for c, v in g.items()}
    one_shot = np.abs(_whole(mesh, spec, tcoll.ef_all_reduce(mesh, g, zero, "pod")[0])
                      - true).max()
    assert np.abs(acc / EF_STEPS - true).max() < one_shot / 5
    q, scale = tcoll.compress_int8(g[(0, 0)])
    assert q.dtype == torch.int8 and scale.dtype == torch.float32


def test_mesh_all_to_all_and_all_gather_match_jax_lax(reference):
    """The mesh's all_to_all and all_gather against jax.lax's over a 4-cell
    axis, tiled and untiled, over several split / join dims: bit-equal."""
    mesh = _cpu_mesh((4,), ("i",))
    spec = tmesh.P("i")
    cells = _cells(mesh, spec, _coll_inputs()["a2a"])
    group = mesh.groups("i")[0]
    for split, concat, tiled in A2A_CASES:
        got = dict(zip(group, tmesh.all_to_all([cells[c] for c in group], split, concat, tiled)))
        np.testing.assert_array_equal(_whole(mesh, spec, got),
                                      reference[f"a2a/{split}{concat}{int(tiled)}"],
                                      err_msg=str((split, concat, tiled)))
    for dim, tiled in GATHER_CASES:
        got = dict(zip(group, tmesh.all_gather([cells[c] for c in group], dim, tiled)))
        np.testing.assert_array_equal(_whole(mesh, spec, got), reference[f"gather/{dim}{int(tiled)}"],
                                      err_msg=str((dim, tiled)))
