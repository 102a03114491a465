"""The port's sharding rules, remesh_pspecs / reshard_state and multi-axis
mesh entries against repro (no subprocess: the resolver reads only
``mesh.shape``, so both packages resolve against a duck-typed mesh).

Covered: ``resolve`` / ``batch_pspec`` / ``token_pspec`` / ``cache_pspec``
on the cases of tests/test_sharding.py and on random shapes;
``Model.spec_tree()`` against repro's ``Model.param_specs()`` and
``remesh_pspecs`` for all ten full configs (shapes from models built on the
meta device, nothing allocated) on five meshes, leaf by leaf through
``convert.repro_path``; whisper-base against repro's ``launch/dryrun.py``
rule, since repro's own ``remesh_pspecs`` raises there; the leaves that
resolving each layer on its own would get wrong; ``reshard_state`` with
float32, bfloat16 and q8 moments; tuple-axis ``shard`` / ``unshard``,
``groups`` and ``index``, ``all_to_all`` and ``all_gather`` on the mesh.

Specs are compared entry by entry after normalising (``jax``'s
``PartitionSpec`` writes a one-axis tuple as the axis name): equal.
"""

import dataclasses
import itertools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import cells as j_cells
from repro.configs import get_config as j_get_config
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jshd
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import repro_path
from repro_torch.distributed import elastic as telastic
from repro_torch.distributed import mesh as tmesh
from repro_torch.distributed import sharding as tshd
from repro_torch.models.model import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import OptConfig


class _FakeMesh:
    """Duck-typed mesh: the resolvers only read ``.shape``."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = {
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "16x16": {"data": 16, "model": 16},
    "2x4": {"data": 2, "model": 4},
    "4x2": {"data": 4, "model": 2},
    "1x8": {"data": 1, "model": 8},
}
BIG = _FakeMesh(MESHES["2x16x16"])


def _norm(spec, ndim: int) -> tuple:
    """Entries as tuples of axis names (or None), padded to ``ndim``."""
    out = [None if e is None else ((e,) if isinstance(e, str) else tuple(e)) for e in spec]
    return tuple(out + [None] * (ndim - len(out)))


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, so test workers side by side do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """Per arch: (repro model, repro's shapes from ``jax.eval_shape``, the
    port's model on the meta device, its shapes by name)."""
    out = {}
    for arch in ARCHS:
        jm = j_build_model(j_get_config(arch))
        model = build_model(get_config(arch), device="meta")
        out[arch] = (jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0)), model,
                     {n: tuple(p.shape) for n, p in model.named_parameters()})
    return out


# ---------------------------------------------------------------------------
# the resolver
# ---------------------------------------------------------------------------
RESOLVE_CASES = (  # tests/test_sharding.py's cases on the (2, 16, 16) mesh
    (("embed", "heads", "head_dim"), (4608, 32, 128)),
    (("embed", "heads", "head_dim"), (1152, 4, 256)),
    (("embed", "heads", "head_dim"), (7168, 56, 128)),
    ((None, "experts", "embed", "mlp"), (58, 256, 7168, 2048)),
    ((None, "experts", "embed", "mlp"), (27, 64, 2048, 1408)),
    (("vocab_in", "embed"), (129280, 7168)),
    (("vocab", "embed"), (129280, 7168)),
)


@pytest.mark.parametrize("logical,shape", RESOLVE_CASES)
def test_resolve_matches_repro_on_its_cases(logical, shape):
    got = tshd.resolve(logical, shape, BIG)
    assert _norm(got, len(shape)) == _norm(jshd.resolve(logical, shape, BIG), len(shape))
    assert isinstance(got, tmesh.PartitionSpec)


def test_resolve_keeps_repro_policies():
    """tests/test_sharding.py's expectations, on the port."""
    assert tshd.resolve(("embed", "heads", "head_dim"), (4608, 32, 128), BIG) == \
        tmesh.P(None, "model", None)
    assert tshd.resolve(("embed", "heads", "head_dim"), (1152, 4, 256), BIG) == \
        tmesh.P(None, None, None)
    assert tshd.resolve(("embed", "heads", "head_dim"), (7168, 56, 128), BIG) == \
        tmesh.P("model", None, None)
    assert tshd.resolve((None, "experts", "embed", "mlp"), (58, 256, 7168, 2048),
                        BIG)[1] == ("data", "model")
    assert tshd.resolve((None, "experts", "embed", "mlp"), (27, 64, 2048, 1408),
                        BIG)[1] == "model"
    assert tshd.batch_pspec(256, BIG) == tmesh.P(("pod", "data"))
    assert tshd.batch_pspec(16, BIG) == tmesh.P(("data",))
    assert tshd.batch_pspec(1, BIG) == tmesh.P(None)


def _random_mesh(rng) -> _FakeMesh:
    names = [a for a in ("pod", "data", "model") if rng.random() < 0.8] or ["model"]
    return _FakeMesh({a: int(rng.choice([1, 2, 3, 4, 8, 16])) for a in names})


def test_resolvers_match_repro_on_random_shapes():
    """300 random (logical axes, shape, mesh) for ``resolve``, and random
    batches, sequences and cache kinds for the three input resolvers."""
    rng = np.random.default_rng(0)
    names = [*tshd.RULES, None, "unknown"]
    dims = (1, 2, 3, 4, 6, 8, 12, 16, 56, 64, 96, 128, 256, 4096, 7168, 12288)
    for _ in range(300):
        mesh = _random_mesh(rng)
        n = int(rng.integers(1, 5))
        logical = tuple(names[i] for i in rng.integers(0, len(names), n))
        shape = tuple(int(rng.choice(dims)) for _ in range(n))
        want = jshd.resolve(logical, shape, mesh)
        assert _norm(tshd.resolve(logical, shape, mesh), n) == _norm(want, n), (logical, shape,
                                                                              mesh.shape)
    kinds = ("batch", "seq", "kv_heads", "heads", "head_dim", "state", None)
    for _ in range(200):
        mesh = _random_mesh(rng)
        b, s = int(rng.choice((1, 2, 3, 8, 32, 128, 256))), int(rng.choice((1, 7, 16, 4096)))
        assert _norm(tshd.batch_pspec(b, mesh), 1) == _norm(jshd.batch_pspec(b, mesh), 1)
        assert _norm(tshd.token_pspec(b, s, mesh), 2) == _norm(jshd.token_pspec(b, s, mesh), 2)
        n = int(rng.integers(1, 6))
        kind = tuple(kinds[i] for i in rng.integers(0, len(kinds), n))
        shape = tuple(int(rng.choice(dims)) for _ in range(n))
        assert _norm(tshd.cache_pspec(shape, kind, mesh), n) == \
            _norm(jshd.cache_pspec(shape, kind, mesh), n), (shape, kind, mesh.shape)


def test_tree_pspecs_resolves_trees_of_shapes():
    tree = {"a": ("embed", "heads", "head_dim"), "b": {"c": ("vocab", "embed")}}
    shapes = {"a": torch.Size((4608, 32, 128)), "b": {"c": (129280, 7168)}}
    got = tshd.tree_pspecs(tree, shapes, BIG)
    assert got == {"a": tmesh.P(None, "model", None), "b": {"c": tmesh.P("model", None)}}
    stacked = tshd.tree_pspecs({"w": ("experts", "embed", "mlp")},
                               {"w": (58, 256, 7168, 2048)}, BIG, prefix_none=1)
    assert stacked["w"] == tmesh.P(None, ("data", "model"), None, None)


# ---------------------------------------------------------------------------
# Model.param_specs and remesh_pspecs, ten full configs
# ---------------------------------------------------------------------------
def _dryrun_pspecs(jm, shapes, mesh) -> dict:
    """repro's ``launch/dryrun.py`` ``model_param_pspecs`` rule (not
    imported: that module rewrites ``XLA_FLAGS`` when imported): every
    stack-like subtree (the decoder and the encoder) resolves its
    ``periods`` stacked."""
    out = {}
    for k, sub in jm.param_specs().items():
        if isinstance(sub, dict) and "periods" in sub:
            out[k] = {name: jshd.tree_pspecs(blk, shapes[k][name], mesh,
                                             prefix_none=1 if name == "periods" else 0)
                      for name, blk in sub.items()}
        else:
            out[k] = jshd.tree_pspecs(sub, shapes[k], mesh)
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_tree_is_repros_param_specs(models, arch):
    jm, _, model, shapes = models[arch]
    assert model.spec_tree() == jm.param_specs()
    specs = model.param_specs()
    assert specs.keys() == shapes.keys()
    assert all(len(specs[n]) == len(shapes[n]) for n in specs)
    assert next(iter(model.parameters())).device.type == "meta"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remesh_pspecs_equals_repros_on_five_meshes(models, arch):
    """Every parameter of the full config, on each mesh: the port's spec
    equals repro's for the same leaf (a scanned period's with its period
    dim dropped); whisper-base's equal repro's dry-run rule."""
    jm, jshapes, model, shapes = models[arch]
    sharded = 0
    for mesh_name, shape in MESHES.items():
        mesh = _FakeMesh(shape)
        if arch == "whisper-base":
            want_tree = _dryrun_pspecs(jm, jshapes, mesh)
        else:
            want_tree = jelastic.remesh_pspecs(jm, jshapes, mesh)
        got = telastic.remesh_pspecs(model, shapes, mesh)
        assert got.keys() == shapes.keys()
        for name, spec in got.items():
            path, period = repro_path(model.cfg, name)
            want = tuple(_get(want_tree, path))
            if period is not None:
                want = want[1:]
            assert _norm(spec, len(shapes[name])) == _norm(want, len(shapes[name])), (
                mesh_name, name)
            sharded += any(e is not None for e in spec)
    assert sharded > 0


def test_repro_remesh_pspecs_raises_on_the_encoder(models):
    """A reference defect: repro's remesh_pspecs resolves the stacked
    encoder as unstacked and fails on whisper-base (ROADMAP.md §3); the
    port resolves it as repro's dry-run does (the test above)."""
    jm, jshapes, _, _ = models["whisper-base"]
    with pytest.raises(AssertionError):
        jelastic.remesh_pspecs(jm, jshapes, BIG)


# resolved one layer at a time at the port's per-layer shape, these leaves
# shard differently from repro's stacked leaf: the "embed" fallback reads
# the whole stacked tensor's size
PER_LAYER_DIFFERS = (
    ("2x16x16", "glm4-9b", ("inner.wk", "inner.wv")),
    ("2x16x16", "yi-34b", ("inner.wk", "inner.wv")),
    ("2x16x16", "internvl2-76b", ("inner.wk", "inner.wv")),
    ("2x16x16", "deepseek-v3-671b", ("inner.w_dkv", "inner.w_dq", "ffn.router")),
    ("2x4", "glm4-9b", ("inner.wk", "inner.wv")),
    ("2x4", "deepseek-v3-671b", ("inner.w_dkv", "inner.w_dq", "ffn.router")),
)


@pytest.mark.parametrize("mesh_name,arch,leaves", PER_LAYER_DIFFERS)
def test_period_layers_resolve_at_the_stacked_shape(models, mesh_name, arch, leaves):
    jm, jshapes, model, shapes = models[arch]
    mesh = _FakeMesh(MESHES[mesh_name])
    got = telastic.remesh_pspecs(model, shapes, mesh)
    want_tree = jelastic.remesh_pspecs(jm, jshapes, mesh)
    specs = model.param_specs()
    first = len(model.cfg.prefix_layers)  # the first layer of the first period
    for leaf in leaves:
        name = f"stack.{first}.{leaf}"
        per_layer = tshd.resolve(tuple(specs[name]), shapes[name], mesh)
        want = tuple(_get(want_tree, repro_path(model.cfg, name)[0]))[1:]
        assert _norm(got[name], len(shapes[name])) == _norm(want, len(shapes[name]))
        assert _norm(per_layer, len(shapes[name])) != _norm(want, len(shapes[name])), name


# ---------------------------------------------------------------------------
# reshard_state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "q8"])
def test_reshard_state_keeps_every_value(state_dtype):
    """A smoke deepseek-v3 train state after one step (moments nonzero)
    placed on a (2, 4) mesh of the CPU: parameters under their resolved
    specs, moments (q8 ``{"q", "scale"}`` included) and ``step`` unchanged,
    every value bit-equal; some parameter really shards."""
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, device="cpu", rwkv_kernel=False, seed=2)
    opt = OptConfig(state_dtype=state_dtype)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    state, _ = make_train_step(model, opt)(init_train_state(model, opt),
                                           {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    shapes = {n: tuple(p.shape) for n, p in state["params"].items()}
    pspecs = telastic.remesh_pspecs(model, shapes, mesh)
    out = telastic.reshard_state(state, pspecs, mesh)
    assert out["params"].keys() == state["params"].keys()
    for name, p in state["params"].items():
        assert torch.equal(out["params"][name], p) and out["params"][name].device == mesh.home
    assert any(any(e is not None for e in s) for s in pspecs.values())
    for moment in ("m", "v"):
        for name, want in state["opt"][moment].items():
            got = out["opt"][moment][name]
            if state_dtype == "q8":
                assert got.keys() == {"q", "scale"}
                assert all(torch.equal(got[k], want[k]) for k in want)
            else:
                assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(out["opt"]["step"]) == int(state["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# the mesh: specs over several axes, groups, all_to_all, all_gather
# ---------------------------------------------------------------------------
def _cpu_mesh(shape, axes):
    return tmesh.make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


@pytest.mark.parametrize("spec", [tmesh.P(("pod", "data"), "model"), tmesh.P(("model", "pod")),
                                  tmesh.P(None, ("data", "model", "pod")),
                                  tmesh.P("data", ("pod", "model"))])
def test_tuple_axis_shard_unshard_round_trip(spec):
    """A dim cut over a tuple of axes is cut over their product, row-major
    with the first axis major (jax.sharding.PartitionSpec's order); unshard
    joins the slabs back."""
    mesh = _cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    sharding = tmesh.NamedSharding(mesh, spec)
    parts = sharding.shard(x)
    for cell, part in parts.items():
        want = x
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = tmesh.axes_tuple(axes)
            n = math.prod(mesh.shape[a] for a in axes)
            rank = int(np.ravel_multi_index(tuple(cell[mesh.axis_names.index(a)] for a in axes),
                                            tuple(mesh.shape[a] for a in axes)))
            w = x.shape[dim] // n
            want = want.narrow(dim, rank * w, w)
        assert torch.equal(part, want), (cell, spec)
        assert part.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()  # a view
    assert torch.equal(sharding.unshard(parts, torch.device("cpu")), x)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.NamedSharding(mesh, tmesh.P(("pod", "data", "model"))).check((4, 3))


def test_groups_and_index_over_axis_tuples():
    mesh = _cpu_mesh((2, 3, 2), ("pod", "data", "model"))
    groups = mesh.groups(("data", "model"))
    assert len(groups) == 2 and all(len(g) == 6 for g in groups)
    for group in groups:
        assert [mesh.index(c, ("data", "model")) for c in group] == list(range(6))
        assert len({c[0] for c in group}) == 1
    assert mesh.groups(("model", "pod"))[0] == [(0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1)]
    assert mesh.index((1, 2, 1), ("pod", "data", "model")) == 11
    assert mesh.axes_size(("pod", "model")) == 4 and mesh.axes_size("data") == 3
    # a single axis keeps its groups as before
    assert mesh.groups("model") == [[(p, d, 0), (p, d, 1)] for p in range(2) for d in range(3)]


def _oracle_all_to_all(xs, split, concat):
    """Cell j receives slab j of every source, joined in source order (tiled)."""
    n = len(xs)
    return [np.concatenate([np.split(x, n, axis=split)[j] for x in xs], axis=concat)
            for j in range(n)]


@pytest.mark.parametrize("n", [2, 4])
def test_all_to_all_and_all_gather_move_every_slab(n):
    rng = np.random.default_rng(n)
    xs = [rng.normal(size=(n * 2, 3, n)).astype(np.float32) for _ in range(n)]
    parts = [torch.as_tensor(x) for x in xs]
    for split, concat in itertools.product(range(3), range(3)):
        if xs[0].shape[split] % n == 0:
            got = tmesh.all_to_all(parts, split, concat, tiled=True)
            for g, w in zip(got, _oracle_all_to_all(xs, split, concat)):
                np.testing.assert_array_equal(g.numpy(), w)
    # untiled on a dim of the group's size: an exchange of slabs, twice the identity
    once = tmesh.all_to_all(parts, 2, 2)
    assert [tuple(p.shape) for p in once] == [tuple(p.shape) for p in parts]
    twice = tmesh.all_to_all(once, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(twice, parts))
    assert all(o.data_ptr() != p.data_ptr() for o, p in zip(once, parts))  # fresh tensors
    moved = tmesh.all_to_all(parts, 2, 0)  # the source dim appears at 0
    assert tuple(moved[1].shape) == (n, n * 2, 3)
    np.testing.assert_array_equal(moved[1][0].numpy(), xs[0][..., 1])
    for tiled in (False, True):
        gathered = tmesh.all_gather(parts, 1, tiled=tiled)
        want = np.concatenate(xs, 1) if tiled else np.stack(xs, 1)
        assert all(np.array_equal(g.numpy(), want) for g in gathered)
    with pytest.raises(ValueError, match="group's size"):
        tmesh.all_to_all(parts, 1, 1)


def test_collectives_are_differentiable():
    """Gradients flow back through all_to_all and all_gather to every
    cell's input: the backward of an exchange is the exchange back."""
    rng = np.random.default_rng(1)
    parts = [torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32)).requires_grad_()
             for _ in range(4)]
    out = tmesh.all_to_all(parts, 0, 0)
    weights = [torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32)) for _ in range(4)]
    grads = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, weights)), parts)
    back = tmesh.all_to_all(weights, 0, 0)
    assert all(torch.equal(g, b) for g, b in zip(grads, back))
    gathered = tmesh.all_gather(parts, 0)
    grads = torch.autograd.grad(sum(g.sum() for g in gathered), parts)
    assert all(torch.equal(g, torch.full((4, 3), 4.0)) for g in grads)


def test_shape_cells_match_repro():
    assert tconfigs.SHAPES == tuple(tconfigs.Shape(*dataclasses.astuple(s)) for s in J_SHAPES)
    assert tconfigs.LONG_OK == {"zamba2-2.7b", "rwkv6-3b"}
    got = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why in tconfigs.cells()]
    want = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why in j_cells()]
    assert got == want and len(got) == 40 and list(ARCHS) == list(J_ARCHS)
    assert JP("data") == JP(("data",))  # why specs are compared normalised
