"""The port's step counter (``launch/costs.py``) against repro's jaxpr walker.

``repro_torch.launch.costs.CostCounter`` counts a step op by op as torch
dispatches it; ``repro.launch.costs.jaxpr_cost`` walks the jaxpr of the same
step. For the ten smoke configs x {prefill, decode, train} at B = 2, S = 16
on one device, the counter's FLOPs, its ``dot`` bytes (operand plus result
bytes of every product) and its ``inputs`` bytes equal the walker's. The
``index`` class (gathers, scatters, sorts, slice updates) is held one-sided:
the walker counts a ``dynamic_slice`` / ``dynamic_update_slice`` as reading
and writing its whole buffer (the functional update), where the port writes
a cache slice in place, so the port's index bytes lie between 0.4 and 1.0
of the walker's remainder.

Two exceptions, each held exactly to its own formula:

* rwkv6-3b: the counter reckons each ``rwkv6_chunk`` call from its shapes
  (``kernels.rwkv6.ops.chunk_cost``), whichever version runs; repro's
  walker counts the plain chunk's einsums inside its scan. The chunk is
  stubbed on both sides with a product-free stand-in of the same shapes, so
  everything outside it is compared exactly, and the reckoning is checked
  against its formula and the kernel table's 36,710,400 bytes.
* zamba2-2.7b train: ``jax.grad`` transposes a scan's body uniformly, so
  repro also differentiates the last chunk's state update (which the loss
  never reads) and the first chunk's zero initial state; autograd skips
  both. The walker's excess is exactly 3 products of 2 B H T P N and 2 of
  2 B T H N FLOPs per Mamba2 layer, and their bytes.

Unit cases: products by shape, the same counts on cpu and meta (a sharded
MoE train step with and without remat, on a (2, 2, 2) mesh, where the meta
mesh runs one cell and one period for all), and the collectives' reports
forward and backward on a (2, 4) mesh with their gradients unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import costs as jcosts
from repro.models import rwkv as j_rwkv
from repro.models.model import build_model as j_build_model
from repro.train.loop import make_train_step as j_make_train_step
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.configs import get_config
from repro_torch.distributed import mesh as tmesh
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.launch.costs import CostCounter
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.model import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from repro_torch.train.optimizer import OptConfig

B, S = 2, 16
KINDS = ("prefill", "decode", "train")
INDEX_RATIO = (0.4, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# both sides of one (arch, kind)
# ---------------------------------------------------------------------------
def _j_classes(closed) -> dict:
    """repro's walker, split as the counter splits: FLOPs, dot bytes, the
    top-level inputs' bytes, and the rest of its major bytes."""
    dot = 0.0

    def walk(jaxpr, mult):
        nonlocal dot
        for e in jaxpr.eqns:
            if e.primitive.name in ("dot_general", "conv_general_dilated"):
                dot += mult * sum(jcosts._nbytes(v.aval) for v in (*e.invars, *e.outvars))
            for sub, extra, _ in jcosts._sub_jaxprs(e):
                walk(getattr(sub, "jaxpr", sub), mult * extra)

    walk(closed.jaxpr, 1.0)
    total = jcosts.jaxpr_cost(closed)
    inputs = sum(jcosts._nbytes(v.aval) for v in closed.jaxpr.invars)
    return {"flops": total["flops"], "dot": dot, "inputs": inputs,
            "index": total["bytes"] - dot - inputs}


def _extras(cfg, shaped):
    out = {}
    if cfg.frontend == "audio_stub":
        out["frames"] = shaped((B, cfg.enc_seq, cfg.d_model))
    if cfg.frontend == "vision_stub":
        out["prefix_embeddings"] = shaped((B, cfg.n_prefix_embeddings, cfg.d_model))
    return out


def _repro_counts(arch: str, kind: str) -> dict:
    cfg = j_get_config(arch, smoke=True)
    m = j_build_model(cfg)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    ex = _extras(cfg, lambda s: jax.ShapeDtypeStruct(s, jnp.float32))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    one = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    caches = jax.eval_shape(lambda: m.init_caches(B, S + 8))
    if kind == "train":
        opt = jax.eval_shape(lambda p: j_init_opt_state(p, JOptConfig()), params)
        fn, args = j_make_train_step(m, JOptConfig()), (
            {"params": params, "opt": opt}, {"tokens": tok, "labels": tok, **ex})
    elif kind == "prefill":
        fn, args = (lambda p, t, c, b: m.prefill(p, t, c, b)), (params, tok, caches, ex or None)
    else:
        fn, args = (lambda p, t, pos, c: m.decode_step(p, t, pos, c)), (params, one, one, caches)
    return _j_classes(jax.make_jaxpr(fn)(*args))


def _port_counts(arch: str, kind: str, device: str = "meta") -> CostCounter:
    cfg = get_config(arch, smoke=True)
    ex = _extras(cfg, lambda s: torch.zeros(s, device=device))
    tok = torch.zeros((B, S), dtype=torch.int32, device=device)
    one = tok[:, :1].clone()
    counter = CostCounter()
    if kind == "train":
        model = build_model(cfg, device=device, requires_grad=True, rwkv_kernel=False)
        state = init_train_state(model, OptConfig())
        batch = {"tokens": tok, "labels": tok, **ex}
        with counter:
            counter.read_inputs((state, batch))
            make_train_step(model, OptConfig())(state, batch)
        return counter
    model = build_model(cfg, device=device)
    caches = model.init_caches(B, S + 8)
    params = dict(model.named_parameters())
    with torch.inference_mode(), counter:
        if kind == "prefill":
            counter.read_inputs((params, tok, caches, ex))
            model.prefill(tok, caches, ex or None)
        else:
            counter.read_inputs((params, one, one, caches))
            model.decode_step(one, one, caches)
    return counter


def _chunk_stand_in(xp):
    """A product-free chunk of the plain version's shapes (``xp``: jnp or
    torch), differentiable in every input."""
    def chunk(r, k, v, log_w, u, s0):
        y = r * k * v * log_w * u[None, None]
        s1 = s0 * (k * v).sum(1)[..., None] + log_w.sum(1)[..., None]
        return y, s1
    return chunk


@functools.cache
def _counts(arch: str, kind: str) -> tuple[dict, CostCounter]:
    return _repro_counts(arch, kind), _port_counts(arch, kind)


def _layers(cfg, kind: str) -> int:
    blocks = [*cfg.prefix_layers, *cfg.period * cfg.n_periods, *cfg.remainder]
    return sum(b.kind == kind for b in blocks)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", [a for a in J_ARCHS if a != "rwkv6-3b"])
def test_counter_matches_jaxpr_cost(arch, kind):
    want, got = _counts(arch, kind)
    flops, dot = want["flops"], want["dot"]
    if arch == "zamba2-2.7b" and kind == "train":
        cfg = get_config(arch, smoke=True)
        t, h = cfg.ssm_chunk, cfg.n_ssm_heads
        p, n = cfg.d_inner // h, cfg.ssm_state
        layers = _layers(cfg, "mamba2")
        flops -= layers * (3 * 2 * B * h * t * p * n + 2 * 2 * B * t * h * n)
        dot -= layers * 4 * (3 * B * h * t * p + 5 * B * t * h * n + 3 * B * h * p * n
                             + 2 * B * t * n + 2 * B * t * h)
    assert got.total_flops == flops
    assert got.bytes["dot"] == dot
    assert got.bytes["inputs"] == want["inputs"]
    ratio = got.bytes["index"] / want["index"]
    assert INDEX_RATIO[0] <= ratio <= INDEX_RATIO[1], ratio


@pytest.mark.parametrize("kind", KINDS)
def test_rwkv6_matches_jaxpr_cost_outside_the_chunk(kind, monkeypatch):
    """Everything outside ``rwkv6_chunk`` equal with the chunk stubbed on
    both sides; the port counts the chunk's reckoning once per call."""
    monkeypatch.setattr(j_rwkv, "rwkv6_chunk_ref", _chunk_stand_in(jnp))
    monkeypatch.setattr(t_rwkv, "rwkv6_chunk_ref", _chunk_stand_in(torch))
    want = _repro_counts("rwkv6-3b", kind)
    got = _port_counts("rwkv6-3b", kind)
    cfg = get_config("rwkv6-3b", smoke=True)
    h = cfg.n_heads
    calls = 0 if kind == "decode" else -(-S // cfg.ssm_chunk) * _layers(cfg, "rwkv6")
    flops, n_bytes = rwkv_ops.chunk_cost(B, cfg.ssm_chunk, h, cfg.d_model // h)
    assert got.total_flops - calls * flops[torch.float32] == want["flops"]
    assert got.bytes.get("rwkv6_chunk", 0) == calls * n_bytes
    assert got.bytes["dot"] == want["dot"]
    assert got.bytes["inputs"] == want["inputs"]
    ratio = got.bytes["index"] / want["index"]
    assert INDEX_RATIO[0] <= ratio <= INDEX_RATIO[1], ratio


def test_rwkv6_chunk_reckoning():
    """``4 T P (T + P)`` float32 FLOPs per (batch, head) and every input
    read once, every output written once: the kernel table's 36,710,400
    bytes at rwkv6-3b's prefill shape; counted once per call whether the
    plain version (cpu), the meta branch or the core's plain leg runs."""
    flops, n_bytes = rwkv_ops.chunk_cost(8, 64, 40, 64)
    assert n_bytes == 36_710_400
    assert flops == {torch.float32: 4 * 8 * 40 * 64 * 64 * (64 + 64)}
    b, t, h, p = 2, 8, 3, 16
    for device in ("cpu", "meta"):
        g = torch.Generator().manual_seed(0)
        r, k, v = (torch.randn(b, t, h, p, generator=g).to(device) for _ in range(3))
        lw = -torch.rand(b, t, h, p, generator=g).to(device)
        u, s0 = torch.randn(h, p).to(device), torch.randn(b, h, p, p).to(device)
        with CostCounter() as c:
            rwkv_ops.rwkv6_chunk(r, k, v, lw, u, s0)
        assert c.flops == {"float32": rwkv_ops.chunk_cost(b, t, h, p)[0][torch.float32]}
        assert dict(c.bytes) == {"rwkv6_chunk": rwkv_ops.chunk_cost(b, t, h, p)[1]}
        with CostCounter() as c:  # the plain leg: two chunks and a padded tail
            t_rwkv.rwkv6_chunked_core(r.repeat(1, 2, 1, 1)[:, :13], k.repeat(1, 2, 1, 1)[:, :13],
                                      v.repeat(1, 2, 1, 1)[:, :13], lw.repeat(1, 2, 1, 1)[:, :13],
                                      u, t, s0, use_kernel=False)
        assert c.bytes["rwkv6_chunk"] == 2 * rwkv_ops.chunk_cost(b, t, h, p)[1]


# ---------------------------------------------------------------------------
# unit cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_products_are_counted_by_shape(device):
    g = torch.Generator().manual_seed(1)
    a = torch.randn(8, 16, generator=g).to(device)
    w = torch.randn(16, 4, generator=g).to(device)
    x = torch.randn(3, 8, 16, generator=g).to(device)
    with CostCounter() as c:
        a @ w  # mm: 2 * 8 * 4 * 16
        torch.bmm(x, x.transpose(1, 2))  # 2 * 3 * 8 * 8 * 16
        torch.einsum("bij,jk->bik", x, w)  # 2 * 24 * 4 * 16
        torch.addmm(torch.zeros(8, 4, device=device), a, w)
        torch.nn.functional.conv1d(x, torch.randn(5, 8, 3, generator=g).to(device))
    assert c.flops == {"float32": 2 * 8 * 4 * 16 * 2 + 2 * 3 * 8 * 8 * 16 + 2 * 24 * 4 * 16
                       + 2 * (3 * 5 * 14) * (8 * 3)}
    with torch.inference_mode(), CostCounter() as c2:  # composites reach the mode whole
        torch.einsum("bij,jk->bik", x, w)
        torch.matmul(x, w)
    assert c2.flops == {"float32": 2 * 2 * 24 * 4 * 16}
    half = a.to(torch.bfloat16)
    with CostCounter() as c3:
        half @ w.to(torch.bfloat16)
    assert c3.flops == {"bfloat16": 2 * 8 * 4 * 16}
    assert c3.bytes["dot"] == 2 * (8 * 16 + 16 * 4 + 8 * 4)


def _sharded_step(device: str, remat: str) -> CostCounter:
    cfg = dataclasses.replace(get_config("deepseek-v3-671b", smoke=True), remat=remat)
    mesh = tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[device] * 8)
    model = build_model(cfg, device=device, requires_grad=True, moe_impl="sharded", mesh=mesh)
    tok = torch.zeros((8, 32), dtype=torch.int32, device=device)
    state = init_train_state(model, OptConfig())
    with CostCounter(n_devices=8, track_memory=True) as c:
        c.read_inputs((state, tok))
        make_train_step(model, OptConfig())(state, {"tokens": tok, "labels": tok})
    return c


@pytest.mark.parametrize("remat", ["none", "full"])
def test_sharded_train_step_counts_the_same_on_cpu_and_meta(remat):
    """A (2, 2, 2) mesh of the meta device runs one cell for all eight and
    one period for both, and counts what the cpu mesh counts, the backward,
    the remat recompute and the collectives' transposes included."""
    cpu, meta = _sharded_step("cpu", remat), _sharded_step("meta", remat)
    assert meta.summary() == cpu.summary()
    coll = cpu.summary()["collective"]
    assert coll["all-to-all"] > 0 and coll["all-reduce"] > 0


def _collective_cases():
    m = tmesh
    return {
        "psum": ("all-reduce", lambda ps: m.psum(ps), 2.0, lambda ps: m._psum(ps)),
        "psum_scatter": ("reduce-scatter", lambda ps: m.psum_scatter(ps, 1),
                         1.0, lambda ps: m._psum_scatter(ps, 1, True)),
        "all_gather": ("all-gather", lambda ps: m.all_gather(ps, 0, tiled=True),
                       3.0, lambda ps: m._all_gather(ps, 0, True)),
        "all_to_all": ("all-to-all", lambda ps: m.all_to_all(ps, 0, 1, tiled=True),
                       1.0, lambda ps: m._all_to_all(ps, 0, 1, True)),
        "all_to_all_untiled": ("all-to-all", lambda ps: m.all_to_all(ps, 0, 1),
                               1.0, lambda ps: m._all_to_all(ps, 0, 1, False)),
    }


TRANSPOSE = {"all-reduce": "all-reduce", "reduce-scatter": "all-gather",
             "all-gather": "reduce-scatter", "all-to-all": "all-to-all"}


@pytest.mark.parametrize("name", list(_collective_cases()))
def test_collectives_report_forward_and_transpose(name):
    """Over the ``model`` groups of a (2, 4) mesh: the forward reports its
    kind, the backward its transpose's (with the transpose's wire factor),
    bytes per device; gradients equal plain autograd of the composition."""
    kind, fn, factor, plain = _collective_cases()[name]
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    g = torch.Generator().manual_seed(3)
    leaves = {c: torch.randn(4, 8, generator=g, requires_grad=True) for c in mesh.cells()}

    def run(f):
        outs = {}
        for group in mesh.groups("model"):
            for c, got in zip(group, f([leaves[c] for c in group])):
                outs[c] = got
        weights = {c: torch.full_like(v, float(i + 1)) for i, (c, v) in enumerate(outs.items())}
        loss = sum((v * weights[c]).sum() for c, v in outs.items())
        return outs, torch.autograd.grad(loss, list(leaves.values()))

    with CostCounter(n_devices=8) as c:
        outs, grads = run(fn)
    want_outs, want_grads = run(plain)
    for cell in outs:
        assert torch.equal(outs[cell], want_outs[cell])
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    payload = 4 * 8 * 4  # every cell's part, the bytes of one device
    out_bytes = next(iter(outs.values())).numel() * 4
    back = {"all-reduce": 2 * out_bytes, "reduce-scatter": out_bytes,
            "all-gather": 3 * out_bytes, "all-to-all": out_bytes}[TRANSPOSE[kind]]
    want = {kind: factor * payload}
    want[TRANSPOSE[kind]] = want.get(TRANSPOSE[kind], 0) + back
    assert dict(c.collective_bytes) == want


def test_meta_mesh_collectives_report_every_cell():
    """On a meta mesh a per-cell value is one tensor: the collectives build
    one result and report every cell's payload, forward and backward."""
    mesh = tmesh.make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)
    x = torch.empty(4, 4, 6, device="meta", requires_grad=True)
    parts = mesh.map_cells(lambda v: v * 2, dict.fromkeys(mesh.cells(), (x,)))
    with CostCounter(n_devices=8) as c:
        got = {}
        for group in mesh.groups("model"):
            got.update(zip(group, tmesh.all_to_all([parts[cell] for cell in group], 0, 0)))
        summed = tmesh.psum([got[cell] for cell in mesh.cells()])
        (gx,) = torch.autograd.grad(summed[0].sum(), [x])
    assert gx.shape == x.shape
    # one tensor for every cell of a group
    assert len({id(v) for v in got.values()}) == len(mesh.groups("model"))
    part = 4 * 4 * 6 * 4  # one cell's bytes
    assert dict(c.collective_bytes) == {"all-to-all": 2 * part, "all-reduce": 2 * 2.0 * part}


@pytest.mark.parametrize("split,concat,tiled", [(0, 0, False), (0, 1, False), (1, 0, False),
                                                (2, 1, False), (0, 1, True), (1, 2, True)])
def test_meta_all_to_all_has_the_card_shape(split, concat, tiled):
    """One meta value's all-to-all, built once, has every cell's shape on a
    mesh of real cells."""
    n = 4
    shape = [4, 4, 4]
    parts = [torch.zeros(shape) for _ in range(n)]
    want = tmesh.all_to_all(parts, split, concat, tiled)
    meta = torch.empty(shape, device="meta")
    got = tmesh.all_to_all([meta] * n, split, concat, tiled)
    assert [g.shape for g in got] == [w.shape for w in want]
