"""``EventEngine.run`` over zero steps, the port against repro.

``repro``'s ``run`` is a ``jax.lax.scan``: over zero steps it returns the
carry as it was and empty stacks ``[0, ...]`` of each per-step output, with
the per-step shape and dtype. The port must return the same, in the three
modes that stack different outputs: no queue (spikes alone), a queue of 64
(spikes and ``DeliveryStats.dropped``) and the fabric's ring (spikes and all
six ``DeliveryStats`` fields). Table-V tables, B = 2. Shapes and dtypes are
held equal; the carry is held bit-equal to the one passed in and to repro's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.core import event_engine as jee
from repro.serve import aer as jaer
from repro_torch.core import cnn as tcnn
from repro_torch.core import event_engine as tee
from repro_torch.serve import aer as taer

B = 2
MODES = ["no_queue", "queue_64", "fabric_ring"]


@pytest.fixture(scope="module")
def tables():
    return jcnn.compile_poker_cnn().tables, tcnn.compile_poker_cnn().tables


def _engines(mode, tables):
    jt, tt = tables
    if mode == "fabric_ring":
        return (jaer.build_poker_engine(jt, "fabric"),
                taer.build_poker_engine(tt, "fabric", device="cpu"))
    cap = None if mode == "no_queue" else 64
    return (jee.EventEngine(jt, queue_capacity=cap),
            tee.EventEngine(tt, queue_capacity=cap, device="cpu"))


def _leaves(tree):
    """Flat list of the arrays in a carry or an output (NeuronState and
    DeliveryStats fields in declaration order, ``None`` kept)."""
    if tree is None or isinstance(tree, (torch.Tensor, jnp.ndarray, np.ndarray)):
        return [tree]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for name in tree.__dataclass_fields__ for x in _leaves(getattr(tree, name))]
    if hasattr(tree, "_fields"):  # a NamedTuple
        return [x for name in tree._fields for x in _leaves(getattr(tree, name))]
    return [x for item in tree for x in _leaves(item)]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _inputs(tables, steps):
    jt = tables[0]
    return np.zeros((steps, B, jt.n_clusters, jt.k_tags), np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_run_zero_steps_matches_repro(mode, tables):
    jeng, teng = _engines(mode, tables)
    jc0, tc0 = jeng.init_state(batch=B), teng.init_state(batch=B)
    kept = [None if x is None else x.clone() for x in _leaves(tc0)]
    inp = _inputs(tables, 0)
    jc, jout = jeng.run(jc0, jnp.asarray(inp))
    tc, tout = teng.run(tc0, inp)
    want, got = _leaves(jout), _leaves(tout)
    assert len(got) == len(want)
    for j, t in zip(want, got):
        assert (j is None) == (t is None)
        if j is None:
            continue
        assert tuple(t.shape) == tuple(np.shape(j)) and t.shape[0] == 0
        assert _dtype_name(t) == _dtype_name(j)
    if mode == "no_queue":
        assert isinstance(tout, torch.Tensor) and tout.shape == (0, B, teng.n_neurons)
    else:
        assert tout[1].dropped.shape == (0, B)
        assert (tout[1].link_dropped is None) == (mode != "fabric_ring")
    # the carry comes back as it went in, and as repro's does
    assert len(_leaves(tc)) == len(_leaves(jc)) == len(kept)
    for before, after, j in zip(kept, _leaves(tc), _leaves(jc)):
        assert torch.equal(after, before)
        np.testing.assert_array_equal(after.numpy(), np.asarray(j))
        assert _dtype_name(after) == _dtype_name(j)


@pytest.mark.parametrize("mode", MODES)
def test_run_zero_steps_has_the_per_step_shapes_of_a_run(mode, tables):
    """The empty stacks are a real run's stacks cut to zero steps."""
    _, teng = _engines(mode, tables)
    _, empty = teng.run(teng.init_state(batch=B), _inputs(tables, 0))
    _, three = teng.run(teng.init_state(batch=B), _inputs(tables, 3))
    for e, t in zip(_leaves(empty), _leaves(three)):
        assert (e is None) == (t is None)
        if e is not None:
            assert e.shape[1:] == t.shape[1:] and e.shape[0] == 0 and t.shape[0] == 3
            assert e.dtype == t.dtype
