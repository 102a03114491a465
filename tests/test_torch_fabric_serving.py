"""The fabric slice as a whole: the Table-V pool served over the executable
mesh, in the port against repro.

A full-width Table-V pool (1536 neurons, 6 cores of 256 on the default 3x3
fabric, K = 1024; pool of 3, max_steps = 25, the sessions of
tests/test_torch_serving.py) serves the same sessions through
``build_poker_engine(tables, "fabric")`` in both packages. Cross-tile events
arrive one step late, so every session decides later than on the queued
path; with ``link_capacity = 8`` the links drop events. Per session,
prediction, decided flag, latency, counts, AER drops, link drops and error
are identical (drive and spikes are bit-exact on this path: spikes are 0/1,
input is an event count times 8.0), and so is the pool's step count.
"""

import numpy as np
import pytest

from repro.core import cnn as jcnn
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro_torch.core import cnn as tcnn
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer
from tests.test_torch_serving import _sessions

_CFG = {"pool_size": 3, "max_steps": 25, "max_inflight_per_tenant": 2}


def _summary(results):
    return [
        (r.session_id, r.label, r.prediction, r.decided, r.latency_steps,
         r.counts.tolist(), r.dropped, r.link_dropped, r.error)
        for r in results
    ]


def _serve(aer, cnn, pipe, fabric_options, **kw):
    cc = cnn.compile_poker_cnn()
    eng = aer.build_poker_engine(cc.tables, "fabric", fabric_options=fabric_options, **kw)
    pool = aer.AerSessionPool(cc, eng, aer.AerServeConfig(**_CFG))
    return _summary(pool.serve(_sessions(aer, pipe))), pool.n_steps


@pytest.fixture(scope="module", params=[None, {"link_capacity": 8}], ids=["default", "cap8"])
def served(request):
    opts = request.param
    want = _serve(jaer, jcnn, jpipe, opts)
    got = _serve(taer, tcnn, tpipe, opts, device="cpu")
    return opts, want, got


def test_fabric_pool_sessions_identical_to_repro(served):
    opts, (want, want_steps), (got, n_steps) = served
    assert got == want
    assert n_steps == want_steps
    link_dropped = sum(r[7] for r in got)
    assert (link_dropped > 0) == (opts is not None)
    bad = [r for r in got if r[0] == 99][0]
    assert bad[-1] is not None and "outside" in bad[-1] and not bad[3]


def test_fabric_pool_decides_later_than_queued(served):
    """Cross-tile events arrive a step late: every session's decision comes
    at least as late as on the queued path, some strictly later."""
    opts, _, (got, _) = served
    cc = tcnn.compile_poker_cnn()
    pool = taer.AerSessionPool(cc, taer.build_poker_engine(cc.tables, device="cpu"),
                               taer.AerServeConfig(**_CFG))
    queued = {r[0]: r for r in _summary(pool.serve(_sessions(taer, tpipe)))}
    later = [r[4] - queued[r[0]][4] for r in got if r[0] != 99]
    assert min(later) >= 0 and max(later) > 0
    assert all(queued[r[0]][7] == 0 for r in got)  # no links on the queued path


@pytest.mark.parametrize("options", [{"ring": False}, {"per_link_stats": True}])
def test_fabric_pool_modes_agree(options):
    """The roll carry and the per-link stats mode serve the same sessions
    as the default ring mode (per-link drops summed per session)."""
    cap = {"link_capacity": 8}
    base, base_steps = _serve(taer, tcnn, tpipe, cap, device="cpu")
    got, n_steps = _serve(taer, tcnn, tpipe, {**cap, **options}, device="cpu")
    assert got == base and n_steps == base_steps


def test_fabric_options_need_the_fabric_backend():
    cc = tcnn.compile_poker_cnn()
    with pytest.raises(ValueError, match="fabric_options need the fabric backend"):
        taer.build_poker_engine(cc.tables, "fused", fabric_options={}, device="cpu")
    eng = taer.build_poker_engine(cc, "fabric", device="cpu")
    assert eng.fabric_ring and eng.fabric_model.max_delay == 1
    assert eng.fabric_model.link_capacity == 400_000
    assert eng._fabric_entries.src.shape == (1280,)
    ring, cursor = eng.init_state(batch=2)[2:]
    assert ring.shape == (2, 2, 6, 1024) and cursor.ndim == 0
