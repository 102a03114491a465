"""The slice as a whole: the port's Table-V session pool against repro's.

A full-width Table-V pool (1536 neurons, 6 cores, K=1024; pool of 3,
max_steps=25, as tests/test_serving.py runs it) serves the same sessions in
both packages. Per-session prediction, decided flag, latency, counts, drops
and errors are identical: the engine's drive and spikes are bit-exact on this
path (spikes 0/1, input an event count times 8.0). Also here: the typed pool
errors, the offline-Hebbian calibration run, and the port's independence
from JAX.
"""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import cnn as jcnn
from repro.data import pipeline as jpipe
from repro.serve import aer as jaer
from repro_torch.core import cnn as tcnn
from repro_torch.data import pipeline as tpipe
from repro_torch.serve import aer as taer

REPO = Path(__file__).resolve().parents[1]
PORT_BACKENDS = ["reference", "cuda", "fused"]


class _BadPacketSource:
    """Well-formed stream that emits one garbage packet at ``bad_at``."""

    def __init__(self, bad_at: int):
        self.bad_at = bad_at

    def events(self, step: int) -> np.ndarray:
        if step == self.bad_at:
            return np.array([[5, -1]])  # negative coordinate
        return np.array([[15, 15], [16, 15]])


def _sessions(aer, pipe, n=6, seed=9):
    out = [
        aer.DvsSession(
            i,
            pipe.DvsStreamSource(
                pipe.DvsStreamConfig(symbol=i % 4, events_per_step=16, seed=seed), session_id=i
            ),
            label=i % 4,
            tenant=i % 2,
        )
        for i in range(n)
    ]
    out.insert(3, aer.DvsSession(99, _BadPacketSource(bad_at=3), label=1, tenant=0))
    return out


def _summary(results):
    return [
        (r.session_id, r.label, r.prediction, r.decided, r.latency_steps,
         r.counts.tolist(), r.dropped, r.error)
        for r in results
    ]


def _serve_repro(cfg_kw, fc_select=None):
    cc = jcnn.compile_poker_cnn(fc_select=fc_select)
    pool = jaer.AerSessionPool(cc, jaer.build_poker_engine(cc.tables), jaer.AerServeConfig(**cfg_kw))
    return _summary(pool.serve(_sessions(jaer, jpipe))), pool.n_steps


def _serve_port(cfg_kw, backend, fc_select=None):
    cc = tcnn.compile_poker_cnn(fc_select=fc_select)
    eng = taer.build_poker_engine(cc.tables, backend=backend, device="cpu")
    pool = taer.AerSessionPool(cc, eng, taer.AerServeConfig(**cfg_kw))
    return _summary(pool.serve(_sessions(taer, tpipe))), pool.n_steps


_CFG = {"pool_size": 3, "max_steps": 25, "max_inflight_per_tenant": 2}


@pytest.fixture(scope="module")
def repro_results():
    return _serve_repro(_CFG)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_pool_sessions_identical_to_repro(repro_results, backend):
    """Six DVS sessions plus one that sends a malformed packet, from two
    tenants capped at two slots each, through a pool of three slots."""
    got, n_steps = _serve_port(_CFG, backend)
    want, want_steps = repro_results
    assert got == want
    assert n_steps == want_steps
    bad = [r for r in got if r[0] == 99][0]
    assert bad[-1] is not None and "outside" in bad[-1] and not bad[3]
    assert sum(r[2] == r[1] for r in got if r[0] != 99) >= 4


def test_tuned_readout_and_pool_match_repro():
    """The offline-Hebbian calibration run selects the same readout as
    examples/poker_dvs_serve.py, and the tuned pool serves identically."""
    spec = importlib.util.spec_from_file_location(
        "poker_dvs_serve_example", REPO / "examples" / "poker_dvs_serve.py"
    )
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    want = example.tune_readout(np.random.default_rng(7))
    got = taer.tune_poker_readout("cpu", np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    cfg = {"pool_size": 4, "max_steps": 25}
    port, _ = _serve_port(cfg, "fused", fc_select=got)
    assert port == _serve_repro(cfg, fc_select=want)[0]
    good = [r for r in port if r[0] != 99]
    assert all(r[2] == r[1] for r in good)  # tuned readout: every suit right


def test_pool_errors_where_repro_raises():
    for aer, cnn, pipe, kw in (
        (jaer, jcnn, jpipe, {}),
        (taer, tcnn, tpipe, {"device": "cpu"}),
    ):
        cc = cnn.compile_poker_cnn()
        pool = aer.AerSessionPool(cc, aer.build_poker_engine(cc.tables, **kw),
                                  aer.AerServeConfig(pool_size=2, max_steps=25))
        sess = _sessions(aer, pipe)
        assert [pool.admit(sess[0]), pool.admit(sess[1])] == [0, 1]
        with pytest.raises(aer.PoolFullError, match="full"):
            pool.admit(sess[2])
        pool.step()
        r = pool.evict(0)
        assert r.session_id == 0 and r.latency_steps == 1 and pool.free_slots == [0]
        with pytest.raises(aer.SlotError, match="not occupied"):
            pool.evict(0)
        with pytest.raises(aer.SlotError, match="out of range"):
            pool.evict(2)
        # a bad id in a batch leaves earlier slots untouched
        with pytest.raises(aer.SlotError):
            pool.evict_many([1, 5])
        assert pool.occupied == [1]
        assert pool.admit(sess[4]) == 0
    with pytest.raises(ValueError, match="pool_size must be positive"):
        taer.AerSessionPool(cc, taer.build_poker_engine(cc.tables, device="cpu"),
                            taer.AerServeConfig(pool_size=0))


def test_build_poker_engine_defaults_to_cuda():
    cc = tcnn.compile_poker_cnn()
    if torch.cuda.is_available():
        assert taer.build_poker_engine(cc.tables).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            taer.build_poker_engine(cc)
    eng = taer.build_poker_engine(cc, backend="fused", device="cpu")
    assert eng.queue_capacity == 1536 and eng.backend.name == "fused"


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------
_FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def test_port_imports_no_jax_and_no_repro():
    """A fresh interpreter imports every repro_torch module; no jax* or
    repro.* module is loaded."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_import_no_jax_and_no_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)
