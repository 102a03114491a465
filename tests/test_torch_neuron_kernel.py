"""The AdExp/DPI neuron step's CUDA kernel (``kernels/neuron_step``) and its
dispatch in ``core/neuron.py``.

On the card (marked ``cuda``, skipped without a GPU): the kernel equals the
eager step bit for bit on random states that hold refractory neurons,
neurons crossing ``v_peak``, strong shunting and both ends of the clamped
exponential, with and without an external current; one launch per call;
one per engine step; inputs that broadcast take the kernel, and other dtypes
and inputs that require grad raise instead of leaving it. On the CPU: the eager leg runs and no kernel launches;
the kernel is one library, built by ``kernels/_build.py`` like the others,
whatever the process or the parameter set. The file imports neither JAX nor
repro, so the card's machine runs it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_neuron_kernel.py
"""

import dataclasses
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import neuron
from repro_torch.kernels import _build
from repro_torch.kernels.neuron_step import ops as kernel_ops

ROOT = _build._REPO_ROOT


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _random_step(b: int, n: int, seed: int, with_ext: bool, device="cpu"):
    """A state, a drive and maybe an external current that reach every
    branch of the step: one neuron in eight far below threshold (the
    exponent clamped at -20), one far above it (clamped at 20), one exactly
    at ``v_peak``, one with exactly ``dt`` of refractory time left; about a
    third refractory; shunting currents up to 20 (a leak gain of 101);
    integer event drives (8.0 an event) mixed with arbitrary floats."""
    g = torch.Generator().manual_seed(seed)
    shape = (b, n)

    def uniform(lo, hi, *size):
        return lo + (hi - lo) * torch.rand(*size, generator=g)

    kind = torch.randint(0, 8, shape, generator=g)
    v = uniform(-0.08, 0.005, *shape)
    v = torch.where(kind == 0, uniform(-0.5, -0.2, *shape), v)
    v = torch.where(kind == 1, uniform(0.05, 0.3, *shape), v)
    v = torch.where(kind == 2, torch.zeros(shape), v)
    refrac = torch.where(torch.rand(shape, generator=g) < 0.3, uniform(0.0, 3e-3, *shape),
                         torch.zeros(shape))
    refrac = torch.where(kind == 3, torch.full(shape, 1e-3), refrac)
    i_syn = uniform(0.0, 2.0, b, n, 4)
    i_syn[..., 3] *= 10.0
    drive = torch.randint(0, 5, (b, n, 4), generator=g).float() * 8.0
    drive = torch.where(torch.rand(b, n, 4, generator=g) < 0.5, uniform(0.0, 40.0, b, n, 4), drive)
    state = neuron.NeuronState(v=v, w=uniform(0.0, 0.05, *shape), refrac=refrac, i_syn=i_syn)
    i_ext = torch.randn(shape, generator=g) * 2.0 if with_ext else None
    move = (lambda t: None if t is None else t.to(device))
    state = neuron.NeuronState(**{f.name: move(getattr(state, f.name))
                                  for f in dataclasses.fields(neuron.NeuronState)})
    return state, move(drive), move(i_ext)


def _assert_equal(a_state, a_spikes, b_state, b_spikes):
    for f in dataclasses.fields(neuron.NeuronState):
        x, y = getattr(a_state, f.name), getattr(b_state, f.name)
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        assert torch.equal(x, y), f"{f.name}: {(x != y).sum().item()} of {x.numel()} differ"
    assert torch.equal(a_spikes, b_spikes)


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("with_ext", [False, True], ids=["no_i_ext", "i_ext"])
@pytest.mark.parametrize("n", [1, 255, 1536])
@pytest.mark.parametrize("b", [1, 7, 8192])
def test_kernel_equals_the_eager_step_bit_for_bit(cuda, b, n, with_ext):
    params = neuron.NeuronParams()
    state, drive, i_ext = _random_step(b, n, 1000 * b + n, with_ext, cuda)
    before = {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
    launches = kernel_ops.neuron_step.launches
    k_state, k_spikes = neuron.neuron_step(state, drive, params, i_ext)
    assert kernel_ops.neuron_step.launches == launches + 1
    e_state, e_spikes = neuron.neuron_step_eager(state, drive, params, i_ext)
    torch.cuda.synchronize()
    assert kernel_ops.neuron_step.launches == launches + 1
    _assert_equal(k_state, k_spikes, e_state, e_spikes)
    for name, t in before.items():  # the state passed in is left as it was
        assert torch.equal(getattr(state, name), t)
    if b * n >= 255:
        assert 0 < int(k_spikes.sum()) < b * n
        assert int((state.refrac > 0).sum()) > 0


@pytest.mark.cuda
def test_kernel_equals_the_eager_step_on_slices_and_other_parameters(cuda):
    """Column slices of a wider state (as a mesh cell's share of the
    neurons) and a parameter set of other numbers: copied dense, one launch."""
    params = neuron.NeuronParams(tau_m=13e-3, delta_t=3e-3, tau_w=70e-3, shunt_gain=2.5,
                                 tau_syn=(3e-3, 50e-3, 7e-3, 11e-3), w_syn=(0.5, 0.2, 2.0, 1.5))
    state, drive, i_ext = _random_step(64, 512, 7, True, cuda)
    cut = neuron.NeuronState(v=state.v[:, 100:356], w=state.w[:, 100:356],
                             refrac=state.refrac[:, 100:356], i_syn=state.i_syn[:, 100:356])
    assert not cut.v.is_contiguous()
    launches = kernel_ops.neuron_step.launches
    got = neuron.neuron_step(cut, drive[:, 100:356], params, i_ext[:, 100:356])
    assert kernel_ops.neuron_step.launches == launches + 1
    _assert_equal(*got, *neuron.neuron_step_eager(cut, drive[:, 100:356], params,
                                                  i_ext[:, 100:356]))


@pytest.mark.cuda
def test_broadcast_drive_and_current_take_the_kernel(cuda):
    """A drive and an external current shared by every stream (``[N, 4]``
    and ``[N]`` against a ``[B, N]`` state) reach the kernel expanded."""
    params = neuron.NeuronParams()
    state, drive, i_ext = _random_step(16, 255, 3, True, cuda)
    launches = kernel_ops.neuron_step.launches
    got = neuron.neuron_step(state, drive[0], params, i_ext[0])
    assert kernel_ops.neuron_step.launches == launches + 1
    _assert_equal(*got, *neuron.neuron_step_eager(state, drive[0], params, i_ext[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("odd", ["float64", "requires_grad"])
def test_card_inputs_the_kernel_cannot_take_raise(cuda, odd):
    """On the card there is no silent eager leg: a dtype other than float32,
    or a leaf that requires grad, is refused before any launch."""
    state, drive, _ = _random_step(4, 33, 5, False, cuda)
    if odd == "float64":
        state = neuron.NeuronState(**{f.name: getattr(state, f.name).double()
                                      for f in dataclasses.fields(state)})
        drive = drive.double()
    else:
        drive = drive.requires_grad_()
    launches = kernel_ops.neuron_step.launches
    with pytest.raises(ValueError, match="float32 CUDA"):
        neuron.neuron_step(state, drive, neuron.NeuronParams())
    assert kernel_ops.neuron_step.launches == launches


@pytest.mark.cuda
def test_engine_launches_the_kernel_once_a_step(cuda):
    from repro_torch.core.cnn import CnnConfig, compile_poker_cnn
    from repro_torch.serve.aer import build_poker_engine

    cnn = compile_poker_cnn(CnnConfig())
    rng = np.random.default_rng(5)
    for backend in ("fused", "fabric"):
        engine = build_poker_engine(cnn, backend, device=cuda)
        carry = engine.init_state(batch=4)
        act = torch.as_tensor(
            rng.integers(0, 2, (6, 4, engine.n_clusters, engine.k_tags)) * 8.0,
            dtype=torch.float32, device=cuda)
        launches = kernel_ops.neuron_step.launches
        engine.run(carry, act)
        torch.cuda.synchronize()
        assert kernel_ops.neuron_step.launches == launches + 6, backend


@pytest.mark.cuda
def test_kernel_info_reports_no_spills(cuda):
    info = kernel_ops.kernel_info()
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 4 and info["registers"] > 0


# -- on the CPU -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_ext", [False, True], ids=["no_i_ext", "i_ext"])
def test_cpu_inputs_take_the_eager_leg(dtype, with_ext):
    params = neuron.NeuronParams()
    state, drive, i_ext = _random_step(3, 17, 11, with_ext)
    state = neuron.NeuronState(**{f.name: getattr(state, f.name).to(dtype)
                                  for f in dataclasses.fields(state)})
    drive = drive.to(dtype)
    i_ext = None if i_ext is None else i_ext.to(dtype)
    launches = kernel_ops.neuron_step.launches
    got = neuron.neuron_step(state, drive, params, i_ext)
    assert kernel_ops.neuron_step.launches == launches
    _assert_equal(*got, *neuron.neuron_step_eager(state, drive, params, i_ext))


def test_the_wrapper_refuses_cpu_tensors():
    state, drive, _ = _random_step(2, 3, 0, False)
    decay, ws = neuron._synapse_constants(neuron.NeuronParams(), torch.float32,
                                          torch.device("cpu"))
    with pytest.raises(ValueError, match="float32 CUDA"):
        kernel_ops.neuron_step(state.v, state.w, state.refrac, state.i_syn, drive, None, decay,
                               ws, neuron.NeuronParams())


def test_build_sources_list_the_kernel():
    src = _build.sources()["neuron_step"]
    assert src == ROOT / "src/repro_torch/kernels/neuron_step/csrc/neuron_step.cu"
    # a header of its own would enter every library's hash
    assert not any("neuron_step" in str(h) for h in _build.headers())


def test_one_library_for_every_process_and_parameter_set():
    """The library's name hashes its source, the shared headers and the
    flags alone: two fresh interpreters and two parameter sets find the same
    file, and the parameters reach the kernel as arguments."""
    code = "from repro_torch.kernels._build import library_path; print(library_path('neuron_step'))"
    paths = {
        subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                       env={"PYTHONPATH": str(ROOT / "src")}, timeout=120).stdout.strip()
        for _ in range(2)
    }
    assert paths == {str(_build.library_path("neuron_step"))}
    a, b = neuron.NeuronParams(), neuron.NeuronParams(tau_m=10e-3, v_peak=5e-3)
    assert list(kernel_ops.constants(a)) != list(kernel_ops.constants(b))
    here = _build.library_path("neuron_step")
    kernel_ops.constants(b)
    assert _build.library_path("neuron_step") == here


def test_constants_are_the_float32_numbers_of_the_eager_operations():
    params = neuron.NeuronParams()
    got = dict(zip(kernel_ops.CONSTANTS, kernel_ops.constants(params)))
    f32 = np.float32
    for name, value in got.items():
        if name.startswith("inv_"):
            assert value == f32(1.0 / getattr(params, name[4:]))
        else:
            assert value == f32(getattr(params, name))
    assert got["inv_delta_t"] == 500.0 != f32(1.0) / f32(params.delta_t)
    assert kernel_ops.constants(params) is kernel_ops.constants(neuron.NeuronParams())


def test_constants_follow_the_kernel_struct():
    """The wrapper's order of numbers is the kernel's ``Constants`` struct."""
    text = _build.sources()["neuron_step"].read_text()
    body = re.search(r"struct Constants \{\s*float ([^;]*);", text).group(1)
    assert tuple(x.strip() for x in body.split(",")) == kernel_ops.CONSTANTS
