"""A CPU rehearsal of the arithmetic of the CUDA ``rwkv6_chunk`` kernel.

``csrc/rwkv6_chunk.cu`` cuts the chunk into sub-chunks of 16 tokens. With
``cum`` the inclusive cumulative log decay and ``cum_prev = cum - log_w``,
for a query sub-chunk J starting at token j0 and a key sub-chunk I < J ending
at token i1, every pairwise decay of the block factors into three terms whose
exponents are all <= 0 (``cum`` is non-increasing):

    exp(cum_prev[t] - cum[i]) = exp(cum_prev[t] - cum_prev[j0])
                                * exp(cum_prev[j0] - cum[i1])
                                * exp(cum[i1] - cum[i])

so the off-diagonal blocks of the a matrix are plain matrix products of
decayed r and k, and only the 16 x 16 diagonal blocks keep the difference
form. The products run on tensor cores in 3xTF32: each float32 operand x is
split into hi = tf32(x) and lo = tf32(x - hi), and a.b is taken as
hi.hi + hi.lo + lo.hi. :func:`subchunk_chunk` models that arithmetic here in
plain PyTorch (TF32 rounding emulated on the bits), and the tests hold it to
``rwkv6_chunk_ref`` and to repro's Pallas kernel in interpret mode at
allclose(rtol=1e-4, atol=1e-5), the kernel's own tolerance, over ragged
chunk lengths and down to decays of -90 per token. A last test shows that
plain TF32 products (hi.hi alone) miss that tolerance, which is why the
kernel pays for three products.

Two things outside the model would otherwise decide these comparisons:
- PyTorch's multi-threaded CPU ``exp`` was seen to return, in some
  processes, values 1.5e-4 off in relative terms (one thread gives the
  correctly rounded results, every time). The module runs PyTorch on one
  thread.
- At the extreme decay ``cum`` reaches about -300, where one float32 ulp is
  3e-5: cumulative sums taken in another order (XLA's against PyTorch's)
  move every exponent by that much, and repro's two functions then differ
  from ``rwkv6_chunk_ref`` by more than the tolerance themselves. So the
  model is held to ``rwkv6_chunk_ref`` (which takes its cumulative sum as
  the model does) on the draw as it is, and to repro's functions on the
  same draw rounded to multiples of 2**-10, where every order of summation
  gives the same ``cum`` exactly.

The model lives here, on no path: the card runs the kernel, and the CPU
runs ``rwkv6_chunk_ref``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import rwkv6_chunk_ref as j_chunk_ref
from repro.kernels.rwkv6.rwkv6 import rwkv6_chunk_pallas
from repro_torch.kernels.rwkv6.ref import rwkv6_chunk_ref

SUB = 16  # tokens per sub-chunk, the kernel's tensor-core tile height
TOL = {"rtol": 1e-4, "atol": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands: 3 passes is 3xTF32, 1 pass plain TF32."""
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def subchunk_chunk(r, k, v, log_w, u, s0, passes: int = 3):
    """The kernel's algorithm on [B, T, H, P] float32 inputs."""
    bsz, t_len, h, p = r.shape
    # per (batch, head): [B, H, T, P]
    r, k, v, log_w = (x.permute(0, 2, 1, 3) for x in (r, k, v, log_w))
    cum = torch.cumsum(log_w, dim=2)
    cp = cum - log_w
    starts = list(range(0, t_len, SUB))
    ends = [min(s + SUB, t_len) for s in starts]
    a = torch.zeros(bsz, h, t_len, t_len)
    rq = torch.empty_like(r)  # r * exp(cum_prev - cum_prev[j0]) per sub-chunk
    kk = torch.empty_like(k)  # k * exp(cum[i1] - cum) per sub-chunk
    for j0, j1 in zip(starts, ends):
        sl = slice(j0, j1)
        # diagonal block: the difference form, on the CUDA cores
        diff = cp[:, :, sl, None, :] - cum[:, :, None, sl, :]
        strict = torch.tril(torch.ones(j1 - j0, j1 - j0, dtype=torch.bool), -1)
        decay = torch.where(strict[..., None], torch.exp(diff), 0.0)
        blk = torch.einsum("bhtp,bhtip,bhip->bhti", r[:, :, sl], decay, k[:, :, sl])
        bonus = torch.einsum("bhtp,hp,bhtp->bht", r[:, :, sl], u, k[:, :, sl])
        a[:, :, sl, sl] = blk + torch.diag_embed(bonus)
        rq[:, :, sl] = r[:, :, sl] * torch.exp(cp[:, :, sl] - cp[:, :, j0:j0 + 1])
        kk[:, :, sl] = k[:, :, sl] * torch.exp(cum[:, :, j1 - 1:j1] - cum[:, :, sl])
    for jb, (j0, j1) in enumerate(zip(starts, ends)):
        for i0, i1 in zip(starts[:jb], ends[:jb]):
            e = torch.exp(cp[:, :, j0] - cum[:, :, i1 - 1])  # [B, H, P], <= 1
            a[:, :, j0:j1, i0:i1] = matmul(
                rq[:, :, j0:j1], (kk[:, :, i0:i1] * e[:, :, None]).transpose(-1, -2), passes)
    # carry-in factor exp(cum_prev[j0]) and state-update factor exp(cum[T-1] - cum[i1])
    g = torch.cat([torch.exp(cp[:, :, j0:j0 + 1]).expand(-1, -1, j1 - j0, -1)
                   for j0, j1 in zip(starts, ends)], dim=2)
    f = torch.cat([torch.exp(cum[:, :, -1:] - cum[:, :, i1 - 1:i1]).expand(-1, -1, i1 - i0, -1)
                   for i0, i1 in zip(starts, ends)], dim=2)
    y = matmul(a, v, passes) + matmul(rq * g, s0, passes)
    s1 = s0 * torch.exp(cum[:, :, -1])[..., None] + matmul((kk * f).transpose(-1, -2), v, passes)
    return y.permute(0, 2, 1, 3), s1


def _inputs(b, t, h, p, decay, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, p)).astype(np.float32) * 0.5 for _ in range(3))
    if decay == "uniform":
        lw = -rng.uniform(0.01, 1.0, size=(b, t, h, p))
    elif decay == "deep":  # the model's floor, -e per token: cum reaches -174
        lw = np.full((b, t, h, p), -np.e)
    else:  # "extreme": -exp(U[-20, 4.5]), from 2e-9 down to -90 per token
        lw = -np.exp(rng.uniform(-20.0, 4.5, size=(b, t, h, p)))
    u = rng.normal(size=(h, p)).astype(np.float32) * 0.1
    s0 = rng.normal(size=(b, h, p, p)).astype(np.float32) * 0.2
    return r, k, v, lw.astype(np.float32), u, s0


@pytest.mark.parametrize("decay", ["uniform", "deep", "extreme"])
@pytest.mark.parametrize("t", [1, 8, 16, 17, 37, 64])
def test_subchunk_model_matches_reference_and_pallas(t, decay):
    args = _inputs(2, t, 2, 64, decay, seed=t * 7 + len(decay))
    y, s1 = subchunk_chunk(*map(torch.as_tensor, args))
    assert torch.isfinite(y).all() and torch.isfinite(s1).all()
    y_ref, s1_ref = rwkv6_chunk_ref(*map(torch.as_tensor, args))
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(s1, s1_ref, **TOL)
    if decay == "extreme":  # exact cumulative sums in any order (module docstring)
        lw = np.round(args[3] * 1024.0) / 1024.0
        assert np.array_equal(np.cumsum(lw, axis=1), np.cumsum(lw.astype(np.float64), axis=1))
        args = (*args[:3], lw.astype(np.float32), *args[4:])
        y, s1 = subchunk_chunk(*map(torch.as_tensor, args))
    jy, js = rwkv6_chunk_pallas(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), **TOL)
    jy, js = j_chunk_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("t,p", [(8, 12), (37, 20)])
def test_subchunk_model_at_narrow_heads(t, p):
    """Head sizes that are not a multiple of the tensor-core depth (8)."""
    args = _inputs(2, t, 3, p, "uniform", seed=t + p)
    y, s1 = subchunk_chunk(*map(torch.as_tensor, args))
    y_ref, s1_ref = rwkv6_chunk_ref(*map(torch.as_tensor, args))
    torch.testing.assert_close(y, y_ref, **TOL)
    torch.testing.assert_close(s1, s1_ref, **TOL)


def test_subchunk_factors_never_overflow():
    """Every exponent the model takes is <= 0 up to rounding, so no factor
    exceeds 1, even where the unfactored exp(-cum) would overflow."""
    args = _inputs(1, 64, 2, 64, "extreme", seed=3)
    lw = torch.as_tensor(args[3]).permute(0, 2, 1, 3)
    cum = torch.cumsum(lw, dim=2)
    cp = cum - lw
    assert torch.isinf(torch.exp(-cum)).any()  # the one-step factoring overflows
    for j0 in range(0, 64, SUB):
        j1 = j0 + SUB
        assert (cp[:, :, j0:j1] - cp[:, :, j0:j0 + 1]).max() <= 1e-3
        assert (cum[:, :, j1 - 1:j1] - cum[:, :, j0:j1]).max() <= 1e-3
        for i1 in range(SUB, j0 + 1, SUB):
            assert (cp[:, :, j0] - cum[:, :, i1 - 1]).max() <= 1e-3


@pytest.mark.parametrize("decay", ["uniform", "deep"])
def test_plain_tf32_misses_the_tolerance(decay):
    """One TF32 product per term (no lo parts) misses allclose(rtol=1e-4,
    atol=1e-5) at T = 64, while 3xTF32 on the same inputs meets it."""
    args = tuple(map(torch.as_tensor, _inputs(2, 64, 2, 64, decay, seed=11)))
    y_ref, s1_ref = rwkv6_chunk_ref(*args)
    y3, s13 = subchunk_chunk(*args, passes=3)
    torch.testing.assert_close(y3, y_ref, **TOL)
    torch.testing.assert_close(s13, s1_ref, **TOL)
    y1, s11 = subchunk_chunk(*args, passes=1)
    assert not (torch.allclose(y1, y_ref, **TOL) and torch.allclose(s11, s1_ref, **TOL))
    assert max(float((y1 - y_ref).abs().max()), float((s11 - s1_ref).abs().max())) > 1e-4
