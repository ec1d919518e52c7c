"""Port parity: the fused TCN block tail (nvse_tpu_torch/ops/tcn.py) and
Griffin-Lim (nvse_tpu_torch/ops/griffin_lim.py) against the JAX package,
on the CPU.

Both sides get the same numpy inputs. Tolerances:
  * tcn_block_tail_plain vs the Pallas kernel `_pallas_tail` (interpret
    mode) and vs the XLA tail in float32: 2e-5, as the JAX package's own
    kernel test (tests/test_pallas_tcn.py), the same arithmetic summed in
    another order; in bfloat16 against the kernel, one bfloat16 ulp of the
    outputs' scale (2^-7 of max(1, |ref|), outputs of magnitude up to ~4):
    both round q once to bfloat16 and sum in float32, so they differ only
    where a float32 sum order flips a rounding;
  * the autograd route (the recompute backward) vs jax.grad of the JAX
    op's custom VJP: 1e-4 of each gradient's largest value;
  * Griffin-Lim, 32 iterations from the JAX draw passed in as theta: the
    port's classic loop (pocketfft here) vs the JAX frame-domain loop
    (matmul DFT) drifts to 5.8e-5 of the signal's peak at 2 x 513 x 16 and
    1.3e-5 at 257 x 9 (measured on the CPU; the momentum of 0.99 carries
    rounding from one iteration to the next, 2.3e-4 at 64 frames); the
    limit is 1e-3 of the peak, and a different theta lands at 1.3-1.6 of
    the peak, which the control shows.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.ops.pallas_tcn import _pallas_tail, _xla_tail
from nvse_tpu.ops.pallas_tcn import tcn_block_tail as jax_tail
from nvse_tpu_torch.ops import griffin_lim, tcn_block_tail, tcn_block_tail_plain
from nvse_tpu_torch.ops.tcn import _fold, tcn_block_tail_kernel

jax_gl = importlib.import_module("nvse_tpu.ops.griffin_lim")   # the package exports the function
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(B, T, H, Bc, seed):
    """c with a nonzero mean (a PReLU'd projection), a nonzero gLN shift:
    a tap that read b2 in place of 0 at the sequence ends would show."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = [f(B, T, H) + 0.5, f(B, T, Bc), 1.0 + 0.1 * f(1, H), 0.5 * f(1, H),
           f(3, H) / 3.0, 0.1 * f(1, H), f(H, 2 * Bc) / np.sqrt(H), 0.1 * f(1, 2 * Bc)]
    return [v.astype(np.float32) for v in out]


def _fold_np(c, gw, gb):
    a, b2 = _fold(torch.from_numpy(c), torch.from_numpy(gw), torch.from_numpy(gb), 1e-5)
    return a.numpy(), b2.numpy()


@pytest.mark.parametrize("dilation", [1, 2, 16, 128])
def test_plain_tail_matches_pallas_kernel(dilation):
    # T = 700 is off the kernel's 512-row tile (its pad path); B = 3
    c, x, gw, gb, wdw, bdw, wrs, brs = _inputs(3, 700, 128, 64, seed=dilation)
    a, b2 = _fold_np(c, gw, gb)
    e_ref, s_ref = _pallas_tail(*map(jnp.asarray, (c, x, a, b2, wdw, bdw, wrs, brs)),
                                dilation, interpret=True)
    e, s = tcn_block_tail_plain(*map(torch.from_numpy, (c, x, a, b2, wdw, bdw, wrs, brs)),
                                dilation)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)


def test_plain_tail_matches_pallas_kernel_bf16():
    c, x, gw, gb, wdw, bdw, wrs, brs = _inputs(2, 300, 128, 64, seed=5)
    a, b2 = _fold_np(c, gw, gb)
    bf = [np.asarray(jnp.asarray(v, jnp.bfloat16)) for v in (c, x, wdw, bdw, wrs, brs)]
    c, x, wdw, bdw, wrs, brs = bf
    e_ref, s_ref = _pallas_tail(*map(jnp.asarray, (c, x, a, b2, wdw, bdw, wrs, brs)), 8,
                                interpret=True)
    tb = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
    e, s = tcn_block_tail_plain(tb(c), tb(x), torch.from_numpy(a), torch.from_numpy(b2),
                                tb(wdw), tb(bdw), tb(wrs), tb(brs), 8)
    assert e.dtype == torch.bfloat16 and s.dtype == torch.bfloat16
    for got, ref in ((e, e_ref), (s, s_ref)):
        ref = np.asarray(ref, np.float32)
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= 2.0 ** -7 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("dilation", [1, 4, 128])
def test_tail_matches_xla_tail(dilation):
    args = _inputs(2, 200, 96, 40, seed=10 + dilation)
    e_ref, s_ref = _xla_tail(*map(jnp.asarray, args), dilation, 1e-5)
    e, s = tcn_block_tail(*map(torch.from_numpy, args), dilation)
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gln_fold_matches_the_jax_statistics_via_xla_tail(dtype):
    """`_fold`, the plain version of the statistics kernel of csrc/tcn_tail.cu
    (per batch element the float32 mean and mean of squares of c, m2 - m1^2
    clamped at 0), against the m1 / m2 formula of `_tail_fwd_impl`
    (pallas_tcn.py:168-182), read through `_xla_tail`: with the middle tap only
    (w_dw = [0, 1, 0], b_dw = 0), w_rs = [I | 0] (Bc = H) and x = 0, e is the
    normalised n = gln_w rstd (c - m1) + gln_b. c has a mean of 3 and a standard
    deviation of 1, so a fold that dropped m1 or m2 - m1^2 would show. In
    bfloat16 (c rounded on both sides) _xla_tail rounds n once to bfloat16, so
    the port's n rounded the same way must agree to one bfloat16 ulp. In float32
    both are one-pass float32 statistics, and at a mean of 3 m2 - m1^2 loses a
    digit to cancellation: against float64, XLA's n is off by 8e-6 of its peak
    and the port's by 1.2e-6 (measured on the CPU); the limits are 2e-5 of the
    peak against XLA and 2e-6 against float64."""
    B, T, H = 2, 50, 32
    rng = np.random.default_rng(21)
    c = (rng.standard_normal((B, T, H)) + 3.0).astype(np.float32)
    gw = (1.0 + 0.1 * rng.standard_normal((1, H))).astype(np.float32)
    gb = (0.5 * rng.standard_normal((1, H))).astype(np.float32)
    wdw = np.zeros((3, H), np.float32)
    wdw[1] = 1.0
    wrs = np.concatenate([np.eye(H), np.zeros((H, H))], axis=1).astype(np.float32)
    zeros = [np.zeros(s, np.float32) for s in ((B, T, H), (1, H), (1, 2 * H))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    cj = jnp.asarray(c, jdt)
    e_ref, _ = _xla_tail(cj, jnp.asarray(zeros[0], jdt), jnp.asarray(gw), jnp.asarray(gb),
                         jnp.asarray(wdw, jdt), jnp.asarray(zeros[1], jdt), jnp.asarray(wrs, jdt),
                         jnp.asarray(zeros[2], jdt), 1, 1e-5)
    e_ref = np.asarray(e_ref, np.float32)
    ct = torch.from_numpy(np.asarray(cj, np.float32)).to(getattr(torch, dtype))
    a, b2 = _fold(ct, torch.from_numpy(gw), torch.from_numpy(gb), 1e-5)
    n = ct.float() * a[:, None, :] + b2[:, None, :]
    assert abs(e_ref).max() > 1.0 and abs(e_ref.mean()) < 1.0      # normalised: the mean is gone
    peak = np.abs(e_ref).max()
    if dtype == "float32":
        c64 = c.astype(np.float64)
        m1 = c64.mean(axis=(1, 2), keepdims=True)
        var = (c64 ** 2).mean(axis=(1, 2), keepdims=True) - m1 ** 2
        n64 = gw * (c64 - m1) / np.sqrt(var + 1e-5) + gb
        assert np.abs(n.numpy() - e_ref).max() <= 2e-5 * peak
        assert np.abs(n.numpy() - n64).max() <= 2e-6 * peak
    else:
        got = n.to(torch.bfloat16).float().numpy()
        assert np.abs(got - e_ref).max() <= 2.0 ** -7 * peak


def test_padding_after_the_norm_matters():
    """Zero-padding c before the norm (taps read b2, not 0) is wrong at the
    first and last d rows: the check above would see it."""
    c, x, gw, gb, wdw, bdw, wrs, brs = map(torch.from_numpy, _inputs(2, 300, 64, 32, seed=3))
    d = 16
    a, b2 = _fold(c, gw, gb, 1e-5)
    e, _ = tcn_block_tail_plain(c, x, a, b2, wdw, bdw, wrs, brs, d)
    cp = torch.nn.functional.pad(c, (0, 0, d, d))
    e_pre, _ = tcn_block_tail_plain(cp, torch.nn.functional.pad(x, (0, 0, d, d)), a, b2,
                                    wdw, bdw, wrs, brs, d)
    err = (e_pre[:, d:-d] - e).abs()
    assert err[:, d:-d].max() <= 1e-5 and err.max() > 1e-2


def test_autograd_route_matches_jax_grad():
    args = _inputs(2, 96, 64, 32, seed=11)
    rng = np.random.default_rng(12)
    ce, cs = (rng.standard_normal((2, 96, 32)).astype(np.float32) for _ in range(2))

    def loss(*p):
        e, s = jax_tail(*p, 16)
        return jnp.sum(e * ce) + jnp.sum(s * cs)

    ref = jax.grad(loss, argnums=tuple(range(8)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    e, s = tcn_block_tail(*leaves, 16)
    assert e.grad_fn is not None and s.grad_fn is not None
    ((e * torch.from_numpy(ce)).sum() + (s * torch.from_numpy(cs)).sum()).backward()
    for leaf, r in zip(leaves, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launcher takes CUDA tensors only; on the CPU the wrapper runs the
    plain version because the tensors lie there."""
    c, x, gw, gb, wdw, bdw, wrs, brs = map(torch.from_numpy, _inputs(1, 8, 16, 8, seed=0))
    a, b2 = _fold(c, gw, gb, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tcn_block_tail_kernel(c, x, a, b2, wdw, bdw, wrs, brs, 1)
    with pytest.raises(NotImplementedError, match="3 taps"):
        tcn_block_tail_kernel(c, x, a, b2, torch.zeros(5, 16), bdw, wrs, brs, 1)


# ---------------------------------------------------------------------------
# Griffin-Lim
# ---------------------------------------------------------------------------

def _jax_theta(shape):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(0), shape,
                                         minval=-jnp.pi, maxval=jnp.pi))


@pytest.mark.parametrize("shape,nfft,hop", [((2, 513, 16), 1024, 256), ((257, 9), 512, 128)])
def test_griffin_lim_matches_jax(shape, nfft, hop):
    mag = np.abs(np.random.default_rng(0).standard_normal(shape)).astype(np.float32) + 1e-5
    ref = np.asarray(jax_gl.griffin_lim(jnp.asarray(mag), nfft, hop, nfft, n_iter=32))
    got = griffin_lim(torch.from_numpy(mag), nfft, hop, nfft, n_iter=32,
                      theta=torch.from_numpy(_jax_theta(shape))).numpy()
    assert got.shape == ref.shape
    peak = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-3 * peak
    # control: another initial phase does not pass the limit
    other = griffin_lim(torch.from_numpy(mag), nfft, hop, nfft, n_iter=32,
                        generator=torch.Generator().manual_seed(1)).numpy()
    assert np.abs(other - ref).max() > 1e-3 * peak


def test_griffin_lim_length_crops_only_the_final_synthesis():
    mag = torch.rand(2, 257, 9, generator=torch.Generator().manual_seed(0)) + 0.1
    full = griffin_lim(mag, 512, 128, 512, n_iter=4)
    cut = griffin_lim(mag, 512, 128, 512, n_iter=4, length=500)
    assert full.shape == (2, 128 * 8) and cut.shape == (2, 500)
    torch.testing.assert_close(cut, full[:, :500])
