"""Port parity: the unidirectional LSTM scans, their gradient and the
streaming LSTM layer against the JAX package, on the CPU.

`lstm_scan_plain` and `lstm_scan_stateful_plain` (the plain PyTorch
versions of the kernels of csrc/lstm_scan.cu) are held against the XLA
references `_xla_lstm_scan` / `_xla_lstm_scan_stateful` and against the
Pallas kernels in interpret mode, on the same numpy inputs, time-major.
Row counts are no multiple of the Pallas tile's 8 rows and T no multiple
of the unroll, so the kernels' padding is exercised; bfloat16 also at
H = 136, a hidden size of csrc/lstm_scan_wide.cu, where the residual-saving
forward's plain version (float32 h in the product) and the scan's (h rounded)
are each held to their own JAX function.
Tolerances: float32 rtol/atol 1e-5 (the same arithmetic, summed in another
order); bfloat16 rtol/atol 0.05, the limit of the JAX package's own bf16
kernel test (tests/test_pallas_lstm.py:273-287).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze

from nvse_tpu.models.layers import LSTM as JaxLSTM
from nvse_tpu.ops import pallas_lstm as jax_lstm
from nvse_tpu_torch.models.layers import LSTM
from nvse_tpu_torch.ops import lstm as port_lstm

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)


def _data(T, R, H, seed=0, state=False):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((T, R, 4 * H)) * 0.5).astype(np.float32)
    whh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    if not state:
        return xp, whh
    h0 = (rng.standard_normal((R, H)) * 0.3).astype(np.float32)
    c0 = (rng.standard_normal((R, H)) * 0.3).astype(np.float32)
    return xp, whh, h0, c0


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# ---------------------------------------------------------------------------
# lstm_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,R,H", [(13, 11, 16), (1, 3, 8), (23, 20, 16)])
def test_scan_plain_matches_xla_scan(T, R, H):
    args = _data(T, R, H)
    ref = np.asarray(jax_lstm._xla_lstm_scan(*_j(*args)))
    got = port_lstm.lstm_scan_plain(*_t(*args))
    assert got.shape == (T, R, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("unroll", [1, 4])
def test_scan_plain_matches_pallas_interpret(unroll):
    args = _data(13, 11, 16, seed=1)          # 11 rows pad to 16, 13 steps to 16 at k = 4
    ref = np.asarray(jax_lstm._pallas_lstm_scan(*_j(*args), interpret=True, unroll=unroll))
    np.testing.assert_allclose(port_lstm.lstm_scan_plain(*_t(*args)).numpy(), ref, **TOL)


def test_scan_plain_bf16_matches_pallas_interpret():
    args = _data(9, 5, 8, seed=2)
    ref = jax_lstm._pallas_lstm_scan(*_j(*args, dtype=jnp.bfloat16), interpret=True, unroll=4)
    got = port_lstm.lstm_scan_plain(*_t(*args, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np32(got), np.asarray(ref, np.float32), **BF16_TOL)


def test_scan_plain_bf16_matches_pallas_interpret_at_a_wide_h():
    # H = 136: the hidden sizes of csrc/lstm_scan_wide.cu (128 < H), k no multiple of 16
    args = _data(9, 5, 136, seed=3)
    ref = jax_lstm._pallas_lstm_scan(*_j(*args, dtype=jnp.bfloat16), interpret=True, unroll=1)
    got = port_lstm.lstm_scan_plain(*_t(*args, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (9, 5, 136)
    np.testing.assert_allclose(_np32(got), np.asarray(ref, np.float32), **BF16_TOL)


def test_fwd_hc_plain_multiplies_unrounded_h_where_scan_plain_rounds_it():
    """bfloat16 at H = 136: lstm_fwd_hc_plain (the training forward) multiplies
    the float32 h, lstm_scan_plain (inference) h rounded to bfloat16, each as
    its JAX function does (pallas_lstm_bwd.py:147-160; `_hdot`, pallas_lstm.py:
    36-43). Each agrees with its own JAX function but for a rare rounding flip,
    and the two differ by a bfloat16 step at many outputs."""
    from nvse_tpu.ops.pallas_lstm_bwd import lstm_fwd_hc as jax_fwd_hc

    xp, whh = _data(9, 5, 136, seed=5)
    jargs, targs = _j(xp, whh, dtype=jnp.bfloat16), _t(xp, whh, dtype=torch.bfloat16)
    j_scan = np.asarray(jax_lstm._pallas_lstm_scan(*jargs, interpret=True, unroll=1), np.float32)
    j_fwd = np.asarray(jax_fwd_hc(*jargs, interpret=True, unroll=1)[0], np.float32)
    p_scan = _np32(port_lstm.lstm_scan_plain(*targs))
    p_fwd = _np32(port_lstm.lstm_fwd_hc_plain(*targs)[0])
    share = lambda a, b: float(np.mean(a != b))     # outputs that differ
    for got, ref in ((p_scan, j_scan), (p_fwd, j_fwd)):
        np.testing.assert_allclose(got, ref, **BF16_TOL)
        assert share(got, ref) < 0.01
    assert share(p_fwd, p_scan) > 0.05 and share(p_fwd, j_scan) > 0.05


def test_scan_cpu_wrapper_runs_plain_and_counts_no_launch():
    xp, whh = _t(*_data(7, 5, 8))
    n = port_lstm.lstm_scan.launches, port_lstm.lstm_scan_stateful.launches
    got = port_lstm.lstm_scan(xp, whh)
    z = torch.zeros(5, 8)
    hs, cs = port_lstm.lstm_scan_stateful(xp, whh, z, z)
    assert (port_lstm.lstm_scan.launches, port_lstm.lstm_scan_stateful.launches) == n
    torch.testing.assert_close(got, port_lstm.lstm_scan_plain(xp, whh), rtol=0, atol=0)
    # from zero state the stateful scan is the plain scan
    torch.testing.assert_close(hs, got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# lstm_scan_stateful
# ---------------------------------------------------------------------------

def test_stateful_plain_matches_xla_scan_stateful():
    args = _data(23, 12, 16, seed=7, state=True)
    ref_h, ref_c = jax_lstm._xla_lstm_scan_stateful(*_j(*args))
    hs, cs = port_lstm.lstm_scan_stateful_plain(*_t(*args))
    np.testing.assert_allclose(hs.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(ref_c), **TOL)


@pytest.mark.parametrize("unroll", [1, 4])
def test_stateful_plain_matches_pallas_interpret(unroll):
    args = _data(23, 11, 16, seed=8, state=True)
    ref_h, ref_c = jax_lstm._pallas_lstm_scan_stateful(*_j(*args), interpret=True, unroll=unroll)
    hs, cs = port_lstm.lstm_scan_stateful_plain(*_t(*args))
    np.testing.assert_allclose(hs.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(cs.numpy(), np.asarray(ref_c), **TOL)


def test_stateful_plain_bf16_matches_pallas_interpret():
    args = _data(9, 5, 8, seed=9, state=True)
    ref_h, ref_c = jax_lstm._pallas_lstm_scan_stateful(*_j(*args, dtype=jnp.bfloat16),
                                                       interpret=True, unroll=1)
    hs, cs = port_lstm.lstm_scan_stateful_plain(*_t(*args, dtype=torch.bfloat16))
    assert hs.dtype == cs.dtype == torch.bfloat16
    np.testing.assert_allclose(_np32(hs), np.asarray(ref_h, np.float32), **BF16_TOL)
    np.testing.assert_allclose(_np32(cs), np.asarray(ref_c, np.float32), **BF16_TOL)


def test_stateful_plain_bf16_matches_pallas_interpret_at_a_wide_h():
    args = _data(9, 5, 136, seed=10, state=True)
    ref_h, ref_c = jax_lstm._pallas_lstm_scan_stateful(*_j(*args, dtype=jnp.bfloat16),
                                                       interpret=True, unroll=1)
    hs, cs = port_lstm.lstm_scan_stateful_plain(*_t(*args, dtype=torch.bfloat16))
    assert hs.dtype == cs.dtype == torch.bfloat16 and hs.shape == (9, 5, 136)
    np.testing.assert_allclose(_np32(hs), np.asarray(ref_h, np.float32), **BF16_TOL)
    np.testing.assert_allclose(_np32(cs), np.asarray(ref_c, np.float32), **BF16_TOL)


def test_stateful_plain_chunk_equals_full():
    # two chunks with the carried (h, c) reproduce the one-shot scan: what
    # synthesize_streaming_stateful's zero-seam claim for causal configs rests on
    xp, whh = _t(*_data(30, 20, 16, seed=11))
    z = torch.zeros(20, 16)
    full_h, full_c = port_lstm.lstm_scan_stateful_plain(xp, whh, z, z)
    h1, c1 = port_lstm.lstm_scan_stateful_plain(xp[:17], whh, z, z)
    h2, c2 = port_lstm.lstm_scan_stateful_plain(xp[17:], whh, h1[-1], c1[-1])
    torch.testing.assert_close(torch.cat([h1, h2]), full_h, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([c1, c2]), full_c, rtol=0, atol=0)


def test_scan_kernel_wrappers_reject_bad_arguments_before_touching_gpu():
    xp, whh, h0, c0 = _t(*_data(5, 3, 8, state=True))
    with pytest.raises(ValueError, match="CUDA"):
        port_lstm._check_seq_args("lstm_scan_stateful", xp, whh, initial=(h0, c0))
    with pytest.raises(ValueError, match="shapes"):
        port_lstm._check_seq_args("lstm_scan_stateful", xp, whh, initial=(h0[:2], c0))
    with pytest.raises(TypeError):
        port_lstm._check_seq_args("lstm_scan_stateful", xp, whh, initial=(h0.bfloat16(), c0))
    with pytest.raises(ValueError, match="contiguous"):
        port_lstm._check_seq_args("lstm_scan", xp.transpose(0, 1), whh)


# ---------------------------------------------------------------------------
# gradient of lstm_scan: the residual-saving route against jax.grad
# ---------------------------------------------------------------------------

def test_scan_gradient_matches_jax_grad():
    """dx_proj and dW_hh of the port's lstm_scan (CPU: lstm_fwd_hc_plain +
    lstm_bwd_plain under _ScanSaving) against jax.grad through
    nvse_tpu's lstm_scan, for a random cotangent; 1e-4: float32 sums over
    T steps and R rows in another order."""
    xp, whh = _data(12, 7, 16, seed=5)
    g = np.random.default_rng(6).standard_normal((12, 7, 16)).astype(np.float32)
    dx_ref, dw_ref = jax.grad(lambda a, w: jnp.sum(jax_lstm.lstm_scan(a, w) * jnp.asarray(g)),
                              argnums=(0, 1))(*_j(xp, whh))
    txp, tw = (t.requires_grad_() for t in _t(xp, whh))
    calls = []
    orig = port_lstm._ScanSaving.apply
    port_lstm._ScanSaving.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        out = port_lstm.lstm_scan(txp, tw)
        with torch.no_grad():
            port_lstm.lstm_scan(txp, tw)            # not differentiated: the inference route
    finally:
        port_lstm._ScanSaving.apply = orig
    assert calls == [1]
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_lstm.lstm_scan(*_j(xp, whh))), **TOL)
    np.testing.assert_allclose(txp.grad.numpy(), np.asarray(dx_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_ref), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# layers.LSTM: the streaming branch against the flax layer
# ---------------------------------------------------------------------------

def _lstm_pair(C, H, bidirectional, dtype, seed):
    """The flax LSTM's params from seeded numpy, and the port's layer
    holding the same weights (bias summed, as params_from_jax maps it)."""
    rng = np.random.default_rng(seed)
    jl = JaxLSTM(C, H, bidirectional=bidirectional)
    shapes = jax.eval_shape(jl.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, C)))["params"]
    jp = {k: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32) for k, s in unfreeze(shapes).items()}
    layer = LSTM(C, H, bidirectional, gen=torch.Generator().manual_seed(0))
    sd = {}
    for d in ("fwd", "bwd") if bidirectional else ("fwd",):
        sd[f"w_ih_{d}"] = torch.from_numpy(jp[f"w_ih_{d}"])
        sd[f"w_hh_{d}"] = torch.from_numpy(jp[f"w_hh_{d}"])
        sd[f"b_{d}"] = torch.from_numpy(jp[f"b_ih_{d}"] + jp[f"b_hh_{d}"])
    layer.load_state_dict(sd)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return jl, {k: jnp.asarray(v).astype(jdt) for k, v in jp.items()}, layer.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_layer_streaming_matches_flax(bidirectional, dtype):
    """Two chunks, the second resuming from the first's state taken after
    carry_idx = 6 of its 9 frames (3 frames of lookahead). In bfloat16 the
    carried state is rounded to bfloat16 at the chunk boundary on both
    sides, and the sums round at other places: a few bf16 ulps."""
    B, S, C, H, ci = 3, 9, 6, 8, 6
    jl, jp, layer = _lstm_pair(C, H, bidirectional, dtype, seed=3)
    x = np.random.default_rng(4).standard_normal((B, 2 * S, C)).astype(np.float32)
    tol = TOL if dtype == torch.float32 else BF16_TOL

    y1, st1 = jl.apply({"params": jp}, jnp.asarray(x[:, :S]), return_state=True, carry_idx=ci)
    y2, st2 = jl.apply({"params": jp}, jnp.asarray(x[:, ci:ci + S]), initial_state=st1,
                       return_state=True)
    with torch.no_grad():
        p1, pst1 = layer(torch.from_numpy(x[:, :S]), return_state=True, carry_idx=ci)
        p2, pst2 = layer(torch.from_numpy(x[:, ci:ci + S]), initial_state=pst1,
                         return_state=True)
        only_y = layer(torch.from_numpy(x[:, ci:ci + S]), initial_state=pst1)
    assert p1.shape == (B, S, H * (2 if bidirectional else 1)) and p1.dtype == dtype
    assert pst1[0].shape == pst1[1].shape == (B, H) and pst1[1].dtype == dtype
    torch.testing.assert_close(only_y, p2, rtol=0, atol=0)
    for got, ref in ((p1, y1), (p2, y2), (pst1[0], st1[0]), (pst1[1], st1[1]),
                     (pst2[0], st2[0]), (pst2[1], st2[1])):
        np.testing.assert_allclose(_np32(got), np.asarray(ref, np.float32), **tol)
    if not bidirectional and dtype == torch.float32:
        # a causal layer resumed at the carry equals the one-shot layer
        with torch.no_grad():
            full = layer(torch.from_numpy(x[:, :ci + S]))
        torch.testing.assert_close(torch.cat([p1[:, :ci], p2], dim=1), full, rtol=1e-6, atol=1e-6)
