"""Port parity: the LSTM training route against nvse_tpu's residual kernels.

`lstm_fwd_hc_plain` / `lstm_bwd_plain` (the plain versions of the CUDA
kernels in csrc/lstm_bwd.cu) against the Pallas kernels `lstm_fwd_hc` /
`lstm_bwd` in interpret mode (unroll 1, as tests/test_pallas_lstm.py runs
them): float32 at rtol 1e-5 / atol 1e-6 (the same arithmetic in another
order); bfloat16 at the JAX test's own 0.05 (forward) and 0.1 / 0.15
(backward). Then `lstm_scan_fused` under autograd on the CPU (the
`_BiLSTMSaving` Function over the plain versions): output and all 7
gradients against `_fused_fwd_saving` / `_fused_bwd_saved` in interpret
mode and against torch autograd through `lstm_scan_fused_plain`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvse_tpu.ops.pallas_lstm import _fused_bwd_saved, _fused_fwd_saving
from nvse_tpu.ops.pallas_lstm_bwd import lstm_bwd, lstm_fwd_hc
from nvse_tpu_torch.ops import lstm as port_lstm
from test_torch_port_joint import _one_torch_thread  # noqa: F401

F32 = dict(rtol=1e-5, atol=1e-6)


def _seq(T=7, B=4, H=8, seed=0):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((T, B, 4 * H)) * 0.5).astype(np.float32)
    whh = (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32)
    dhs = rng.standard_normal((T, B, H)).astype(np.float32)
    return xp, whh, dhs


def test_fwd_hc_plain_matches_pallas_interpret_f32():
    xp, whh, _ = _seq()
    hs_j, cs_j = lstm_fwd_hc(jnp.asarray(xp), jnp.asarray(whh), interpret=True, unroll=1)
    hs, cs = port_lstm.lstm_fwd_hc_plain(torch.from_numpy(xp), torch.from_numpy(whh))
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_j), **F32)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), **F32)


def test_bwd_plain_matches_pallas_interpret_f32():
    xp, whh, dhs = _seq(seed=1)
    hs_j, cs_j = lstm_fwd_hc(jnp.asarray(xp), jnp.asarray(whh), interpret=True, unroll=1)
    dx_j, dw_j = lstm_bwd(jnp.asarray(xp), hs_j, cs_j, jnp.asarray(dhs), jnp.asarray(whh),
                          interpret=True, unroll=1)
    dx, dw = port_lstm.lstm_bwd_plain(torch.from_numpy(xp), torch.tensor(np.asarray(hs_j)),
                                      torch.tensor(np.asarray(cs_j)), torch.from_numpy(dhs),
                                      torch.from_numpy(whh))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **F32)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), rtol=1e-5, atol=1e-5)


def test_training_plain_versions_bf16_match_pallas_interpret():
    xp, whh, dhs = _seq(T=6, B=4, H=8, seed=2)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)   # exact
    hs_j, cs_j = lstm_fwd_hc(bf(xp), bf(whh), interpret=True, unroll=1)
    hs, cs = port_lstm.lstm_fwd_hc_plain(tb(bf(xp)), tb(bf(whh)))
    assert hs.dtype == cs.dtype == torch.bfloat16
    np.testing.assert_allclose(hs.float().numpy(), np.asarray(hs_j, np.float32), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(cs.float().numpy(), np.asarray(cs_j, np.float32), rtol=0.05, atol=0.05)
    dx_j, dw_j = lstm_bwd(bf(xp), hs_j, cs_j, bf(dhs), bf(whh), interpret=True, unroll=1)
    dx, dw = port_lstm.lstm_bwd_plain(tb(bf(xp)), tb(hs_j), tb(cs_j), tb(bf(dhs)), tb(bf(whh)))
    assert dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_j, np.float32), rtol=0.1, atol=0.1)
    np.testing.assert_allclose(dw.float().numpy(), np.asarray(dw_j, np.float32), rtol=0.1, atol=0.15)


def test_dw_plain_is_the_shifted_outer_product_sum():
    xp, whh, dhs = _seq(T=5, B=3, H=8, seed=3)
    hs = torch.from_numpy(dhs)
    dx = torch.from_numpy(xp)
    want = sum(hs[t - 1].T @ dx[t] for t in range(1, 5))
    torch.testing.assert_close(port_lstm.lstm_dw_hh_plain(hs, dx), want, rtol=1e-5, atol=1e-5)


def _fused_args(B=4, T=7, C=6, H=8, seed=7):
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(H)
    shapes = [(B, T, C), (C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]
    return [(rng.uniform(-b, b, s) if i else rng.standard_normal(s)).astype(np.float32)
            for i, s in enumerate(shapes)]


def _autograd(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,T", [(4, 7), (3, 1)])
def test_autograd_bilstm_matches_jax_saving_path(B, T):
    args = _fused_args(B=B, T=T)
    g = np.random.default_rng(8).standard_normal((B, T, 16)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in args]
    out_j, saved = _fused_fwd_saving(*jargs, interpret=True)
    grads_j = _fused_bwd_saved(saved, *jargs, jnp.asarray(g), interpret=True)
    out, grads = _autograd(port_lstm.lstm_scan_fused, args, g)
    np.testing.assert_allclose(out, np.asarray(out_j), **F32)
    assert len(grads) == len(grads_j) == 7
    for got, ref in zip(grads, grads_j):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_autograd_bilstm_matches_autograd_through_plain():
    args = _fused_args(seed=9)
    g = np.random.default_rng(10).standard_normal((4, 7, 16)).astype(np.float32)
    n = port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches, port_lstm.lstm_dw_hh.launches
    out, grads = _autograd(port_lstm.lstm_scan_fused, args, g)
    ref_out, ref_grads = _autograd(port_lstm.lstm_scan_fused_plain, args, g)
    np.testing.assert_allclose(out, ref_out, **F32)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches,
            port_lstm.lstm_dw_hh.launches) == n


def test_training_wrappers_reject_before_touching_gpu():
    xp, whh, dhs = (torch.from_numpy(a) for a in _seq())
    with pytest.raises(ValueError, match="CUDA"):
        port_lstm._check_seq_args("lstm_bwd", xp, whh, dhs, dhs, dhs)
    with pytest.raises(ValueError, match="contiguous"):
        port_lstm._check_seq_args("lstm_bwd", xp.transpose(0, 1), whh)
    with pytest.raises(TypeError):
        port_lstm._check_seq_args("lstm_fwd_hc", xp, whh.to(torch.bfloat16))
    # past the resident training kernels' H <= 768 (csrc/lstm_scan_wide.cu,
    # csrc/lstm_bwd_wide.cu above 128) the step-wise kernels take it: the check
    # stops only at the device
    big = torch.zeros(3, 2, 4 * 776)
    with pytest.raises(ValueError, match="CUDA"):
        port_lstm._check_seq_args("lstm_fwd_hc", big, torch.zeros(776, 4 * 776))
    assert port_lstm.train_route("lstm_fwd_hc", 776, dict(co_resident=False)) == "lstm_stepwise"

