"""Port parity: `lstm_scan_bidir2` (two independent unidirectional LSTM
scans in one call: GCRN's grouped LSTM) against the JAX package, on the
CPU.

`lstm_scan_bidir2_plain` (the plain PyTorch version of the kernels that
`bidir2_plan` picks: csrc/lstm_bidir2.cu, csrc/lstm_scan_wide.cu, csrc/lstm_scan.cu)
is held against the XLA reference
`_xla_lstm_scan_bidir2` and against the Pallas kernel in interpret mode,
on the same numpy inputs, time-major; the gradient of the port's wrapper
(its residual-saving route, `_Bidir2Saving`) against `jax.grad` of the JAX
package's `lstm_scan_bidir2`. Row counts below, at and above the Pallas
tile's 8 rows.
Tolerances: float32 rtol/atol 1e-5 (the same arithmetic, summed in another
order); bfloat16 rtol/atol 0.05, the limit of the JAX package's own bf16
kernel test (tests/test_pallas_lstm.py:273-287); gradients 1e-4 (float32
sums over T steps and R rows in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.ops import pallas_lstm as jax_lstm
from nvse_tpu_torch.ops import lstm as port_lstm
from test_torch_port_joint import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)
SHAPES = [(7, 3, 16), (11, 12, 16), (1, 8, 8)]       # (T, R, H)


def _data(T, R, H, seed=0):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((T, R, 4 * H)) * 0.5).astype(np.float32) for _ in range(2)]
    ws = [(rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32) for _ in range(2)]
    return (*xs, *ws)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("T,R,H", SHAPES)
def test_bidir2_plain_matches_xla_bidir2(T, R, H):
    args = _data(T, R, H)
    refs = jax_lstm._xla_lstm_scan_bidir2(*_j(*args))
    gots = port_lstm.lstm_scan_bidir2_plain(*_t(*args))
    assert len(gots) == 2
    for got, ref in zip(gots, refs):
        assert got.shape == (T, R, H) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the two scans are independent: each has its own weights and state
    assert not np.allclose(gots[0].numpy(), gots[1].numpy(), atol=1e-3)


@pytest.mark.parametrize("T,R,H", SHAPES)
def test_bidir2_plain_matches_pallas_interpret(T, R, H):
    args = _data(T, R, H, seed=1)
    refs = jax_lstm._pallas_lstm_scan_bidir2(*_j(*args), interpret=True)
    for got, ref in zip(port_lstm.lstm_scan_bidir2_plain(*_t(*args)), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bidir2_plain_bf16_matches_pallas_interpret():
    args = _data(9, 5, 8, seed=2)
    refs = jax_lstm._pallas_lstm_scan_bidir2(*_j(*args, dtype=jnp.bfloat16), interpret=True)
    gots = port_lstm.lstm_scan_bidir2_plain(*_t(*args, dtype=torch.bfloat16))
    for got, ref in zip(gots, refs):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        np.testing.assert_allclose(_np32(got), np.asarray(ref, np.float32), **BF16_TOL)


def test_bidir2_cpu_wrapper_runs_plain_and_counts_no_launch():
    args = _t(*_data(7, 5, 8))
    n = port_lstm.lstm_scan_bidir2.launches, dict(port_lstm.lstm_scan_bidir2.launches_by_shape)
    gots = port_lstm.lstm_scan_bidir2(*args)
    assert (port_lstm.lstm_scan_bidir2.launches,
            port_lstm.lstm_scan_bidir2.launches_by_shape) == n
    for got, ref, xp, w in zip(gots, port_lstm.lstm_scan_bidir2_plain(*args), args[:2], args[2:]):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        # each half is the unidirectional scan of its own input and weights
        torch.testing.assert_close(got, port_lstm.lstm_scan_plain(xp, w), rtol=0, atol=0)


def test_bidir2_kernel_arguments_are_checked_before_touching_gpu():
    xa, xb, wa, wb = _t(*_data(5, 3, 8))
    check = port_lstm._check_seq_args
    with pytest.raises(ValueError, match="CUDA"):
        check("lstm_scan_bidir2", xa, wa)
    with pytest.raises(ValueError, match="contiguous"):
        check("lstm_scan_bidir2", xa.transpose(0, 1), wa)
    with pytest.raises(TypeError):
        check("lstm_scan_bidir2", xa, wa.bfloat16())
    # past the wide kernel's own limit the step-wise kernel takes the scans: the
    # check stops only at the device
    assert port_lstm._WIDE_MAX_H >= 448 > port_lstm._MAX_H
    big = torch.zeros(1, 1, 4 * (port_lstm._WIDE_MAX_H + 8))
    with pytest.raises(ValueError, match="CUDA"):
        check("lstm_scan_bidir2", big, torch.zeros(port_lstm._WIDE_MAX_H + 8, big.shape[-1]))
    assert port_lstm.bidir2_plan(5, 1, port_lstm._WIDE_MAX_H + 8, torch.float32, 132,
                                 232448)["route"] == "lstm_stepwise"


# ---------------------------------------------------------------------------
# gradient: the residual-saving route against jax.grad
# ---------------------------------------------------------------------------

def _counting(name, calls):
    orig = getattr(port_lstm, name)

    def counted(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    counted.launches, counted.launches_by_shape = orig.launches, orig.launches_by_shape
    return orig, counted


@pytest.mark.parametrize("T,R,H", [(12, 7, 16), (5, 9, 8), (3, 2, 448)])
def test_bidir2_gradient_matches_jax_grad(T, R, H):
    """dx_proj and dW_hh of both scans (CPU: lstm_fwd_hc_plain + lstm_bwd_plain
    per scan under _Bidir2Saving) against jax.grad through nvse_tpu's
    lstm_scan_bidir2, for random cotangents."""
    args = _data(T, R, H, seed=5)
    rng = np.random.default_rng(6)
    ga, gb = (rng.standard_normal((T, R, H)).astype(np.float32) for _ in range(2))

    def loss(a, b, c, d):
        ha, hb = jax_lstm.lstm_scan_bidir2(a, b, c, d)
        return jnp.sum(ha * jnp.asarray(ga)) + jnp.sum(hb * jnp.asarray(gb))

    refs = jax.grad(loss, argnums=(0, 1, 2, 3))(*_j(*args))
    targs = [t.requires_grad_() for t in _t(*args)]
    ha, hb = port_lstm.lstm_scan_bidir2(*targs)
    ((ha * torch.from_numpy(ga)).sum() + (hb * torch.from_numpy(gb)).sum()).backward()
    for out, ref in zip((ha, hb), jax_lstm.lstm_scan_bidir2(*_j(*args))):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    for t, ref in zip(targs, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_bidir2_autograd_takes_the_residual_saving_route(monkeypatch):
    """Under autograd: `_Bidir2Saving`, i.e. 2 lstm_fwd_hc forward and 2
    lstm_bwd backward; under no_grad the inference route, none of them."""
    calls = []
    for name in ("lstm_fwd_hc", "lstm_bwd"):
        _, counted = _counting(name, calls)
        monkeypatch.setattr(port_lstm, name, counted)
    applied = []
    orig_apply = port_lstm._Bidir2Saving.apply
    monkeypatch.setattr(port_lstm._Bidir2Saving, "apply",
                        lambda *a: applied.append(1) or orig_apply(*a))

    targs = [t.requires_grad_() for t in _t(*_data(6, 4, 8, seed=3))]
    with torch.no_grad():
        port_lstm.lstm_scan_bidir2(*targs)
    assert calls == [] and applied == []
    ha, hb = port_lstm.lstm_scan_bidir2(*targs)
    assert applied == [1] and calls == ["lstm_fwd_hc"] * 2
    (ha.sum() + hb.square().sum()).backward()
    assert calls == ["lstm_fwd_hc"] * 2 + ["lstm_bwd"] * 2
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in targs)
    # only a weight requiring grad is enough to take the route
    xa, xb, wa, wb = (t.detach() for t in targs)
    port_lstm.lstm_scan_bidir2(xa, xb, wa, wb.requires_grad_())
    assert applied == [1, 1]
