"""Port parity: the fused bidirectional LSTM against the JAX package.

`lstm_scan_fused_plain` (the plain PyTorch version of the CUDA kernel)
is held against `_xla_lstm_fused_ref` and both Pallas kernels in
interpret mode, on the same numpy inputs. T is odd and B ragged so the
Pallas batch padding and the unrolled kernel's masked backward pad block
(pallas_lstm.py:675-690) are exercised. float32, rtol/atol 1e-5: the
same arithmetic, summed in another order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvse_tpu.ops.pallas_lstm import (
    _pallas_lstm_fused,
    _pallas_lstm_fused_unrolled,
    _xla_lstm_fused_ref,
    _xla_lstm_scan,
)
from nvse_tpu_torch.ops import lstm as port_lstm
from test_torch_port_joint import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _args(B=11, T=13, C=12, H=16, seed=0):
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(H)
    shapes = [(B, T, C), (C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]
    return [(rng.uniform(-b, b, s) if i else rng.standard_normal(s)).astype(np.float32)
            for i, s in enumerate(shapes)]


def _port(args):
    return port_lstm.lstm_scan_fused_plain(*map(torch.from_numpy, args)).numpy()


@pytest.mark.parametrize("B,T", [(11, 13), (3, 1), (20, 7)])
def test_plain_matches_xla_ref(B, T):
    args = _args(B=B, T=T)
    ref = np.asarray(_xla_lstm_fused_ref(*map(jnp.asarray, args)))
    np.testing.assert_allclose(_port(args), ref, **TOL)


def test_plain_matches_pallas_fused_interpret():
    args = _args()
    ref = np.asarray(_pallas_lstm_fused(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(_port(args), ref, **TOL)


def test_plain_matches_pallas_unrolled_interpret():
    # T=13 with k=4: the backward direction meets the masked pad block first
    args = _args()
    ref = np.asarray(_pallas_lstm_fused_unrolled(*map(jnp.asarray, args), k=4,
                                                 interpret=True))
    np.testing.assert_allclose(_port(args), ref, **TOL)


def test_unidirectional_plain_matches_xla_scan():
    rng = np.random.default_rng(3)
    xp = rng.standard_normal((9, 5, 32)).astype(np.float32) * 0.5    # (T, B, 4H), time-major
    whh = rng.standard_normal((8, 32)).astype(np.float32) * 0.1
    ref = np.asarray(_xla_lstm_scan(jnp.asarray(xp), jnp.asarray(whh)))
    got = port_lstm.lstm_scan(torch.from_numpy(xp), torch.from_numpy(whh)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    args = [torch.from_numpy(a) for a in _args()]
    before = port_lstm.lstm_scan_fused.launches
    got = port_lstm.lstm_scan_fused(*args)
    assert port_lstm.lstm_scan_fused.launches == before
    torch.testing.assert_close(got, port_lstm.lstm_scan_fused_plain(*args), rtol=0, atol=0)


def test_plain_bf16_output_follows_input_dtype():
    # bf16 in, bf16 out; state and sums in f32, so close to the f32 result
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _args(B=4, T=5)]
    out = port_lstm.lstm_scan_fused_plain(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 5, 32)
    ref = port_lstm.lstm_scan_fused_plain(*[a.float() for a in args])
    assert (out.float() - ref).abs().max() < 3e-2


def test_kernel_wrapper_rejects_non_contiguous_before_touching_gpu():
    args = [torch.from_numpy(a) for a in _args()]
    args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)   # swapaxes layout
    assert not args[0].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        port_lstm._launch_kernel(*args)


def test_kernel_wrapper_rejects_unsupported_shapes():
    # past the wide kernel's H, past its C + H at an H it takes, and at odd (C, H):
    # the route steers the first two to the projection and pads the third, so the
    # checks stop only at the device
    wide_h, wide_k = port_lstm._FUSED_WIDE_MAX_H, port_lstm._FUSED_WIDE_MAX_K
    for H, C, route in ((wide_h + 8, 12, "projection+lstm_bidir2"),
                        (256, wide_k - 256 + 4, "projection+lstm_bidir2"),
                        (100, 102, "lstm_fused")):
        assert port_lstm._fused_route(C, H) == route
        args = [torch.from_numpy(a) for a in _args(B=2, T=2, H=H, C=C)]
        with pytest.raises(ValueError, match="CUDA"):
            port_lstm._check_kernel_args(*args)
    # H = 160 (csrc/lstm_fused_wide.cu) and H = 16 (csrc/lstm_fused.cu) pass the
    # limits and stop at the device
    for H in (160, 16):
        args = [torch.from_numpy(a) for a in _args(H=H)]
        with pytest.raises(ValueError, match="CUDA"):
            port_lstm._check_kernel_args(*args)

