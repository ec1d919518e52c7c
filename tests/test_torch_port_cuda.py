"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: skipped where no CUDA GPU is visible (a CUDA kernel has
no CPU mode). Run on a GPU machine with
    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
(--noconftest: tests/conftest.py sets up JAX, which these tests do not use).
Shapes are small but cover the ragged row tile, each rows-per-block
instance, float32 and bfloat16, and the 16-launch BSRNN forward.
"""
import math

import pytest
import torch

from nvse_tpu_torch.ops import lstm as port_lstm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from nvse_tpu_torch import resolve_device

    return resolve_device("cuda")


def _args(B, T, C, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = 1.0 / math.sqrt(H)
    x = torch.randn(B, T, C, generator=g)
    ws = [torch.empty(s).uniform_(-b, b, generator=g)
          for s in [(C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]]
    return [t.to("cuda", dtype) for t in [x, *ws]]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("B,T,C,H", [   # rows per block 2, 4 and 8 on a 132-SM card
    (3, 17, 12, 8), (200, 9, 128, 128), (300, 40, 64, 32)])
def test_kernel_matches_plain(cuda, B, T, C, H, dtype, tol):
    args = _args(B, T, C, H, dtype)
    n0 = port_lstm.lstm_scan_fused.launches
    got = port_lstm.lstm_scan_fused(*args)
    torch.cuda.synchronize()
    assert port_lstm.lstm_scan_fused.launches == n0 + 1
    ref = port_lstm.lstm_scan_fused_plain(*args)
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_kernel_raises_on_unsupported_hidden_size(cuda):
    with pytest.raises(NotImplementedError):
        port_lstm.lstm_scan_fused(*_args(2, 3, 8, 160, torch.float32))


def test_bsrnn_forward_launches_16_kernels(cuda):
    from nvse_tpu_torch.infer import InferenceEngine
    from nvse_tpu_torch.utils import AttrDict

    h = AttrDict(dict(model_name="BSRNN", feature_dim=16, num_repeat=8, causal=False,
                      sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024,
                      num_mels=80, fmin=0, fmax=8000, seed=1234))
    mel = torch.full((2, 80, 64), -4.0)
    n0 = port_lstm.lstm_scan_fused.launches
    gpu = InferenceEngine(h, device="cuda").forward(mel).cpu()
    assert port_lstm.lstm_scan_fused.launches - n0 == 16
    cpu = InferenceEngine(h, device="cpu").forward(mel)
    torch.testing.assert_close(gpu, cpu, rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# training kernels: lstm_fwd_hc, lstm_bwd (+ the dW_hh reduction)
# ---------------------------------------------------------------------------

def _seq_args(T, R, H, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(T, R, 4 * H, generator=g)
    whh = torch.empty(H, 4 * H).uniform_(-1 / math.sqrt(H), 1 / math.sqrt(H), generator=g)
    dhs = torch.randn(T, R, H, generator=g)
    return xp.to("cuda", dtype), whh.to("cuda", dtype), dhs.to("cuda", dtype)


# float32: the same arithmetic summed in another order over a few dozen
# steps; bfloat16: hs, cs and dx are stored with 8 bits of mantissa and the
# kernel and plain version may round a value on either side
SEQ_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 3e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,R,H", [(7, 3, 8), (9, 200, 128), (5, 300, 32), (34, 37, 128)])
def test_fwd_hc_and_bwd_match_plain(cuda, T, R, H, dtype):
    xp, whh, dhs = _seq_args(T, R, H, dtype)
    n = (port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches,
         port_lstm.lstm_dw_hh.launches)
    hs, cs = port_lstm.lstm_fwd_hc(xp, whh)
    dx, dw = port_lstm.lstm_bwd(xp, hs, cs, dhs, whh)
    torch.cuda.synchronize()
    assert (port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches,
            port_lstm.lstm_dw_hh.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    hs_ref, cs_ref = port_lstm.lstm_fwd_hc_plain(xp, whh)
    # the backward's reference from the kernel's own residuals, so that a
    # rounding flip in hs/cs does not count twice
    dx_ref, dw_ref = port_lstm.lstm_bwd_plain(xp, hs, cs, dhs, whh)
    atol, rtol = SEQ_TOL[dtype]
    for got, ref in ((hs, hs_ref), (cs, cs_ref), (dx, dx_ref), (dw, dw_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


def test_training_kernels_raise_on_unsupported(cuda):
    xp, whh, dhs = _seq_args(3, 2, 160, torch.float32)
    with pytest.raises(NotImplementedError, match="H <= 128"):
        port_lstm.lstm_fwd_hc(xp, whh)
    xp, whh, dhs = _seq_args(3, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        port_lstm.lstm_fwd_hc(xp, whh.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        port_lstm.lstm_bwd(xp.transpose(0, 1), dhs, dhs, dhs, whh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_bilstm_on_card_matches_cpu(cuda, dtype):
    B, T, C, H = 5, 11, 16, 32
    cpu = [a.cpu().float() for a in _args(B, T, C, H, torch.float32, seed=3)]
    g = torch.randn(B, T, 2 * H, generator=torch.Generator().manual_seed(4))

    def run(device, dt):
        args = [a.to(device, dt).requires_grad_() for a in cpu]
        out = port_lstm.lstm_scan_fused(*args)
        out.backward(g.to(device, dt))
        return [out.detach().float().cpu()] + [a.grad.float().cpu() for a in args]

    n0 = port_lstm.lstm_scan_fused.launches
    n_fwd, n_bwd = port_lstm.lstm_fwd_hc.launches, port_lstm.lstm_bwd.launches
    gpu = run("cuda", dtype)
    assert port_lstm.lstm_scan_fused.launches == n0          # the training route only
    assert port_lstm.lstm_fwd_hc.launches - n_fwd == 2
    assert port_lstm.lstm_bwd.launches - n_bwd == 2
    ref = run("cpu", dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, want in zip(gpu, ref):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
