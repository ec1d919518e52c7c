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
