"""Port parity: the spectral ops of the BSRNN path against nvse_tpu.ops.

Same numpy inputs through both packages; the JAX side runs its CPU path
(rfft/irfft). float32 at rtol/atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nvse_tpu import ops as jops
from nvse_tpu_torch.ops import spectral as tops
from test_torch_port_joint import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
MEL = (1024, 80, 22050, 256, 1024, 0, 8000)   # n_fft, mels, sr, hop, win, fmin, fmax


def test_host_bases_match():
    np.testing.assert_array_equal(tops.hann_window(1024), jops.hann_window(1024))
    from nvse_tpu.ops.spectral import _inv_mel_basis_np, _mel_filterbank_np
    np.testing.assert_array_equal(tops._mel_filterbank_np(22050, 1024, 80, 0.0, 8000.0),
                                  _mel_filterbank_np(22050, 1024, 80, 0.0, 8000.0))
    np.testing.assert_array_equal(tops._inv_mel_basis_np(22050, 1024, 80, 0.0, 8000.0),
                                  _inv_mel_basis_np(22050, 1024, 80, 0.0, 8000.0))


@pytest.mark.parametrize("const", ["hann", "mel_basis", "inv_mel_basis"])
def test_cached_host_constants_are_read_only(const):
    """The port's cached host constants are shared by every later transform of
    the process: a caller that wrote into one would change them all. Writing
    raises."""
    a = {"hann": lambda: tops.hann_window(1024),
         "mel_basis": lambda: tops._mel_filterbank_np(22050, 1024, 80, 0.0, 8000.0),
         "inv_mel_basis": lambda: tops._inv_mel_basis_np(22050, 1024, 80, 0.0, 8000.0)}[const]()
    before = a.copy()
    assert not a.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        a[0] = 7.0
    np.testing.assert_array_equal(a, before)


def test_inverse_mel():
    mel = np.random.default_rng(0).standard_normal((2, 80, 17)).astype(np.float32) - 4.0
    ref = np.asarray(jops.inverse_mel(jnp.asarray(mel), *MEL))
    got = tops.inverse_mel(torch.from_numpy(mel), *MEL).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (512, 128, 400)])
def test_istft_ri(n_fft, hop, win):
    rng = np.random.default_rng(1)
    F, T = n_fft // 2 + 1, 23
    re = rng.standard_normal((2, F, T)).astype(np.float32)
    im = rng.standard_normal((2, F, T)).astype(np.float32)
    w = jops.hann_window(win)
    ref = np.asarray(jops.istft_ri(jnp.asarray(re), jnp.asarray(im), n_fft, hop, win, window=w))
    got = tops.istft_ri(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop, win,
                        window=tops.hann_window(win)).numpy()
    assert got.shape == ref.shape == (2, hop * (T - 1))
    np.testing.assert_allclose(got, ref, **TOL)


def test_mel_spectrogram_np():
    y = (0.3 * np.random.default_rng(2).standard_normal((2, 5000))).astype(np.float32)
    ref = jops.mel_spectrogram_np(y, *MEL)
    got = tops.mel_spectrogram_np(y, *MEL)
    np.testing.assert_allclose(got, ref, **TOL)


def test_mel_spectrogram_torch():
    y = (0.3 * np.random.default_rng(3).standard_normal((2, 5000))).astype(np.float32)
    ref = np.asarray(jops.mel_spectrogram(jnp.asarray(y), *MEL))
    got = tops.mel_spectrogram(torch.from_numpy(y), *MEL).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("n_fft,hop,win,hann", [(1024, 256, 1024, True), (512, 128, 400, True),
                                                (2048, 512, 2048, False), (512, 128, 400, False)])
def test_stft_ri(n_fft, hop, win, hann):
    # window=None: ones(win) zero-padded to n_fft (the MRD's rectangular window)
    y = (0.3 * np.random.default_rng(4).standard_normal((2, 4096))).astype(np.float32)
    w = jops.hann_window(win) if hann else None
    ref = jops.stft_ri(jnp.asarray(y), n_fft, hop, win, window=w)
    got = tops.stft_ri(torch.from_numpy(y), n_fft, hop, win,
                       window=tops.hann_window(win) if hann else None)
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (2, n_fft // 2 + 1, 4096 // hop + 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("eps", [1e-7, 1e-5])
def test_amp_pha_spectrum(eps):
    y = (0.3 * np.random.default_rng(5).standard_normal((2, 4096))).astype(np.float32)
    y[:, :512] = 0.0   # exact-zero bins: the 1e-24 floor under the sqrt
    ref = jops.amp_pha_spectrum(jnp.asarray(y), 1024, 256, 1024, eps=eps)
    got = tops.amp_pha_spectrum(torch.from_numpy(y), 1024, 256, 1024, eps=eps)
    for name, a, b in zip(("logamp", "phase", "real", "imag"), got, ref):
        a, b = a.numpy(), np.asarray(b)
        if name == "phase":   # compared as the wrapped difference where the bin is not silent
            live = np.asarray(ref[0]) > np.log(1e-3)
            d = np.angle(np.exp(1j * (a.astype(np.float64) - b)))[live]
            assert np.abs(d).max() < 1e-3, name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_safe_magnitude_gradient_is_zero_at_silence():
    re = torch.zeros(3, requires_grad=True)
    im = torch.zeros(3, requires_grad=True)
    tops._safe_magnitude(re, im).sum().backward()
    assert torch.equal(re.grad, torch.zeros(3)) and torch.equal(im.grad, torch.zeros(3))
