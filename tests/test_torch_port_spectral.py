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

TOL = dict(rtol=1e-5, atol=1e-5)
MEL = (1024, 80, 22050, 256, 1024, 0, 8000)   # n_fft, mels, sr, hop, win, fmin, fmax


def test_host_bases_match():
    np.testing.assert_array_equal(tops.hann_window(1024), jops.hann_window(1024))
    from nvse_tpu.ops.spectral import _inv_mel_basis_np, _mel_filterbank_np
    np.testing.assert_array_equal(tops._mel_filterbank_np(22050, 1024, 80, 0.0, 8000.0),
                                  _mel_filterbank_np(22050, 1024, 80, 0.0, 8000.0))
    np.testing.assert_array_equal(tops._inv_mel_basis_np(22050, 1024, 80, 0.0, 8000.0),
                                  _inv_mel_basis_np(22050, 1024, 80, 0.0, 8000.0))


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
