"""Port parity and behaviour of streaming decode (BSRNN family), on the CPU.

istft_frames / StreamingOLA against nvse_tpu.ops' at 1e-5 (float32 irfft
against the JAX package's DFT; the overlap-add itself is float64 on both
sides); both chunked decoders of the port's engine against the JAX
engine's on the same weights and mel at the whole-model tolerances of
tests/test_torch_parity.py (rtol 2e-3 / atol 2e-4); and the properties
the JAX tests hold (tests/test_inference.py:152-223): state-carrying
streaming of a causal config equals the offline decode, batch rows are
independent streams.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu import ops as jax_ops
from nvse_tpu.infer.engine import InferenceEngine as JaxEngine
from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import read_wav, write_wav
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.ops import StreamingOLA, hann_window, istft_frames, istft_ri
from nvse_tpu_torch.utils import params_from_jax

from test_torch_port_bsrnn import jax_params

N_FFT, HOP, WIN = 64, 16, 48


def _h(**kw):
    d = dict(model_name="BSRNN", feature_dim=8, num_repeat=2, dropout=0.0, causal=True,
             sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, seed=1234)
    d.update(kw)
    return AttrDict(d)


def _mel(B, T, seed=0):
    return np.random.default_rng(seed).standard_normal((B, 80, T)).astype(np.float32) - 4.0


# ---------------------------------------------------------------------------
# istft_frames + StreamingOLA
# ---------------------------------------------------------------------------

def _ri(B=2, T=11, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N_FFT // 2 + 1, T)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("window", ["hann", None])
def test_istft_frames_matches_jax(window):
    re, im = _ri()
    win = None if window is None else hann_window(WIN)
    ref = jax_ops.istft_frames(jnp.asarray(re), jnp.asarray(im), N_FFT, WIN, window=win)
    got = istft_frames(torch.from_numpy(re), torch.from_numpy(im), N_FFT, WIN, window=win)
    assert got.shape == (2, 11, N_FFT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", ["hann", None])
def test_streaming_ola_matches_jax_and_offline_istft(window):
    re, im = _ri(T=12, seed=1)
    win = None if window is None else hann_window(WIN)
    frames = istft_frames(torch.from_numpy(re), torch.from_numpy(im), N_FFT, WIN, window=win)
    frames = frames.numpy()
    ours, theirs = StreamingOLA(N_FFT, HOP, WIN, window=win), jax_ops.StreamingOLA(N_FFT, HOP, WIN, window=win)
    assert ours.flush().shape == (1, 0)                      # nothing pushed yet
    got, ref = [], []
    for a, b in ((0, 5), (5, 6), (6, 12)):                   # uneven chunks, one of a single frame
        got.append(ours.push(frames[:, a:b]))
        ref.append(theirs.push(frames[:, a:b]))
        assert got[-1].shape == (2, (b - a) * HOP) and got[-1].dtype == np.float32
    got.append(ours.flush())
    ref.append(theirs.flush())
    got, ref = np.concatenate(got, -1), np.concatenate(ref, -1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # all emissions, less the center crop, are the offline iSTFT
    full = istft_ri(torch.from_numpy(re), torch.from_numpy(im), N_FFT, HOP, WIN, window=win)
    np.testing.assert_allclose(got[:, N_FFT // 2:][:, : full.shape[-1]], full.numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# end to end: the engine's two chunked decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,B", [(True, 1), (True, 2), (False, 1), (False, 2)])
def test_streaming_decoders_match_jax_engine(causal, B):
    h = _h(causal=causal)
    T, c, ctx = 40, 16, 8                                    # a ragged last chunk
    mel = _mel(B, T, seed=B)
    jgen, _ = jax_build(h)
    jp = jax_params(jgen, mel)
    jeng = JaxEngine(h, params=jax.tree.map(jnp.asarray, jp))
    eng = InferenceEngine(h, params=params_from_jax(jp, h), device="cpu")
    out_len = (T - 1) * 256
    for name, kw in (("synthesize_streaming", dict(context_frames=ctx)),
                     ("synthesize_streaming_stateful", dict(lookahead_frames=ctx))):
        ref = np.asarray(getattr(jeng, name)(jnp.asarray(mel), out_len=out_len, chunk_frames=c, **kw))
        got = getattr(eng, name)(torch.from_numpy(mel), out_len=out_len, chunk_frames=c, **kw)
        assert got.shape == ref.shape == (B, out_len) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4, err_msg=name)
    assert eng.synthesize_streaming_stateful(mel, chunk_frames=c).shape == (B, T * 256)


@pytest.mark.parametrize("lookahead", [0, 8])
def test_stateful_streaming_equals_offline_decode_for_causal(lookahead):
    """Carried LSTM state + carried overlap-add tail: the chunked decode of a
    causal config is the full-utterance decode up to float order (the JAX
    test's limit: max |diff| / max |full| < 1e-4), with or without lookahead
    frames, which a causal model must not read."""
    eng = InferenceEngine(_h(), device="cpu", bucket_frames=32)
    T = 96
    mel = _mel(1, T)
    out_len = (T - 1) * 256
    full = eng.synthesize_mel(mel, out_len=out_len)
    stream = eng.synthesize_streaming_stateful(mel, out_len=out_len, chunk_frames=32,
                                               lookahead_frames=lookahead)
    assert stream.shape == full.shape
    assert np.abs(full - stream).max() / (np.abs(full).max() + 1e-9) < 1e-4


def test_stateful_streaming_beats_recompute_for_noncausal():
    # the forward direction exact, the backward one bounded by the lookahead:
    # a smaller interior error than the symmetric context recompute (JAX test's 0.15)
    eng = InferenceEngine(_h(causal=False), device="cpu", bucket_frames=32)
    T = 128
    mel = _mel(1, T, seed=1)
    out_len = (T - 1) * 256
    full = eng.synthesize_mel(mel, out_len=out_len)
    recompute = eng.synthesize_streaming(mel, out_len=out_len, chunk_frames=32, context_frames=16)
    stateful = eng.synthesize_streaming_stateful(mel, out_len=out_len, chunk_frames=32,
                                                 lookahead_frames=16)
    sl = slice(16 * 256, out_len - 16 * 256)
    scale = np.abs(full[0, sl]).mean() + 1e-9
    err_r = np.abs(full[0, sl] - recompute[0, sl]).mean() / scale
    err_s = np.abs(full[0, sl] - stateful[0, sl]).mean() / scale
    assert err_s < err_r and err_s < 0.15, (err_s, err_r)


def test_stateful_streaming_batch_rows_are_independent_streams():
    eng = InferenceEngine(_h(num_repeat=1), device="cpu")
    mel = _mel(2, 64, seed=2)
    both = eng.synthesize_streaming_stateful(mel, chunk_frames=32, lookahead_frames=0)
    for r in range(2):
        solo = eng.synthesize_streaming_stateful(mel[r:r + 1], chunk_frames=32, lookahead_frames=0)
        np.testing.assert_allclose(both[r:r + 1], solo, rtol=0, atol=1e-5)


def test_streaming_bf16_compute_dtype_runs_and_returns_float32_states():
    eng = InferenceEngine(_h(causal=False, compute_dtype="bfloat16"), device="cpu")
    mel = _mel(1, 24)
    wav = eng.synthesize_streaming_stateful(mel, chunk_frames=8, lookahead_frames=4)
    assert wav.dtype == np.float32 and wav.shape == (1, 24 * 256) and np.isfinite(wav).all()
    frames, states = eng._stream_step(eng._stream_state_zeros(1), torch.from_numpy(mel[..., :12]), 8)
    assert frames.shape == (1, 8, 1024) and frames.dtype == torch.float32
    assert len(states) == 2 and states[0][0].shape == (1, 34, 8)
    assert all(s.dtype == torch.float32 for st in states for s in st)
    # the carry is the trunk's bf16 state: every value is a bf16 number
    torch.testing.assert_close(states[0][1], states[0][1].bfloat16().float(), rtol=0, atol=0)


def test_stateful_streaming_needs_stream_state_support(monkeypatch):
    eng = InferenceEngine(_h(), device="cpu")
    monkeypatch.setattr(type(eng.generator), "supports_stream_state", False)
    with pytest.raises(ValueError, match="stream_state"):
        eng.synthesize_streaming_stateful(_mel(1, 16))


@pytest.mark.parametrize("mode", ["recompute", "stateful"])
def test_run_inference_stream_writes_files(tmp_path, mode):
    wav_dir = tmp_path / "wavs"
    lengths = [5000, 9000]
    for i, n in enumerate(lengths):
        t = np.arange(n) / 22050
        write_wav(str(wav_dir / f"u{i}.wav"), 0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t), 22050)
    h = _h(test_input_wavs_dir=str(wav_dir), test_output_dir=str(tmp_path / "out"), stream=1,
           stream_chunk_frames=16, stream_context_frames=8, stream_mode=mode)
    lines = []
    stats = run_inference(h, log_fn=lines.append, device="cpu")
    assert stats["files"] == 2 and stats["rtf"] > 0 and lines[0].startswith("decoded 2 files")
    for i, n in enumerate(lengths):
        y, sr = read_wav(str(tmp_path / "out" / f"u{i}.wav"))
        assert sr == 22050 and y.shape == (n,) and np.isfinite(y).all() and np.abs(y).max() > 0


def test_cached_constants_made_under_inference_mode_serve_autograd_later():
    """A decode under torch.inference_mode() fills the caches of device
    constants (window, mel bases, iSTFT envelope); a training step that
    reads the same entries afterwards must be able to save them for backward."""
    from nvse_tpu_torch.ops import inverse_mel, mel_spectrogram, stft_ri

    n_fft, hop, win = 128, 32, 96                  # sizes no other test caches
    window = hann_window(win)
    margs = (n_fft, 20, 16000, hop, win, 0, 8000)
    rng = np.random.default_rng(0)
    re, im = (torch.from_numpy(rng.standard_normal((1, n_fft // 2 + 1, 9)).astype(np.float32))
              for _ in range(2))
    y = torch.from_numpy(rng.standard_normal((1, 8 * hop)).astype(np.float32))
    with torch.inference_mode():
        istft_frames(re, im, n_fft, win, window=window)
        istft_ri(re, im, n_fft, hop, win, window=window)
        inverse_mel(mel_spectrogram(y, *margs), *margs)
    y.requires_grad_()
    re.requires_grad_()
    a, b = stft_ri(y, n_fft, hop, win, window=window)
    loss = (a.square().mean() + b.square().mean() + mel_spectrogram(y, *margs).mean()
            + istft_ri(re, im, n_fft, hop, win, window=window).square().mean())
    loss.backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().sum() > 0 and re.grad.abs().sum() > 0
