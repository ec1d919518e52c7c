"""Port parity of BSRNN-L's paths against the JAX package, on the CPU.

BSRNN-L is BSRNN at feature_dim 256 (nvse_tpu_torch/configs/bsrnn_l_config.json):
H = C = 256 in every LSTM, past the H <= 128 of csrc/lstm_fused.cu and
csrc/lstm_scan.cu, so on the card its LSTMs take the wide kernels of
csrc/lstm_fused_wide.cu and csrc/lstm_scan_wide.cu. Here the same paths run
their plain versions at a tiny width with H > 128: feature_dim 136 (H % 8 ==
0, C % 4 == 0), one BSNet, batch 1-2, at most 32 frames, numpy inputs from a
seed, weights through params_from_jax. Tolerances: the whole model at those
of tests/test_torch_parity.py (rtol 2e-3 / atol 2e-4, phase as the wrapped
difference at 5e-3); the LSTMs at rtol/atol 1e-5 (the same float32
arithmetic summed in another order); the causal stream against the offline
decode at max |diff| / max |offline| < 1e-4 (the JAX package's limit);
validation metrics at rtol 1e-3, as tests/test_torch_port_train.py.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.ops import pallas_lstm as jax_lstm
from nvse_tpu.train.trainer import GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.infer import InferenceEngine
from nvse_tpu_torch.models import build_generator
from nvse_tpu_torch.ops import lstm as port_lstm
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.utils import load_config, params_from_jax

from test_torch_port_bsrnn import assert_tf_outputs_close, jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTH = 136      # > 128: the wide kernels' range on the card


def _h(causal=False, **kw):
    d = dict(model_name="BSRNN", feature_dim=WIDTH, num_repeat=1, dropout=0.0, causal=causal,
             sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024, num_mels=80,
             fmin=0, fmax=8000, meloss=None, segment_size=2048, batch_size=2,
             learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, mrd_weight=0.1,
             mpd_reshapes=[2, 3, 5, 7, 11], seed=1234)
    d.update(kw)
    return AttrDict(d)


def _mel(B, T, seed=0):
    return np.random.default_rng(seed).standard_normal((B, 80, T)).astype(np.float32) - 4.0


def _bridged(h, seed=0):
    """(JAX generator, its seeded numpy params, the port generator holding them)."""
    jgen, _ = jax_build(h)
    jp = jax_params(jgen, _mel(1, 8), seed=seed)
    gen, _ = build_generator(h)
    gen.load_state_dict(params_from_jax(jp, h))
    return jgen, jp, gen


# ---------------------------------------------------------------------------
# the whole generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_generator_at_wide_h_matches_jax(causal):
    h = _h(causal)
    jgen, jp, gen = _bridged(h)
    x = _mel(2, 24)
    theirs = jax.jit(jgen.apply)({"params": jp}, jnp.asarray(x))
    with torch.no_grad():
        ours = [t.numpy() for t in gen(torch.from_numpy(x))]
    assert ours[-1].shape == (2, 256 * 23)
    assert_tf_outputs_close(ours, theirs)


def test_bsrnn_l_config_builds_38_57_m_parameters():
    """The full config on the CPU, built and not run: the paper's 38.61 M
    (QUALITY.md:210) less the 32 x 1024 b_hh entries that the port sums into
    one LSTM bias per direction."""
    h = load_config(os.path.join(os.path.dirname(__file__), "..", "nvse_tpu_torch", "configs",
                                 "bsrnn_l_config.json"))
    assert (h.feature_dim, h.num_repeat, h.batch_size, h.segment_size) == (256, 8, 16, 16384)
    gen, domain = build_generator(h)
    assert domain == "tf"
    n = sum(p.numel() for p in gen.parameters())
    assert n == 38_572_293 == 38_605_061 - 32 * 1024
    hidden = {p.shape[0] for name, p in gen.named_parameters() if ".w_hh_" in name}
    assert hidden == {256}


# ---------------------------------------------------------------------------
# the LSTMs' plain versions at H > 128 against the JAX references
# ---------------------------------------------------------------------------

def _fused_args(B=3, T=7, C=WIDTH, H=WIDTH, seed=0):
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(H)
    shapes = [(B, T, C), (C, 4 * H), (C, 4 * H), (4 * H,), (4 * H,), (H, 4 * H), (H, 4 * H)]
    return [(rng.uniform(-b, b, s) if i else rng.standard_normal(s)).astype(np.float32)
            for i, s in enumerate(shapes)]


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_fused_plain_at_wide_h_matches_jax(ref):
    args = _fused_args()
    if ref == "xla":
        want = jax_lstm._xla_lstm_fused_ref(*map(jnp.asarray, args))
    else:
        want = jax_lstm._pallas_lstm_fused(*map(jnp.asarray, args), interpret=True)
    got = port_lstm.lstm_scan_fused_plain(*map(torch.from_numpy, args))
    assert got.shape == (3, 7, 2 * WIDTH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scan_plains_at_wide_h_match_xla():
    T, R, H = 9, 5, WIDTH
    rng = np.random.default_rng(1)
    xp = (rng.standard_normal((T, R, 4 * H)) * 0.5).astype(np.float32)
    whh = (rng.standard_normal((H, 4 * H)) * 0.05).astype(np.float32)
    h0, c0 = ((rng.standard_normal((R, H)) * 0.3).astype(np.float32) for _ in range(2))
    got = port_lstm.lstm_scan_plain(torch.from_numpy(xp), torch.from_numpy(whh))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_lstm._xla_lstm_scan(xp, whh)), **TOL)
    hs, cs = port_lstm.lstm_scan_stateful_plain(*map(torch.from_numpy, (xp, whh, h0, c0)))
    ref = jax_lstm._xla_lstm_scan_stateful(*map(jnp.asarray, (xp, whh, h0, c0)))
    for a, b in zip((hs, cs), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_kernel_limits_take_bsrnn_l_and_refuse_past_the_wide_kernels():
    """What the wrappers check before touching a GPU: C = H = 256 passes every
    check (and stops only at the device); past the fused kernels' H > 512 and
    C + H > 1280 (HD-Demucs's H = 768) the route takes the projection, past the
    scans' H > 768 the step-wise kernel, so those shapes stop only at the device
    too; the wide kernels refuse a misaligned view."""
    t = lambda *s: torch.zeros(*s)
    H = 256
    fused = [torch.from_numpy(a) for a in _fused_args(2, 2, H, H)]
    for check in (lambda: port_lstm._check_kernel_args(*fused),
                  lambda: port_lstm._launch_scan(port_lstm.lstm_scan, t(2, 3, 4 * H), t(H, 4 * H)),
                  lambda: port_lstm._launch_scan(port_lstm.lstm_scan_stateful, t(2, 3, 4 * H),
                                                 t(H, 4 * H), initial=(t(3, H), t(3, H)))):
        with pytest.raises(ValueError, match="CUDA"):
            check()
    for C, H in ((8, 520), (768, 768), (1536, 768)):
        assert port_lstm._fused_route(C, H) == "projection+lstm_bidir2"
        with pytest.raises(ValueError, match="CUDA"):
            port_lstm._check_kernel_args(*map(torch.from_numpy, _fused_args(1, 1, C, H)))
    assert port_lstm._kernel_source("lstm_scan", 776) == "lstm_stepwise"
    with pytest.raises(ValueError, match="CUDA"):
        port_lstm._launch_scan(port_lstm.lstm_scan, t(2, 3, 4 * 776), t(776, 4 * 776))
    assert port_lstm._MAX_H == 128 < 256 <= port_lstm._FUSED_WIDE_MAX_H <= port_lstm._WIDE_MAX_H
    with pytest.raises(ValueError, match="16-byte aligned"):
        port_lstm._check_aligned("lstm_scan", t(1 + 4 * 8)[1:])


# ---------------------------------------------------------------------------
# streaming and validation (the trainer's float16: tests/test_torch_port_c7.py)
# ---------------------------------------------------------------------------

def test_causal_stream_at_wide_h_equals_offline_decode():
    """The state (h, c) of width 136 carried across chunks through
    lstm_scan_stateful: the stream is the offline decode."""
    h = _h(causal=True)
    eng = InferenceEngine(h, device="cpu", bucket_frames=32)
    _, _, gen = _bridged(h, seed=3)
    eng.generator.load_state_dict(gen.state_dict())
    T = 32
    mel = _mel(2, T, seed=4)
    out_len = (T - 1) * 256
    full = eng.synthesize_mel(mel, out_len=out_len)
    stream = eng.synthesize_streaming_stateful(mel, out_len=out_len, chunk_frames=16,
                                               lookahead_frames=4)
    assert stream.shape == full.shape == (2, out_len)
    assert np.abs(full - stream).max() / (np.abs(full).max() + 1e-9) < 1e-4
    assert [s[0].shape for s in eng._stream_state_zeros(2)] == [(2, 34, WIDTH)]


def test_causal_stream_tail_past_the_bucket_matches_the_jax_engine():
    """48 frames: the offline decode pads them to its 64-frame bucket, and a
    stream in chunks of 24 ends with the input. The two then differ in the
    last n_fft / 2 samples, where the offline iSTFT adds the padded frames'
    windows and the stream's flush has none. The JAX engine does the same:
    the port equals it in both decodes, and before that tail the stream
    equals the offline decode."""
    from nvse_tpu.infer.engine import InferenceEngine as JaxEngine

    h = _h(causal=True)
    _, jp, gen = _bridged(h, seed=3)
    port = InferenceEngine(h, device="cpu")
    port.generator.load_state_dict(gen.state_dict())
    ref = JaxEngine(h, params=jax.tree.map(jnp.asarray, jp))
    T, out_len = 48, 47 * 256
    mel = _mel(2, T, seed=4)
    got = {}
    for name, eng, m in (("port", port, torch.from_numpy(mel)), ("jax", ref, jnp.asarray(mel))):
        got[name] = [np.asarray(eng.synthesize_mel(m, out_len=out_len)),
                     np.asarray(eng.synthesize_streaming_stateful(
                         m, out_len=out_len, chunk_frames=24, lookahead_frames=8))]
    for ours, theirs in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-4)
    tail = T * 256 - h.n_fft // 2
    for offline, stream in got.values():
        scale = np.abs(offline).max()
        assert np.abs(stream - offline)[:, :tail].max() < 1e-4 * scale
        assert np.abs(stream - offline)[:, tail:].max() > 1e-2 * scale


def test_eval_step_at_wide_h_matches_jax():
    """GANTrainer.eval_step (no grad: the BiLSTMs take lstm_scan_fused's
    inference route) against the JAX step's eval_step on a fixed crop."""
    h = _h()
    jgen, jp, _ = _bridged(h, seed=5)
    state = GenState.create(apply_fn=jgen.apply, params=jax.tree.map(jnp.asarray, jp),
                            tx=jax_make_optimizer(h, 10))
    rng = np.random.default_rng(6)
    t = np.arange(4096) / 22050.0
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)[None] + 0.05 * rng.standard_normal((1, 4096)))
    audio = audio.astype(np.float32)
    _, ref = make_train_step(h, jgen, "tf").eval_step(state, jnp.asarray(audio))
    tr = GANTrainer(h, device="cpu")
    tr.generator.load_state_dict(params_from_jax(jp, h))
    calls = []
    orig = port_lstm._BiLSTMSaving.apply
    port_lstm._BiLSTMSaving.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        _, got = tr.eval_step(torch.from_numpy(audio))
    finally:
        port_lstm._BiLSTMSaving.apply = orig
    assert calls == []                         # the inference route, not the training one
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-3, err_msg=k)
