"""Port parity: HD-Demucs (nvse_tpu_torch/models/hddemucas.py), its sinc
resampling (ops/resample.py) and the dilated ConvTranspose1d against the JAX
package, on the CPU.

Both packages get the same seeded numpy weights (in the JAX tree's shapes,
mapped by params_from_jax) and the same numpy mel. HD-Demucs is narrowed to
hidden 4, depth 3 (channels 4, 8, 16: a bottleneck LSTM of H = 16) and runs
16 mel frames. "rand" and "griffin_lim" get the JAX package's
jax.random.PRNGKey(0) draw passed in as theta (the port's default draw comes
from a torch generator). Tolerances: the resampling and the conv layer at
1e-5 (the same sums in another order); the whole model at rtol 2e-3 / atol
2e-4 on the waveform, as the other models' parity tests.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import hddemucas as jax_hd
from nvse_tpu.models import layers as jax_layers
from nvse_tpu.ops import resample as jax_resample
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import read_wav
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.models import build_generator, hddemucas
from nvse_tpu_torch.models.layers import ConvTranspose1d
from nvse_tpu_torch.ops import default_phase, downsample2, upsample2
from nvse_tpu_torch.utils import load_config, params_from_jax
from nvse_tpu_torch.utils.jax_params import _conv1d
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-3, atol=2e-4)
B, FRAMES = 2, 16


def _h(**kw):
    d = dict(model_name="HDDemucas", sampling_rate=22050, n_fft=1024, hop_size=256,
             win_size=1024, num_mels=80, fmin=0, fmax=8000, chin=1, chout=1, hidden=4, depth=3,
             kernel_size=8, stride=4, causal=False, resample=4, growth=2, max_hidden=10000,
             normalize=False, glu=True, rescale=0.1, floor=0.001, init_phase="griffin_lim",
             seed=1234)
    d.update(kw)
    return AttrDict(d)


def _seeded(module, *xs, seed=0):
    """Seeded numpy values in the shapes of a flax module's parameter tree
    (eval_shape: no JAX init): kernels at U(+-1/sqrt(fan-in)), the scalar
    fusion weight at 0.3-0.7."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *xs)["params"]

    def leaf(s):
        if not s.shape:
            return np.float32(rng.uniform(0.3, 0.7))
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0.3
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree.map(leaf, shapes)


def _mel(T=FRAMES, M=80, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, M, T)) - 4.0).astype(np.float32)


def _jax_theta(shape):
    return np.array(jax.random.uniform(jax.random.PRNGKey(0), shape, minval=-jnp.pi,
                                       maxval=jnp.pi))


def _pair(h, seed=3):
    """(JAX module, its numpy params, the port generator with the same weights)."""
    jm = jax_hd.HDDemucas.from_config(h)
    jp = _seeded(jm, jnp.asarray(_mel(M=h.num_mels)[:1, :, :8]), seed=seed)
    gen, domain = build_generator(h)
    assert domain == "time"
    gen.load_state_dict(params_from_jax(jp, h))
    return jm, jp, gen


# ---------------------------------------------------------------------------
# resampling and the dilated transposed conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["upsample2", "downsample2"])
@pytest.mark.parametrize("length", [64, 65, 300, 1])
def test_resample_matches_jax(fn, length):
    x = np.random.default_rng(length).standard_normal((2, 3, length)).astype(np.float32)
    ref = np.asarray(getattr(jax_resample, fn)(jnp.asarray(x)))
    got = globals()[fn](torch.from_numpy(x)).numpy()
    want = 2 * length if fn == "upsample2" else -(-length // 2)
    assert got.shape == ref.shape == (2, 3, want)
    np.testing.assert_allclose(got, ref, **TOL)


def test_resample_runs_in_the_inputs_dtype():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 1, 96)).astype(np.float32))
    for fn in (upsample2, downsample2):
        y = fn(x.to(torch.bfloat16))
        assert y.dtype == torch.bfloat16
        assert (y.float() - fn(x)).abs().max() < 0.05 * x.abs().max()


@pytest.mark.parametrize("cin,cout,k,stride,dilation,padding", [
    (4, 3, 8, 4, 1, 0), (4, 3, 8, 4, 3, 7), (8, 4, 8, 4, 5, 14), (3, 2, 5, 2, 9, 28),
    (2, 2, 3, 1, 2, 1)])
def test_conv_transpose1d_with_dilation_matches_jax(cin, cout, k, stride, dilation, padding):
    x = np.random.default_rng(3).standard_normal((2, 11, cin)).astype(np.float32)
    jmod = jax_layers.ConvTranspose1d(cin, cout, k, stride=stride, dilation=dilation,
                                      padding=padding)
    jp = _seeded(jmod, jnp.asarray(x), seed=4)
    ref = np.asarray(jmod.apply({"params": jp}, jnp.asarray(x)))
    ours = ConvTranspose1d(cin, cout, k, stride, padding, dilation)
    sd = {}
    _conv1d(jp, "m", sd, transposed=True)
    ours.load_state_dict({k.split(".")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 10 * stride - 2 * padding + dilation * (k - 1) + 1, cout)
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

MODEL_CASES = [
    dict(init_phase="zero"),
    dict(init_phase="griffin_lim"),
    dict(init_phase="rand"),
    dict(init_phase="zero", causal=True),
    dict(init_phase="zero", normalize=True),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_hddemucas_matches_jax(case):
    h = _h(**case)
    jm, jp, gen = _pair(h)
    mel = _mel()
    ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(mel)))
    theta = torch.from_numpy(_jax_theta((B, 513, FRAMES)))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel), theta=theta).numpy()
    assert got.shape == ref.shape == (B, 256 * (FRAMES - 1))
    assert gen.lstm.linear is None if case.get("causal") else gen.lstm.linear is not None
    np.testing.assert_allclose(got, ref, **MODEL_TOL)


@pytest.mark.parametrize("T", [1, 2, 3, 4])
def test_output_length_matches_jax(T):
    """At hop 6 a wave of 6 (T - 1) samples: 0, 6, 12 and 18, two of them no
    multiple of 4; the map decoder's dilated transposed convs must give the
    mask decoder's skip lengths at every stage. The waves of the two that are
    no multiple of 4 are held against the JAX model too."""
    h = _h(init_phase="zero", n_fft=64, win_size=64, hop_size=6, num_mels=16, fmax=11025)
    jm, jp, gen = _pair(h)
    mel = _mel(T=T, M=16)
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    assert got.shape == (B, 6 * (T - 1)) and np.isfinite(got).all()
    assert gen.valid_length(6 * (T - 1)) == jm.valid_length(6 * (T - 1))
    if (6 * (T - 1)) % 4:
        ref = np.asarray(jm.apply({"params": jp}, jnp.asarray(mel)))
        assert ref.shape == got.shape
        np.testing.assert_allclose(got, ref, **MODEL_TOL)


def test_bottleneck_runs_the_port_lstm_wrappers(monkeypatch):
    """The BiLSTMs go through lstm_scan_fused (on the card: the projection and
    one lstm_scan_bidir2 launch each), the causal LSTMs through lstm_scan."""
    from nvse_tpu_torch.models import layers

    calls = []
    for name in ("lstm_scan_fused", "lstm_scan"):
        orig = getattr(layers, name)
        monkeypatch.setattr(layers, name,
                            lambda *a, _n=name, _o=orig: calls.append((_n, a[0].shape)) or _o(*a))
    for causal in (False, True):
        gen, _ = build_generator(_h(init_phase="zero", causal=causal))
        with torch.no_grad():
            gen(torch.from_numpy(_mel()))
    names = [c[0] for c in calls]
    assert names == ["lstm_scan_fused"] * 2 + ["lstm_scan"] * 2
    assert calls[0][1][-1] == 16 and calls[1][1][-1] == 32      # C = H, then 2H


def test_default_phase_is_the_shared_draw():
    gen, _ = build_generator(_h())
    mel = torch.from_numpy(_mel())
    with torch.inference_mode():
        first = gen(mel)
    theta = default_phase((B, 513, FRAMES), torch.device("cpu"))
    with torch.no_grad():
        torch.testing.assert_close(gen(mel, theta=theta), first, rtol=0, atol=0)


def test_bfloat16_trunk_keeps_the_dsp_front_in_float32():
    """A bfloat16 mel into bfloat16 params: the initial wave reaches the
    upsampling in float32 and the encoder casts it; the output is within 0.1
    relative L2 of the float32 decode."""
    gen, _ = build_generator(_h(init_phase="griffin_lim"))
    mel = torch.from_numpy(_mel())
    seen = []
    gen.encoder[0].first.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    with torch.no_grad():
        ref = gen(mel)
        gen.to(torch.bfloat16)
        got = gen(mel.to(torch.bfloat16))
    assert seen == [torch.float32, torch.float32]
    assert got.shape == ref.shape and torch.isfinite(got.float()).all()
    assert ((got.float() - ref).norm() / ref.norm()).item() < 0.1


def test_full_config_builds_with_the_jax_parameter_count():
    """The shipped config (hidden 48, depth 5, growth 2: a bottleneck of
    H = 768), built and not run: its parameter count equals the JAX init's
    less the b_hh the port sums into b_ih, and the parameter map covers
    every tensor."""
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "hddemucas_config.json"))
    gen, domain = build_generator(h)
    n_ours = sum(p.numel() for p in gen.parameters())
    shapes = jax.eval_shape(jax_hd.HDDemucas.from_config(h).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 80, 8)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    # the JAX LSTMs keep b_ih and b_hh, the port their sum: 2 layers x 2 directions x 4H
    n_b_hh = sum(int(np.prod(s.shape)) for p, s in jax.tree_util.tree_leaves_with_path(shapes)
                 if "b_hh" in jax.tree_util.keystr(p))
    assert domain == "time" and n_b_hh == 4 * 4 * 768
    assert n_ours == n_jax - n_b_hh == 38_913_021
    assert gen.lstm.lstm1.w_hh_fwd.shape == (768, 4 * 768)
    assert gen.lstm.lstm1.w_ih_fwd.shape == (1536, 4 * 768)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = params_from_jax(zeros, h)
    assert set(sd) == set(gen.state_dict())
    assert all(sd[k].shape == v.shape for k, v in gen.state_dict().items())


def test_init_rescales_the_encoder_and_decoder_convs_only():
    """A conv drawn at U(+-b) has std b / sqrt(3); divided by (std / 0.1) ** 0.5
    its std is (0.1 std) ** 0.5 and its bias bound b / ((b / sqrt(3) / 0.1) ** 0.5)
    (hddemucas.py:29-48). The fusion convs and `weight` keep their defaults."""
    gen, _ = build_generator(_h(hidden=8))
    k = gen.encoder[1].first.kernel                   # Conv1d(8, 16, 8): 1024 draws at b = 1/8
    std0 = 1 / 8 / np.sqrt(3)
    assert abs(k.std(unbiased=False).item() - (0.1 * std0) ** 0.5) < 0.1 * (0.1 * std0) ** 0.5
    for stage in (*gen.encoder, *gen.decoder_mask, *gen.decoder_map):
        for conv in (stage.first, stage.second):
            fan_in = conv.kernel[0].numel() if isinstance(conv, hddemucas.Conv1d) \
                else conv.kernel.shape[1] * conv.kernel.shape[2]
            b = 1 / np.sqrt(fan_in)
            assert conv.bias.abs().max().item() <= b / (b / np.sqrt(3) / 0.1) ** 0.5 + 1e-6
    assert gen.fusion[0].kernel.abs().max() <= 1 / np.sqrt(6)  # torch's default bound
    assert gen.weight.item() == 0.5


@pytest.mark.parametrize("name", ["hddemucas_config.json"])
def test_config_is_a_copy_of_the_jax_packages(name):
    with open(os.path.join(REPO, "nvse_tpu_torch", "configs", name)) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "nvse_tpu", "configs", name)) as f:
        assert ours == json.load(f)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_engine_matches_jax_engine_with_bucket_padding():
    from nvse_tpu.infer.engine import InferenceEngine as JaxEngine

    h = _h(init_phase="zero")
    _, jp, _ = _pair(h)
    mel = _mel(T=9)
    ref = JaxEngine(h, params=jax.tree.map(jnp.asarray, jp), bucket_frames=16
                    ).synthesize_mel(jnp.asarray(mel), out_len=2000)
    eng = InferenceEngine(h, params=params_from_jax(jp, h), device="cpu", bucket_frames=16)
    got = eng.synthesize_mel(torch.from_numpy(mel), out_len=2000)
    assert got.shape == np.asarray(ref).shape == (B, 2000)
    np.testing.assert_allclose(got, np.asarray(ref), **MODEL_TOL)


def test_run_inference_on_the_synth_set(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)
    cfg = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "hddemucas_config.json"))
    cfg.update(hidden=4, depth=3, infer_batch=2, test_output_dir=str(tmp_path / "out"))
    assert not os.path.exists(cfg.checkpoint_file_load)
    lines = []
    stats = run_inference(cfg, limit=3, log_fn=lines.append, device="cpu")
    assert stats["files"] == 3 and stats["rtf"] > 0
    assert lines[-1].startswith("decoded 3 files | wall ")
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == ["SY0036.wav", "SY0037.wav", "SY0038.wav"]
    for name in written:
        y, sr = read_wav(str(tmp_path / "out" / name))
        src, _ = read_wav(os.path.join(REPO, "DatasetsScp", "synth", "wavs", name))
        n = len(src) - len(src) % 256
        assert sr == 22050 and n <= y.shape[0] <= len(src)
        assert np.isfinite(y).all() and np.abs(y).max() > 0


def test_time_domain_training_is_not_ported():
    """The time domain trains now: HD-Demucs's trainer builds MPD + MSD with
    the hinge losses and the MSD's spectral-norm vectors as buffers."""
    from nvse_tpu_torch.train import GANTrainer
    from nvse_tpu_torch.train.trainer import _check_supported

    h = _h(mpd_reshapes=[2], learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999,
           segment_size=2048)
    assert _check_supported(h, "time") is None
    tr = GANTrainer(h, device="cpu")
    assert tr.domain == "time" and set(tr.disc) == {"mpd", "msd"}
    assert tr.d_loss.__name__ == "hinge_discriminator_loss"
    assert sum(n.endswith(".u") for n, _ in tr.disc.named_buffers()) == 8
    assert hddemucas.HDDemucas.__module__ == "nvse_tpu_torch.models.hddemucas"
