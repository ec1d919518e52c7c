"""Port parity: GCRN (GLU-conv UNet with a grouped-LSTM bottleneck) against
the JAX package, on the CPU.

Both packages get the same weights (numpy values from a seed in the JAX
tree's shapes, mapped by params_from_jax / glu_params / glstm_params) and
the same numpy input. GCRN has no narrow configuration (8.28 M
parameters), so the whole-model cases share one JAX trace: a
module-scoped fixture runs `jax.value_and_grad` once at B = 2, 9 frames
and keeps the outputs and the gradients.
Tolerances: the pieces (GLU convs, GLSTM) at 1e-5, the same arithmetic
summed in another order; the whole model at those of
tests/test_torch_port_bsrnn.py (rtol 2e-3 / atol 2e-4, phase as the
wrapped difference at atol 5e-3 where the magnitude is not negligible:
atan2 of a near-zero pair is ill-conditioned in both packages); gradients
per tensor at 2e-3 of the tensor's largest reference value.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.models import gcrn as jax_gcrn
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.data import read_wav
from nvse_tpu_torch.infer import InferenceEngine, run_inference
from nvse_tpu_torch.models import build_generator, gcrn
from nvse_tpu_torch.models.layers import LSTM
from nvse_tpu_torch.train import GANTrainer, fetch_scalars
from nvse_tpu_torch.train.trainer import make_optimizer
from nvse_tpu_torch.utils import load_config, params_from_jax
from nvse_tpu_torch.utils.jax_params import glstm_params, glu_params

from test_torch_port_bsrnn import jax_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
B, FRAMES = 2, 9


def _h(**kw):
    d = dict(model_name="GCRN", sampling_rate=22050, n_fft=1024, hop_size=256, win_size=1024,
             num_mels=80, fmin=0, fmax=8000, seed=1234)
    d.update(kw)
    return AttrDict(d)


def _seeded(module, x, seed):
    """Seeded numpy values in the shapes of a flax module's parameter tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
    return jax.tree.map(lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


def _nchw(x):          # JAX (B, T, F, C) -> port (B, C, T, F)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

GLU_CASES = [("conv", 3, 5, (1, 3)), ("conv", 1, 4, (1, 5)), ("transposed", 6, 2, (1, 3)),
             ("transposed", 4, 3, (1, 5))]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("kind,cin,cout,kernel", GLU_CASES)
def test_glu_convs_match_jax(kind, cin, cout, kernel, fused):
    transposed = kind == "transposed"
    jcls = jax_gcrn.GluConvTranspose2d if transposed else jax_gcrn.GluConv2d
    pcls = gcrn.GluConvTranspose2d if transposed else gcrn.GluConv2d
    x = np.random.default_rng(1).standard_normal((2, 4, 15, cin)).astype(np.float32)
    jmod = jcls(cin, cout, kernel, (1, 2), fused=fused)
    jp = _seeded(jmod, jnp.asarray(x), seed=2)
    ref = jmod.apply({"params": jp}, jnp.asarray(x))                 # (B, T, F', cout)

    mod = pcls(cin, cout, kernel, (1, 2), fused, gen=torch.Generator().manual_seed(0))
    mod.load_state_dict(glu_params(jax.tree.map(np.asarray, jp), transposed))
    with torch.no_grad():
        got = mod(_nchw(x))
    f_out = (15 - 1) * 2 + kernel[1] if transposed else (15 - kernel[1]) // 2 + 1
    assert got.shape == (2, cout, 4, f_out)
    np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), **TOL)


@pytest.mark.parametrize("kind,cin,cout,kernel", GLU_CASES)
def test_glu_fused_equals_unfused_on_the_same_parameters(kind, cin, cout, kernel):
    pcls = gcrn.GluConvTranspose2d if kind == "transposed" else gcrn.GluConv2d
    a = pcls(cin, cout, kernel, (1, 2), True, gen=torch.Generator().manual_seed(3))
    b = pcls(cin, cout, kernel, (1, 2), False, gen=torch.Generator().manual_seed(4))
    b.load_state_dict(a.state_dict())          # the same tree whichever path runs
    x = torch.randn(2, cin, 5, 15, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(a(x), b(x), rtol=2e-5, atol=2e-5)


def test_conv_init_bounds_follow_torch_fan_in():
    gen = torch.Generator().manual_seed(0)
    conv = gcrn.PlainConv2d(8, 16, (1, 3), gen=gen)
    convt = gcrn.ConvTranspose2d(8, 16, (1, 3), gen=gen)
    assert conv.kernel.shape == (16, 8, 1, 3) and convt.kernel.shape == (8, 16, 1, 3)
    for m, fan_in in ((conv, 8 * 3), (convt, 16 * 3)):
        bound = 1 / np.sqrt(fan_in)
        for p in (m.kernel, m.bias):
            assert p.abs().max() <= bound and p.abs().max() > 0.8 * bound


def test_freq_layernorm_matches_jax_in_the_input_dtype():
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 4)).astype(np.float32)   # (B, T, F, C)

    class Wrap(jax_gcrn.nn.Module):
        @jax_gcrn.nn.compact
        def __call__(self, x):
            return jax_gcrn._ln_freq(x, 7, "bn1")

    jp = _seeded(Wrap(), jnp.asarray(x), seed=1)
    ref = Wrap().apply({"params": jp}, jnp.asarray(x))
    ln = gcrn.FreqLayerNorm(7)
    ln.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in jp["bn1"].items()})
    with torch.no_grad():
        got = ln(_nchw(x))
        np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), **TOL)
        assert ln.to(torch.bfloat16)(_nchw(x).bfloat16()).dtype == torch.bfloat16


@pytest.mark.parametrize("groups,hidden", [(2, 32), (3, 48)])   # 3: the odd last group scans alone
def test_glstm_matches_jax(groups, hidden):
    Bq, T, Fq = 3, 6, 4
    C = hidden // Fq
    x = np.random.default_rng(2).standard_normal((Bq, T, Fq, C)).astype(np.float32)
    jmod = jax_gcrn.GLSTM(hidden_size=hidden, groups=groups)
    jp = _seeded(jmod, jnp.asarray(x), seed=3)
    ref = jmod.apply({"params": jp}, jnp.asarray(x))

    mod = gcrn.GLSTM(hidden, groups, gen=torch.Generator().manual_seed(0))
    sd = glstm_params(jax.tree.map(np.asarray, jp))
    assert set(sd) == set(mod.state_dict()) and len(mod.lstms) == 2 * groups
    mod.load_state_dict(sd)
    with torch.no_grad():
        got = mod(_nchw(x))
    assert got.shape == (Bq, C, T, Fq)
    np.testing.assert_allclose(got.numpy(), _nchw(ref).numpy(), **TOL)


def test_glstm_pairs_go_through_lstm_scan_bidir2(monkeypatch):
    calls = []
    for name in ("lstm_scan_bidir2", "lstm_scan"):
        orig = getattr(gcrn, name)
        monkeypatch.setattr(gcrn, name,
                            lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    x = torch.randn(2, 8, 5, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        gcrn.GLSTM(32, 2, gen=torch.Generator().manual_seed(0))(x)
        assert calls == ["lstm_scan_bidir2"] * 2
        del calls[:]
        gcrn.GLSTM(48, 3, gen=torch.Generator().manual_seed(0))(
            torch.randn(2, 12, 5, 4, generator=torch.Generator().manual_seed(1)))
    assert calls == ["lstm_scan_bidir2", "lstm_scan"] * 2


# ---------------------------------------------------------------------------
# the whole model: one JAX trace for outputs and gradients
# ---------------------------------------------------------------------------

def _loss(outs, lib):
    logamp, pha, rea, imag, wav = outs
    return (lib.mean(wav ** 2) + 0.1 * lib.mean(logamp) + lib.mean(lib.cos(pha))
            + 0.1 * lib.mean(rea ** 2 + imag ** 2))


@pytest.fixture(scope="module")
def both():
    h = _h()
    mel = np.random.default_rng(0).standard_normal((B, 80, FRAMES)).astype(np.float32) - 4.0
    jgen, domain = jax_build(h)
    assert domain == "tf"
    jparams = jax_params(jgen, mel)

    def loss(p):
        outs = jgen.apply({"params": p}, jnp.asarray(mel))
        return _loss(outs, jnp), outs

    (_, theirs), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(jparams)

    gen, pdomain = build_generator(h)
    assert pdomain == "tf"
    gen.load_state_dict(params_from_jax(jparams, h))
    ours = gen(torch.from_numpy(mel))
    _loss(ours, torch).backward()
    return dict(h=h, mel=mel, jparams=jparams, theirs=[np.asarray(t) for t in theirs],
                jgrads=jax.tree.map(np.asarray, jgrads), gen=gen,
                ours=[t.detach().numpy() for t in ours])


def test_gcrn_matches_jax(both):
    ours, theirs = both["ours"], both["theirs"]
    assert ours[-1].shape == (B, 256 * (FRAMES - 1))
    for name, a, b in zip(("logamp", "phase", "rea", "imag", "wav"), ours, theirs):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        if name == "phase":
            mag = np.hypot(theirs[2], theirs[3])
            d = np.angle(np.exp(1j * (a.astype(np.float64) - b.astype(np.float64))))
            live = mag > 1e-3 * mag.max()
            assert live.mean() > 0.5 and np.abs(d[live]).max() < 5e-3, np.abs(d[live]).max()
        else:
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=name)


def test_gcrn_state_dict_covers_every_parameter(both):
    sd = params_from_jax(both["jparams"], both["h"])
    want = both["gen"].state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    n_jax = sum(a.size for a in jax.tree.leaves(both["jparams"]))
    n_port = sum(v.numel() for v in sd.values())
    assert abs(n_jax - 8.28e6) / 8.28e6 < 0.02, n_jax
    assert n_port == n_jax - 4 * 4 * 448        # four LSTMs hold b_ih + b_hh as one bias


def test_gcrn_gradient_matches_jax_grad(both):
    """One scalar loss of all five outputs: every parameter of the port gets
    a finite gradient that matches jax.grad's, bridged through the same map
    as the weights (a summed LSTM bias sees b_ih's gradient once, the map
    sums two of them)."""
    ref = params_from_jax(both["jgrads"], both["h"])
    named = dict(both["gen"].named_parameters())
    assert set(ref) == set(named)
    for k, p in named.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), k
        want = ref[k] * 0.5 if k.endswith(".b_fwd") else ref[k]
        scale = want.abs().max().item()
        assert scale > 0, k
        err = (p.grad - want).abs().max().item() / scale
        assert err <= 2e-3, (k, err)


def test_gcrn_optimizer_puts_the_glstm_biases_in_the_copies_2_group(both):
    gen = both["gen"]
    opt = make_optimizer(gen, _h(learning_rate=2e-4, adam_b1=0.8, adam_b2=0.99, lr_decay=0.999), 10)
    summed = [g for g in opt.param_groups if g["copies"] == 2]
    assert len(summed) == 1
    biases = [m.b_fwd for m in gen.glstm.lstms]
    assert len(biases) == 4 and all(isinstance(m, LSTM) for m in gen.glstm.lstms)
    assert {id(p) for p in summed[0]["params"]} == {id(b) for b in biases}
    n_all = sum(len(g["params"]) for g in opt.param_groups)
    assert n_all == len(list(gen.parameters()))


def test_gcrn_inv_mel_amp_argument_replaces_the_pseudo_inverse(both):
    gen, mel = both["gen"], torch.from_numpy(both["mel"])
    from nvse_tpu_torch.ops.spectral import inverse_mel

    with torch.no_grad():
        amp = torch.clamp(torch.abs(inverse_mel(mel, *gen.mel_args)), min=1e-5)
        same = gen(mel, inv_mel_amp=amp)
        other = gen(mel, inv_mel_amp=amp * 2.0)
    np.testing.assert_allclose(same[-1].numpy(), both["ours"][-1], rtol=1e-5, atol=1e-6)
    assert not np.allclose(other[-1].numpy(), both["ours"][-1], atol=1e-4)


def test_gcrn_unfused_glu_config_gives_the_same_outputs(both):
    gen2, _ = build_generator(_h(fused_glu=False))
    assert not gen2.enc_convs[0].fused and both["gen"].enc_convs[0].fused
    gen2.load_state_dict(both["gen"].state_dict())
    with torch.no_grad():
        outs = gen2(torch.from_numpy(both["mel"]))
    for name, a, b in zip(("logamp", "phase", "rea", "imag", "wav"), outs, both["ours"]):
        if name != "phase":
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-5, err_msg=name)


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------

def _gcrn_config(**kw):
    h = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "gcrn_config.json"))
    h.update(kw)
    return h


def test_gcrn_config_is_the_jax_packages_and_gets_the_loaders_defaults():
    from nvse_tpu.utils import load_config as jax_load_config

    ours = _gcrn_config()
    theirs = jax_load_config(os.path.join(REPO, "nvse_tpu", "configs", "gcrn_config.json"))
    assert ours.model_name == "GCRN" and "mrd_weight" not in open(
        os.path.join(REPO, "nvse_tpu_torch", "configs", "gcrn_config.json")).read()
    assert ours.mrd_weight == theirs.mrd_weight == 0.1
    for k in ("segment_size", "batch_size", "num_mels", "n_fft", "hop_size", "sampling_rate",
              "fmax", "mpd_reshapes", "learning_rate"):
        assert ours[k] == theirs[k], k


def test_gcrn_engine_matches_jax_engine_with_bucket_padding(both):
    # T = 9 pads to the 16-frame bucket with log(1e-5) and crops back
    from nvse_tpu.infer.engine import InferenceEngine as JaxEngine

    h, mel = both["h"], both["mel"]
    ref = JaxEngine(h, params=jax.tree.map(jnp.asarray, both["jparams"]), bucket_frames=16
                    ).synthesize_mel(jnp.asarray(mel), out_len=2000)
    eng = InferenceEngine(h, params=params_from_jax(both["jparams"], h), device="cpu",
                          bucket_frames=16)
    got = eng.synthesize_mel(torch.from_numpy(mel), out_len=2000)
    assert got.shape == np.asarray(ref).shape == (B, 2000)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="stream_state"):
        eng.synthesize_streaming_stateful(torch.from_numpy(mel))
    # context-recompute streaming is the engine's generic path: one window shape
    wav = eng.synthesize_streaming(torch.from_numpy(mel), chunk_frames=4, context_frames=2)
    assert wav.shape == (B, FRAMES * 256) and np.isfinite(wav).all()


def test_gcrn_run_inference_on_the_synth_set(tmp_path, monkeypatch):
    """The GCRN config through run_inference on the CPU: the batched path
    (weights from the seed: the config's checkpoint is not in the repo),
    then one file through the per-file path with a bfloat16 trunk."""
    monkeypatch.chdir(REPO)
    h = _gcrn_config(test_output_dir=str(tmp_path / "out"), infer_batch=2)
    assert not os.path.exists(h.checkpoint_file_load)
    lines = []
    stats = run_inference(h, limit=3, log_fn=lines.append, device="cpu")
    assert stats["files"] == 3 and stats["rtf"] > 0
    assert lines and lines[-1].startswith("decoded 3 files | wall ")
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == ["SY0036.wav", "SY0037.wav", "SY0038.wav"]
    for name in written:
        y, sr = read_wav(str(tmp_path / "out" / name))
        src, _ = read_wav(os.path.join(REPO, "DatasetsScp", "synth", "wavs", name))
        assert sr == 22050 and y.shape == src.shape and np.isfinite(y).all() and np.abs(y).max() > 0

    h2 = _gcrn_config(test_output_dir=str(tmp_path / "out2"), compute_dtype="bfloat16")
    stats = run_inference(h2, limit=1, batch=1, log_fn=lines.append, device="cpu")
    assert stats["files"] == 1 and os.listdir(tmp_path / "out2") == ["SY0036.wav"]


def test_gcrn_engine_loads_g_bundles_and_bare_state_dicts(tmp_path, both):
    sd = both["gen"].state_dict()
    mel = torch.from_numpy(both["mel"])
    want = InferenceEngine(both["h"], params=sd, device="cpu").forward(mel)
    for name, obj in (("g_00000001", {"generator": sd}), ("gen.pt", sd)):
        torch.save(obj, str(tmp_path / name))
        eng = InferenceEngine(_h(checkpoint_file_load=str(tmp_path / name)), device="cpu")
        torch.testing.assert_close(eng.forward(mel), want, rtol=0, atol=0)


def test_gcrn_gan_trainer_step_on_cpu():
    """One GANTrainer step with GCRN at batch 2 on a short segment: finite
    losses, the generator moved, and every GLSTM parameter got a gradient
    through the residual-saving route. The MPD has one period: the GLSTM's
    gradient is the point."""
    h = _gcrn_config(segment_size=2048, batch_size=2, mpd_reshapes=[2])
    t = np.arange(2048) / 22050.0
    audio = (0.3 * np.sin(2 * np.pi * 220 * t)[None, :]
             + 0.05 * np.random.default_rng(0).standard_normal((2, 2048))).astype(np.float32)
    tr = GANTrainer(h, device="cpu", steps_per_epoch=2)
    before = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    losses = fetch_scalars(tr.step(torch.from_numpy(audio)))
    assert {"G", "D", "Mel", "GAN", "FM"} <= set(losses)
    assert all(np.isfinite(v) for v in losses.values()), losses
    moved = [k for k, v in tr.generator.state_dict().items() if not torch.equal(v, before[k])]
    assert len(moved) == len(before)
    for n, p in tr.generator.glstm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, n
