"""Port parity: the time-domain GAN trainer (MPD + MSD) against the JAX
package, on the CPU.

Compared on seeded numpy weights in the JAX trees' shapes (jax.eval_shape, no
JAX init), mapped onto the port by params_from_jax / disc_params_from_jax; the
MSD's spectral-norm vectors u come from the JAX disc state's `spectral`
collection (the two packages draw the initial u apart):
  * one time-domain GAN step against make_train_step for a narrowed HiFiGAN
    (LS-GAN) and a tiny ConvTasNet (hinge, init_phase "zero", fused_tcn on:
    the JAX Pallas tail in interpret mode, the port's plain tail under
    _TailRecompute): every metric (Mel, GAN, FM, G, D) at rtol 1e-3, the AdamW
    first moments per tensor at a relative L2 of 2e-3, the updated u at 1e-5;
  * eval_full against the JAX one (Mel, masked to the real frames);
  * u advances in the D pass only; init_phase "rand" draws a new phase every
    step and the same one under the same seed; the Griffin-Lim front builds no
    autograd graph; the joint trainer refuses a time config before any CUDA call;
  * the CLI (python -m nvse_tpu_torch.train's main) for 2 steps of a narrowed
    HiFiGAN with validation, a resume that restores the saved u, and serving of
    the g_ bundle it wrote.
SNConv1d and the MSD alone: tests/test_torch_port_msd.py.
Narrowed: HiFiGAN at upsample_initial_channel 32 with rates (8, 8, 2, 2), at
the reference's init (g = ||v||), MPD with one period; the MSD at its only
width on 2,048-sample segments.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nvse_tpu.models import build_generator as jax_build
from nvse_tpu.models.discriminators import MultiScaleDiscriminator as JMSD
from nvse_tpu.train.trainer import DiscState, GenState
from nvse_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvse_tpu.train.trainer import make_train_step
from nvse_tpu.utils import AttrDict
from nvse_tpu_torch.infer import run_inference
from nvse_tpu_torch.train import GANTrainer
from nvse_tpu_torch.train.__main__ import main as train_cli
from nvse_tpu_torch.train.checkpoint import restore_checkpoint
from nvse_tpu_torch.train.trainer import _spectral_buffers
from nvse_tpu_torch.utils import disc_params_from_jax, load_config, params_from_jax

from test_torch_port_convtasnet import _seeded
from test_torch_port_disc import disc_params
from test_torch_port_joint import _one_torch_thread  # noqa: F401
from test_torch_port_train import LR, _adam_mu, _np, _port_moments, assert_moments_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the time domain's metrics (nvse_tpu/train/trainer.py:405-409)
TIME_METRIC_KEYS = ("Mel", "GAN", "FM", "G", "D")
SEG = 2048
BASE = dict(num_mels=80, n_fft=1024, hop_size=256, win_size=1024, sampling_rate=22050, fmin=0,
            fmax=8000, meloss=None, segment_size=SEG, batch_size=1, learning_rate=LR,
            adam_b1=0.8, adam_b2=0.99, lr_decay=0.999, mpd_reshapes=[2], seed=1234)
HIFIGAN = dict(model_name="HiFiGAN", resblock="1", upsample_rates=[8, 8, 2, 2],
               upsample_kernel_sizes=[16, 16, 4, 4], upsample_initial_channel=32,
               resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]])
CONVTASNET = dict(model_name="ConvTasNet", N=16, L=16, B=8, H=16, P=3, X=2, R=1, num_spks=1,
                  skip_con=True, init_phase="zero", causal=False, norm="gln", fused_tcn=True)


def _h(model, **kw):
    return AttrDict({**BASE, **(HIFIGAN if model == "HiFiGAN" else CONVTASNET), **kw})


def _audio(n=SEG, seed=0, b=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)[None] + 0.05 * rng.standard_normal((b, n))
            ).astype(np.float32)


def msd_params(seg=SEG, seed=5):
    """Seeded numpy MSD params and `spectral` collection in the JAX trees'
    shapes: kernels and v ~ U(+-1/sqrt(fan_in)), g = ||v|| x U(0.8, 1.2) per
    output channel, u ~ N(0, 1)."""
    wave = jnp.zeros((2, seg), jnp.float32)
    shapes = jax.eval_shape(JMSD().init, jax.random.PRNGKey(0), wave, wave)
    rng = np.random.default_rng(seed)

    def fill(node):
        if "u" in node:
            return {"u": rng.standard_normal(node["u"].shape).astype(np.float32)}
        if "kernel" in node or "v" in node:
            key = "kernel" if "kernel" in node else "v"
            k, ci, co = node[key].shape
            b = 1.0 / np.sqrt(k * ci)
            out = {key: rng.uniform(-b, b, (k, ci, co)).astype(np.float32),
                   "bias": rng.uniform(-b, b, (co,)).astype(np.float32)}
            if key == "v":
                norm = np.sqrt((out["v"].astype(np.float64) ** 2).sum(axis=(0, 1)))
                out["g"] = (norm * rng.uniform(0.8, 1.2, co)).reshape(1, 1, co).astype(np.float32)
            return out
        return {k: fill(v) for k, v in node.items()}

    return fill(shapes["params"]), fill(shapes["spectral"])


def _u(module):
    return [u.clone() for u in _spectral_buffers(module)]


# ---------------------------------------------------------------------------
# one time-domain GAN step against the JAX step
# ---------------------------------------------------------------------------

def mrf_params(jm, seed=4):
    """Seeded numpy HiFiGAN / iSTFTNet params in the JAX tree's shapes, drawn as
    the reference (and both packages) initialise them: v and bias
    U(+-1/sqrt(fan_in)) (a transposed conv's fan_in is out * k), g = ||v|| over
    every axis but the weight-norm axis (the input channel of a transposed
    conv)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 80, 8)))["params"]

    def fill(node):
        if "v" not in node:
            return {k: fill(v) for k, v in node.items()}
        k, a, b = node["v"].shape
        transposed = node["g"].shape[1] != 1            # g (1, in, 1): ConvTranspose1d
        bound = 1.0 / np.sqrt((b if transposed else a) * k)
        v = rng.uniform(-bound, bound, (k, a, b)).astype(np.float32)
        axes = (0, 2) if transposed else (0, 1)
        g = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
        return {"v": v, "g": g.astype(np.float32),
                "bias": rng.uniform(-bound, bound, (b,)).astype(np.float32)}

    return fill(shapes)


def _gen_params(model, h, jm):
    # HiFiGAN at its own init: with jax_params' draw (g ~ U(-1, 1)) its output was so
    # quiet that 547 of the 720 mel values sat at the log's 1e-5 floor, where the mel
    # loss's gradient (1 / mel) scales two float32 FFTs' last bits into the moments
    if model == "HiFiGAN":
        return mrf_params(jm)
    return _seeded(jm, jnp.zeros((1, 80, 8)), seed=3)


@pytest.fixture(scope="module", params=["HiFiGAN", "ConvTasNet"])
def one_step(request):
    model = request.param
    h = _h(model)
    jm, _ = jax_build(h)
    gp = _gen_params(model, h, jm)
    audio = _audio()
    sp, spec = msd_params()
    dp = {"mpd": disc_params(segment=SEG, periods=h.mpd_reshapes)["mpd"], "scale": sp}
    spe = 10
    gen_state = GenState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, gp),
                                tx=jax_make_optimizer(h, spe))
    disc_state = DiscState.create(apply_fn=None, params=jax.tree.map(jnp.asarray, dp),
                                  tx=jax_make_optimizer(h, spe),
                                  spectral=jax.tree.map(jnp.asarray, spec))
    fns = make_train_step(h, jm, "time")
    gen_state, disc_state, jm_metrics = fns.train_step(gen_state, disc_state,
                                                       jnp.asarray(audio), None)
    # eval_full on a 5-frame utterance zero-padded to an 8-frame bucket
    val = np.pad(_audio(n=5 * 256, seed=3), ((0, 0), (0, 3 * 256)))
    _, jm_eval = fns.eval_full(gen_state, jnp.asarray(val), 5 * 256)
    jax_eval = (val, {k: float(v) for k, v in jm_eval.items()})

    tr = GANTrainer(h, device="cpu", steps_per_epoch=spe)
    tr.generator.load_state_dict(params_from_jax(gp, h))
    mpd_sd, msd_sd = disc_params_from_jax(dp, spec)
    tr.disc["mpd"].load_state_dict(mpd_sd)
    tr.disc["msd"].load_state_dict(msd_sd)
    u0 = _u(tr.disc)
    g0 = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    seen = []
    tr.generator.register_forward_pre_hook(lambda m, args: seen.append(args[0].requires_grad))
    pmetrics = tr.step(torch.from_numpy(audio))
    d_mu = disc_params_from_jax(_np(_adam_mu(disc_state.opt_state)), _np(disc_state.spectral))
    return dict(
        model=model, h=h, trainer=tr, g0=g0, u0=u0, mel_requires_grad=seen, jax_eval=jax_eval,
        jax={k: float(jm_metrics[k]) for k in TIME_METRIC_KEYS},
        port={k: float(pmetrics[k]) for k in TIME_METRIC_KEYS}, port_keys=set(pmetrics),
        g_mu_jax=params_from_jax(_np(_adam_mu(gen_state.opt_state)), h),
        g_mu_port=_port_moments(tr.opt_g, tr.generator),
        d_mu_jax={**{f"mpd.{k}": v for k, v in d_mu[0].items()},
                  **{f"msd.{k}": v for k, v in d_mu[1].items() if not k.endswith(".u")}},
        d_mu_port=_port_moments(tr.opt_d, tr.disc),
        u_jax=disc_params_from_jax(_np(disc_state.params), _np(disc_state.spectral))[1])


def test_time_step_metrics_match_jax(one_step):
    assert one_step["port_keys"] == set(TIME_METRIC_KEYS)
    for k in TIME_METRIC_KEYS:
        assert np.isfinite(one_step["port"][k]), k
        np.testing.assert_allclose(one_step["port"][k], one_step["jax"][k], rtol=1e-3, err_msg=k)


def test_time_step_moments_match_jax(one_step):
    r = one_step
    assert_moments_close(r["g_mu_port"], r["g_mu_jax"], rel=2e-3)
    assert_moments_close(r["d_mu_port"], r["d_mu_jax"], rel=2e-3)
    # every trained leaf moved: HiFiGAN's v and g (weight norm is not folded in
    # training), the transposed convs' among them; the MSD's spectral-norm kernels
    want = (".v", ".g") if r["model"] == "HiFiGAN" else (".alpha", ".kernel")
    # (the last TCN block's residual 1x1 feeds nothing when skip connections sum)
    names = [k for k in r["g_mu_port"] if k.endswith(want) and not k.startswith("blocks.1.res")]
    assert names and (r["model"] != "HiFiGAN" or any(k.startswith("ups.") for k in names))
    for k in names:
        assert torch.isfinite(r["g_mu_port"][k]).all() and r["g_mu_port"][k].abs().sum() > 0, k
    new = r["trainer"].generator.state_dict()
    assert all(not torch.equal(new[k], r["g0"][k]) for k in names)
    sn = [k for k in r["d_mu_port"] if k.startswith("msd.discs.0.") and k.endswith(".kernel")]
    assert len(sn) == 8
    assert all(r["d_mu_port"][k].abs().sum() > 0 for k in sn)


def test_time_step_updates_u_as_jax(one_step):
    tr = one_step["trainer"]
    got = {k: v for k, v in tr.disc["msd"].state_dict().items() if k.endswith(".u")}
    assert len(got) == 8
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), one_step["u_jax"][k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert not any(torch.equal(a, b) for a, b in zip(one_step["u0"], _u(tr.disc)))


def test_time_step_losses_and_discriminators(one_step):
    """LS-GAN for HiFiGAN, hinge for the others; MPD + MSD, scale weight 1."""
    tr = one_step["trainer"]
    assert set(tr.disc) == {"mpd", "msd"} and tr.scale_weight == 1.0
    # the hinge models run the real and generated waves in two calls (their post convs'
    # exact-zero bias gradients, held to JAX's by the moments test)
    ls = one_step["model"] == "HiFiGAN"
    assert tr.disc["mpd"].batched == tr.disc["msd"].batched == ls
    assert tr.d_loss.__name__ == ("ls_discriminator_loss" if one_step["model"] == "HiFiGAN"
                                  else "hinge_discriminator_loss")
    assert one_step["mel_requires_grad"] == [False]


def test_eval_full_matches_jax(one_step):
    val, ref = one_step["jax_eval"]
    y, got = one_step["trainer"].eval_full(torch.from_numpy(val), 5 * 256)
    # 9 mel frames: HiFiGAN's 9 x 256 samples, ConvTasNet's hop x (9 - 1)
    n = 9 * 256 if one_step["model"] == "HiFiGAN" else 8 * 256
    assert set(got) == set(ref) == {"Mel"} and y.shape == (1, n)
    np.testing.assert_allclose(float(got["Mel"]), ref["Mel"], rtol=1e-4)


def test_u_advances_in_the_d_pass_and_not_in_the_g_pass():
    h = _h("HiFiGAN", upsample_initial_channel=16)
    tr = GANTrainer(h, device="cpu")
    fwd = tr.generator_forward(torch.from_numpy(_audio()))
    u0 = _u(tr.disc)
    tr.discriminator_update(fwd)
    u1 = _u(tr.disc)
    assert not any(torch.equal(a, b) for a, b in zip(u0, u1))
    metrics, ok = tr.generator_update(fwd)
    assert ok == 1.0 and all(torch.equal(a, b) for a, b in zip(u1, _u(tr.disc)))
    assert set(metrics) == {"Mel", "GAN", "FM", "G"}


def test_rand_phase_is_new_every_step_and_the_same_under_a_seed():
    h = _h("ConvTasNet", init_phase="rand", fused_tcn=False)
    audio = torch.from_numpy(_audio(b=2, n=1024))
    thetas = []
    for steps in (2, 1):
        tr = GANTrainer(h, device="cpu")
        seen = []
        tr.generator.register_forward_pre_hook(
            lambda m, args, kw: seen.append(kw["theta"].clone()), with_kwargs=True)
        for _ in range(steps):
            tr.step(audio)
        thetas.append(seen)
    (a1, a2), (b1,) = thetas
    assert a1.shape == (2, 513, 5) and a1.abs().max() <= np.pi
    assert not torch.equal(a1, a2)                          # a fresh draw each step
    assert torch.equal(a1, b1)                              # the same under one seed
    assert torch.equal(a2, tr.step_phase(torch.zeros(2, 80, 5)))   # keyed by the step


def test_griffin_lim_front_builds_no_graph_in_a_step():
    h = _h("ConvTasNet", init_phase="griffin_lim", fused_tcn=False)
    tr = GANTrainer(h, device="cpu")
    seen = []
    tr.generator.encoder.register_forward_pre_hook(
        lambda m, args: seen.append((args[0].requires_grad, args[0].grad_fn)))
    tr.step(torch.from_numpy(_audio(b=2, n=1024)))
    assert seen == [(False, None)]


def test_joint_cli_with_a_time_config_raises_before_any_cuda_call():
    with pytest.raises(ValueError, match="takes mels"):
        GANTrainer(_h("HiFiGAN"), device="cuda", joint=True)


def test_train_cli_two_steps_resume_and_serve(tmp_path, monkeypatch, capsys):
    cfg = load_config(os.path.join(REPO, "nvse_tpu_torch", "configs", "hifigan_v1_config.json"))
    cfg.update(upsample_initial_channel=16, resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]], mpd_reshapes=[2], segment_size=SEG,
               training_steps=1, stdout_interval=1, checkpoint_interval=1000,
               validation_interval=1000, num_workers=1, validation_cap=1, batch_size=2,
               checkpoint_path=str(tmp_path / "ckpt"), test_output_dir=str(tmp_path / "out"))
    cfg.pop("config_path")
    for k in ("input_training_wav_list", "input_validation_wav_list", "raw_wavfile_path",
              "test_input_wavs_dir"):
        cfg[k] = os.path.join(REPO, cfg[k])
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(sys, "argv", ["nvse_tpu_torch.train", "--cfg_filename", str(path),
                                      "--device", "cpu"])
    train_cli()
    log = capsys.readouterr().out.splitlines()
    assert any("(time-domain)" in line for line in log)
    assert any(line.startswith("step 0 validation: Mel=") for line in log)
    assert any("training finished" in line for line in log)
    ckpt = tmp_path / "ckpt"
    do = torch.load(ckpt / "do_00000001", weights_only=True)
    assert set(do) == {"mpd", "msd", "optim_g", "optim_d", "steps", "epoch"}
    saved_u = {k: v for k, v in do["msd"].items() if k.endswith(".u")}
    assert len(saved_u) == 8

    h = load_config(str(path))
    fresh = GANTrainer(h, device="cpu")
    drawn = _u(fresh.disc)
    assert restore_checkpoint(str(ckpt), fresh) == (2, 0)
    got = {k: v for k, v in fresh.disc["msd"].state_dict().items() if k.endswith(".u")}
    assert all(torch.equal(got[k], saved_u[k]) for k in saved_u)
    assert not any(torch.equal(a, b) for a, b in zip(drawn, _u(fresh.disc)))

    h.update(checkpoint_file_load=str(ckpt / "g_00000001"))
    lines = []
    stats = run_inference(h, limit=1, log_fn=lines.append, device="cpu")
    assert stats["files"] == 1 and len(os.listdir(tmp_path / "out")) == 1
    assert lines[-1].startswith("decoded 1 files")
